"""Hand-written Hopper kernels and their plain PyTorch versions.

- :mod:`.flash_attention` — fused online-softmax attention (CUDA C++,
  ``csrc/flash_attention.cu``), replacing the Pallas TPU kernel
  ``repro.kernels.flash_attention.flash_attention_pallas``.
- :mod:`.wkv6` — the RWKV-6 WKV recurrence with a state in and out (CUDA C++,
  ``csrc/wkv6.cu``), replacing ``repro.kernels.rwkv6_scan.wkv6_pallas`` and
  computing the function of its jnp twin ``repro.models.rwkv6.wkv_chunked``.
- :mod:`.mamba_scan` — the Mamba-1 selective scan with a state in and out
  (CUDA C++, ``csrc/mamba_scan.cu``), replacing
  ``repro.kernels.mamba_scan.mamba_scan_pallas`` and computing the function of
  its jnp twin ``repro.models.mamba.ssm_chunked_scan``.
- :mod:`.ref` — naive oracles (counterpart of ``repro.kernels.ref``).
- :mod:`._build` — builds ``csrc/*.cu`` with ``nvcc`` at first use.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain version.
"""

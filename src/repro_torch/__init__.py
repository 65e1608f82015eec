"""PyTorch + CUDA port of the :mod:`repro` model stack, for NVIDIA Hopper.

The JAX package :mod:`repro` stays the reference: every module here names its
counterpart there, keeps its parameter layout and leaf paths, and is tested
against it on the CPU (``tests/test_torch_*.py``).  This package imports
``torch`` and numpy only; it holds its own copies of what it needs.

The slices ported so far serve gemma2-2b, rwkv6-7b, jamba-v0.1-52b,
codeqwen1.5-7b, stablelm-3b, nemotron-4-15b and olmoe-1b-7b:
:class:`repro_torch.models.Model` (``prefill`` / ``decode_step``) →
:class:`repro_torch.serve.ServeEngine` → ``python -m repro_torch.launch.serve``;
and train all of them but jamba: ``Model.train_loss`` → ``train.build_train_step``
→ ``train.Trainer`` → ``python -m repro_torch.launch.train``.
Prefill attention runs the hand-written CUDA kernel in
``kernels/csrc/flash_attention.cu`` (its backward
``kernels/csrc/flash_attention_bwd.cu``), rwkv6's WKV-6 recurrence the one in
``kernels/csrc/wkv6.cu`` (its backward ``kernels/csrc/wkv6_bwd.cu``), and
jamba's selective scan the one in ``kernels/csrc/mamba_scan.cu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

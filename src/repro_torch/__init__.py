"""PyTorch + CUDA port of the :mod:`repro` model stack, for NVIDIA Hopper.

The JAX package :mod:`repro` stays the reference: every module here names its
counterpart there, keeps its parameter layout and leaf paths, and is tested
against it on the CPU (``tests/test_torch_*.py``).  This package imports
``torch`` and numpy only; it holds its own copies of what it needs.

The slice ported so far serves gemma2-2b: :class:`repro_torch.models.Model`
(``prefill`` / ``decode_step``) → :class:`repro_torch.serve.ServeEngine` →
``python -m repro_torch.launch.serve``.  Prefill attention runs the
hand-written CUDA kernel in ``kernels/csrc/flash_attention.cu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

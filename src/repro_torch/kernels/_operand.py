"""What the hand-written kernels need of an operand tensor."""

from __future__ import annotations

import torch

__all__ = ["kernel_operand"]


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on a 16-byte boundary, as the kernels' 16-byte
    vector loads and ``cp.async`` copies need: a view that is neither is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()

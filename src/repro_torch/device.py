"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the default
is ``"cuda"``, and with no card present that default raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``"cuda"`` (default) or ``"cpu"`` → a ``torch.device``; raises if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

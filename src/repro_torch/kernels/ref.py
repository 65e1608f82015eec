"""Dense oracle for the attention kernel — counterpart of ``src/repro/kernels/ref.py``.

Deliberately naive: it builds the full [S, T] score matrix in f32 so that it
is obviously right.  Tests hold the plain blocked version and the CUDA kernel
against it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref"]

_BIG_NEG = -1e30


def attention_ref(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, T, Kv, hd]
    v: torch.Tensor,  # [B, T, Kv, hd]
    *,
    causal: bool = True,
    window: int = 0,
    logit_softcap: float = 0.0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-softmax attention with an explicit [S, T] score matrix."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(B, S, Kv, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qh, k.float()) * scale
    if logit_softcap and logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    q_pos = q_offset + torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    s = torch.where(ok, s, torch.full_like(s, _BIG_NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)

"""Naive oracles for the kernels — counterpart of ``src/repro/kernels/ref.py``.

Deliberately simple so that they are obviously right: attention builds the
full [S, T] score matrix in f32, and the WKV recurrence and the selective
scan step one token at a time.  Tests hold the plain versions and the CUDA kernels against them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "wkv6_ref", "mamba_scan_ref"]

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


def wkv6_ref(
    r: torch.Tensor,  # [B, S, H, C]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # [B, S, H, C] decay in (0, 1)
    u: torch.Tensor,  # [H, C] current-token bonus
    *,
    s0: Optional[torch.Tensor] = None,  # [B, H, C, C]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential RWKV-6 recurrence, one token at a time.

        out_t = r_t · (S_{t-1} + (u ∘ k_t) ⊗ v_t)
        S_t   = diag(w_t) S_{t-1} + k_t ⊗ v_t

    Returns (out [B,S,H,C] in r's dtype, final state [B,H,C,C] in f32).
    """
    B, S, H, C = r.shape
    rf, kf, vf, wf, uf = (x.float() for x in (r, k, v, w, u))
    state = torch.zeros((B, H, C, C), dtype=torch.float32, device=r.device) if s0 is None else s0.float()
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # [B,H,C,C]
        s_eff = state + uf[None, :, :, None] * kv
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s_eff))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype), state


def mamba_scan_ref(
    u: torch.Tensor,      # [B, S, di]
    delta: torch.Tensor,  # [B, S, di]  (already softplus'd)
    A: torch.Tensor,      # [di, ds]    (negative)
    Bmat: torch.Tensor,   # [B, S, ds]
    Cmat: torch.Tensor,   # [B, S, ds]
    *,
    h0: Optional[torch.Tensor] = None,  # [B, di, ds]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential selective scan, one token at a time:

        h_t = exp(Δ_t A) ∘ h_{t-1} + (Δ_t u_t) B_t ;  y_t = C_t · h_t

    Returns (y [B,S,di] in u's dtype, h_final [B,di,ds] in f32).
    """
    B, S, di = u.shape
    ds = A.shape[1]
    uf, df, Af, Bf, Cf = (x.float() for x in (u, delta, A, Bmat, Cmat))
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=u.device) if h0 is None else h0.float()
    ys = []
    for t in range(S):
        decay = torch.exp(df[:, t, :, None] * Af[None])                 # [B,di,ds]
        drive = (df[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]    # [B,di,ds]
        h = decay * h + drive
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(u.dtype), h

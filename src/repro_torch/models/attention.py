"""Attention layers — counterpart of ``src/repro/models/attention.py:38-300``.

GQA projections with RoPE, train/prefill attention through the fused kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`, which runs the
CUDA kernel on a CUDA tensor and the plain blocked version on a CPU tensor),
and single-token decode against a KV cache.  Decode attention is plain torch,
as it is plain ``jnp`` in the reference: it has no kernel.

Unlike the reference's functional updates, :func:`decode_attention_layer`
writes the new key/value row into the cache in place, so a decode step holds
one copy of the cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from ..kernels.flash_attention import flash_attention
from .layers import Init, Params, apply_rope, dense, init_dense, init_norm, norm, rope_freqs

__all__ = [
    "init_attention",
    "attention_layer",
    "decode_attention_layer",
    "init_kv_cache",
]

_BIG_NEG = -1e30


def init_attention(init: Init, cfg) -> Params:
    hd = cfg.resolved_head_dim
    p: Params = {
        "wq": init_dense(init, cfg.d_model, (cfg.n_heads, hd), bias=cfg.qkv_bias),
        "wk": init_dense(init, cfg.d_model, (cfg.n_kv_heads, hd), bias=cfg.qkv_bias),
        "wv": init_dense(init, cfg.d_model, (cfg.n_kv_heads, hd), bias=cfg.qkv_bias),
        "wo": {"w": init.normal((cfg.n_heads, hd, cfg.d_model), 1.0 / math.sqrt(cfg.n_heads * hd))},
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm(init, "rmsnorm", hd)
        p["k_norm"] = init_norm(init, "rmsnorm", hd)
    return p


def _project_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg, *, dtype, rope: bool):
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x, dtype=dtype)  # [B, S, H, hd]
    k = dense(p["wk"], x, dtype=dtype)
    v = dense(p["wv"], x, dtype=dtype)
    if cfg.qk_norm:
        q = norm(p["q_norm"], q, kind="rmsnorm")
        k = norm(p["k_norm"], k, kind="rmsnorm")
    if rope and cfg.use_rope:
        freqs = rope_freqs(hd, cfg.rope_fraction, cfg.rope_theta, device=x.device)
        q = apply_rope(q, positions, freqs)
        k = apply_rope(k, positions, freqs)
    return q, k, v


def _out_proj(p: Params, out: torch.Tensor, dtype) -> torch.Tensor:
    """[B, S, H, hd] × wo [H, hd, D] → [B, S, D]."""
    return torch.tensordot(out.to(dtype), p["wo"]["w"].to(dtype), dims=([2, 3], [0, 1]))


def attention_layer(
    p: Params,
    x: torch.Tensor,          # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    cfg,
    *,
    kind: str,                # 'attn' | 'attn_local'
    dtype,
    causal: bool = True,
    return_kv: bool = False,
):
    """Train/prefill self-attention.  Returns (out, (k, v) or None)."""
    q, k, v = _project_qkv(p, x, positions, cfg, dtype=dtype, rope=True)
    window = cfg.attn_window if kind == "attn_local" else 0
    out = flash_attention(q, k, v, causal=causal, window=window, logit_softcap=cfg.attn_softcap)
    return _out_proj(p, out, dtype), ((k, v) if return_kv else None)


def init_kv_cache(cfg, batch: int, max_len: int, *, n_layers_of_kind: int, dtype, device) -> Dict:
    shape = (n_layers_of_kind, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention_layer(
    p: Params,
    x: torch.Tensor,        # [B, 1, D]
    cache_k: torch.Tensor,  # [B, T, Kv, hd], updated in place
    cache_v: torch.Tensor,
    pos: Union[int, torch.Tensor],  # cache slot to write, scalar or [B]
    cfg,
    *,
    kind: str,
    dtype,
    rolling: bool = False,  # T == attn_window ring buffer (local layers)
    abs_pos: Optional[Union[int, torch.Tensor]] = None,  # absolute position (RoPE / mask)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode; returns (out [B,1,D], cache_k, cache_v).

    ``pos``/``abs_pos`` may be scalars or per-row [B] vectors (continuous
    batching).  With ``rolling`` the cache is a ring of T == window slots and
    every written slot lies inside the window, so only slot occupancy
    (``t <= abs_pos``) is masked; a linear cache of a local layer masks the
    window explicitly.
    """
    B = x.shape[0]
    T = cache_k.shape[1]
    dev = x.device
    if abs_pos is None:
        abs_pos = pos
    pos_b = torch.as_tensor(pos, dtype=torch.long, device=dev).expand(B)
    abs_b = torch.as_tensor(abs_pos, dtype=torch.long, device=dev).expand(B)
    q, k_new, v_new = _project_qkv(p, x, abs_b[:, None], cfg, dtype=dtype, rope=True)

    # the reference's dynamic_update_slice clamps the slot into range
    rows = torch.arange(B, device=dev)
    slot = pos_b.clamp(0, T - 1)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)

    Kv = cfg.n_kv_heads
    G = cfg.n_heads // Kv
    hd = cfg.resolved_head_dim
    qh = q.reshape(B, Kv, G, hd)
    # products of compute-dtype values accumulated in f32, as the reference's
    # preferred_element_type=f32
    s = torch.einsum("bkgd,btkd->bkgt", qh.float(), cache_k.to(dtype).float()) / math.sqrt(hd)
    if cfg.attn_softcap:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    t_idx = torch.arange(T, device=dev)
    ok = t_idx[None, None, None, :] <= abs_b[:, None, None, None]
    if not rolling and kind == "attn_local" and cfg.attn_window:
        ok &= t_idx[None, None, None, :] > (abs_b[:, None, None, None] - cfg.attn_window)
    s = torch.where(ok, s, torch.full_like(s, _BIG_NEG))
    m = s.amax(dim=-1, keepdim=True)
    pexp = torch.exp(s - m)
    l = pexp.sum(dim=-1, keepdim=True)
    # f32 probabilities × compute-dtype cache promote to f32, then cast back
    out = torch.einsum("bkgt,btkd->bkgd", pexp / torch.clamp_min(l, 1e-30), cache_v.to(dtype).float())
    out = out.reshape(B, 1, cfg.n_heads, hd)
    return _out_proj(p, out, dtype), cache_k, cache_v

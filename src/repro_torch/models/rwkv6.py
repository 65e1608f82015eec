"""RWKV-6 "Finch" block — counterpart of ``src/repro/models/rwkv6.py:43-242``.

Time-mix with a data-dependent decay and channel-mix.  Per head (head_dim C,
state S ∈ ℝ^{C×C}) the WKV recurrence is

    out_t = r_t · (S_{t-1} + (u ∘ k_t) ⊗ v_t)
    S_t   = diag(w_t) S_{t-1} + k_t ⊗ v_t

with w_t = exp(−exp(w₀ + LoRA(x_t))), computed in f32.  It runs through
:func:`repro_torch.kernels.wkv6.wkv6`: the CUDA kernel on a CUDA tensor, the
plain chunked version on a CPU tensor.  The reference's simplification is
kept: token-shift lerps use learned per-channel μ, and the decay keeps its
LoRA.  ``mu``, ``decay_base``, ``bonus`` and the group-norm leaves stay in
their f32 master dtype and are cast at use, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.wkv6 import wkv6
from .layers import Init, Params, dense, init_dense

__all__ = [
    "init_rwkv_tmix",
    "rwkv_tmix",
    "init_rwkv_cmix",
    "rwkv_cmix",
    "init_rwkv_cache",
    "decay_base",
]

_LORA_RANK = 64


def _heads(cfg) -> Tuple[int, int]:
    C = cfg.rwkv.head_dim
    if cfg.d_model % C:
        raise ValueError(f"{cfg.name}: d_model {cfg.d_model} is not a multiple of the rwkv head_dim {C}")
    return cfg.d_model // C, C


def decay_base(d_model: int) -> torch.Tensor:
    """The decay's per-channel base w₀ = −6 + 5·linspace(0, 1, D)^0.7 (f32, CPU)."""
    return -6.0 + 5.0 * torch.linspace(0, 1, d_model, dtype=torch.float32) ** 0.7


def init_rwkv_tmix(init: Init, cfg) -> Params:
    D = cfg.d_model
    H, C = _heads(cfg)
    rank = min(_LORA_RANK, D)
    return {
        "mu": init.fill((5, D), 0.5),  # r, k, v, g, w
        "w_r": init_dense(init, D, (D,)),
        "w_k": init_dense(init, D, (D,)),
        "w_v": init_dense(init, D, (D,)),
        "w_g": init_dense(init, D, (D,)),
        "w_o": init_dense(init, D, (D,)),
        "decay_base": init.constant(decay_base(D)),
        "decay_lora_a": init_dense(init, D, (rank,)),
        "decay_lora_b": init_dense(init, rank, (D,), scale=0.01),
        "bonus": init.normal((H, C), 0.1),
        "gn_scale": init.fill((D,), 1.0),
        "gn_bias": init.fill((D,), 0.0),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x[t] ← x[t-1]; position 0 primed by ``last`` (decode carry) or zeros."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _group_norm(x: torch.Tensor, scale, bias, H: int, C: int) -> torch.Tensor:
    """Per-head layernorm over C (RWKV's GroupNorm(H)), in f32, eps 1e-5."""
    B, S, D = x.shape
    xh = x.reshape(B, S, H, C).float()
    mean = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    xh = (xh - mean) * torch.rsqrt(var + 1e-5)
    out = xh.reshape(B, S, D) * scale.float() + bias.float()
    return out.to(x.dtype)


def rwkv_tmix(p: Params, x: torch.Tensor, cfg, *, dtype, state: Optional[Dict] = None):
    """x: [B, S, D].  Returns (out, new_state); new_state is None unless ``state`` is given.

    ``state`` is ``{'wkv': [B, H, C, C] f32, 'shift': [B, 1, D]}``.
    """
    H, C = _heads(cfg)
    B, S, _ = x.shape
    xs = _token_shift(x, None if state is None else state["shift"])
    mu = p["mu"].to(dtype)
    mr, mk, mv, mg, mw = (x + (xs - x) * mu[i] for i in range(5))

    r = dense(p["w_r"], mr, dtype=dtype).reshape(B, S, H, C)
    k = dense(p["w_k"], mk, dtype=dtype).reshape(B, S, H, C)
    v = dense(p["w_v"], mv, dtype=dtype).reshape(B, S, H, C)
    g = dense(p["w_g"], mg, dtype=dtype)
    # data-dependent decay (Finch): w = exp(-exp(base + LoRA(mw))), in f32
    lora = dense(p["decay_lora_b"], torch.tanh(dense(p["decay_lora_a"], mw, dtype=dtype)), dtype=dtype)
    decay_log = p["decay_base"].float() + lora.float()
    w = torch.exp(-torch.exp(decay_log)).reshape(B, S, H, C)

    s0 = None if state is None else state["wkv"]
    out, s_fin = wkv6(r, k, v, w, p["bonus"].float(), chunk=cfg.ssm_chunk, s0=s0)
    out = _group_norm(out.reshape(B, S, H * C).to(dtype), p["gn_scale"], p["gn_bias"], H, C)
    out = dense(p["w_o"], out * F.silu(g), dtype=dtype)
    new_state = None if state is None else {"wkv": s_fin, "shift": x[:, -1:, :]}
    return out, new_state


def init_rwkv_cmix(init: Init, cfg) -> Params:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "mu": init.fill((2, D), 0.5),  # k, r
        "w_k": init_dense(init, D, (F_,)),
        "w_v": init_dense(init, F_, (D,)),
        "w_r": init_dense(init, D, (D,)),
    }


def rwkv_cmix(p: Params, x: torch.Tensor, cfg, *, dtype, state: Optional[Dict] = None):
    """Squared-ReLU channel-mix; ``state`` is ``{'shift': [B, 1, D]}``.  Returns (out, new_state)."""
    xs = _token_shift(x, None if state is None else state["shift"])
    mu = p["mu"].to(dtype)
    mk = x + (xs - x) * mu[0]
    mr = x + (xs - x) * mu[1]
    k = torch.relu(dense(p["w_k"], mk, dtype=dtype)).square()
    kv = dense(p["w_v"], k, dtype=dtype)
    out = torch.sigmoid(dense(p["w_r"], mr, dtype=dtype)) * kv
    new_state = None if state is None else {"shift": x[:, -1:, :]}
    return out, new_state


def init_rwkv_cache(cfg, batch: int, *, n_layers_of_kind: int, dtype, device) -> Dict:
    """Zero time-mix state: the f32 WKV state and the token-shift carry.

    The channel-mix carry ``cshift`` belongs to the FFN and is added by
    ``transformer.init_decode_cache``.
    """
    H, C = _heads(cfg)
    n = n_layers_of_kind
    return {
        "wkv": torch.zeros((n, batch, H, C, C), dtype=torch.float32, device=device),
        "tshift": torch.zeros((n, batch, 1, cfg.d_model), dtype=dtype, device=device),
    }

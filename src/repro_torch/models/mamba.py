"""Mamba-1 selective SSM block (jamba's sequence mixer) — counterpart of ``src/repro/models/mamba.py:42-247``.

Per channel d and state n, with A diagonal (d_inner × d_state) and an
input-dependent step Δ,

    h_t = exp(Δ_t A) ∘ h_{t-1} + (Δ_t u_t) B_t ;  y_t = C_t · h_t

after a causal depthwise convolution of the input half of ``in_proj``, with a
D skip and a SiLU(z) gate after the scan.  Training runs :func:`mamba_layer`,
the reference's stateless forward, and prefill :func:`mamba_layer_with_state`,
which keeps the scan's final state; both scan through
:func:`repro_torch.kernels.mamba_scan.mamba_scan` (the CUDA kernel on a CUDA
tensor, the plain chunked version on a CPU tensor; with grad, its autograd
Function and the backward kernel).  Decode is one elementwise update of the
state, in plain torch as in the reference.  The scan's inputs and its state are f32 whatever the compute
dtype; the conv carry is kept in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import mamba_scan
from .layers import Init, Params, dense, init_dense

__all__ = [
    "init_mamba",
    "mamba_layer",
    "mamba_layer_with_state",
    "mamba_decode_step",
    "init_mamba_cache",
]


def _d_inner(cfg) -> int:
    return cfg.mamba.expand * cfg.d_model


def _dt_rank(cfg) -> int:
    return cfg.mamba.dt_rank or max(1, math.ceil(cfg.d_model / 16))


def init_mamba(init: Init, cfg) -> Params:
    """S4D-real A (``A_log = log n``), Δ's bias the inverse softplus of a
    log-uniform step in [1e-3, 1e-1], D ones, dense weights normal·1/√fan_in."""
    m = cfg.mamba
    di, dr, ds = _d_inner(cfg), _dt_rank(cfg), m.d_state
    a = torch.arange(1, ds + 1, dtype=torch.float32)[None, :].expand(di, ds)
    dt = torch.exp(init.uniform((di,), math.log(1e-3), math.log(1e-1)))
    dt_bias = torch.log(torch.expm1(dt))
    return {
        "in_proj": init_dense(init, cfg.d_model, (2 * di,)),
        "conv_w": init.normal((m.d_conv, di), 1.0 / math.sqrt(m.d_conv), leaf="conv_w"),
        "conv_b": init.fill((di,), 0.0, leaf="conv_b"),
        "x_proj": init_dense(init, di, (dr + 2 * ds,)),
        "dt_proj": init_dense(init, dr, (di,), bias=True),
        "A_log": init.constant(torch.log(a)),
        "D": init.fill((di,), 1.0, leaf="D"),
        "out_proj": init_dense(init, di, (cfg.d_model,)),
        "dt_bias": dt_bias.to(init.param_dtype),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                           init_state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,di], w: [K,di] → causal depthwise conv, primed by ``init_state`` [B,K-1,di] or zeros.

    Returns (y [B,S,di], tail [B,K-1,di]); the tail primes the next segment.
    """
    K, S = w.shape[0], x.shape[1]
    if init_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, di]
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y + b, xp[:, S:]


def _ssm_inputs(p: Params, x: torch.Tensor, cfg, *, dtype, conv_state=None):
    """The projections before the scan: (u, z, Δ, A, B, C, conv tail); u is post-conv, post-SiLU."""
    dr, ds = _dt_rank(cfg), cfg.mamba.d_state
    u, z = dense(p["in_proj"], x, dtype=dtype).chunk(2, dim=-1)
    u, tail = _causal_depthwise_conv(u, p["conv_w"].to(dtype), p["conv_b"].to(dtype), init_state=conv_state)
    u = F.silu(u)
    dt, Bmat, Cmat = dense(p["x_proj"], u, dtype=dtype).split([dr, ds, ds], dim=-1)
    delta = F.softplus(dense(p["dt_proj"], dt, dtype=dtype).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return u, z, delta, A, Bmat, Cmat, tail


def _gate_out(p: Params, y: torch.Tensor, u: torch.Tensor, z: torch.Tensor, *, dtype) -> torch.Tensor:
    """D skip in f32, SiLU(z) gate in the compute dtype, then ``out_proj``."""
    y = y + u.float() * p["D"].float()
    return dense(p["out_proj"], y.to(dtype) * F.silu(z), dtype=dtype)


def _scan(u, delta, A, Bmat, Cmat, cfg):
    """The selective scan on f32 operands; B and C are column slices of one projection, and
    the kernel takes them contiguous."""
    return mamba_scan(u.float(), delta, A, Bmat.float().contiguous(), Cmat.float().contiguous(), chunk=cfg.ssm_chunk)


def mamba_layer(p: Params, x: torch.Tensor, cfg, *, dtype) -> torch.Tensor:
    """Training forward from the zero state, x: [B,S,D] → [B,S,D]; ``src/repro/models/mamba.py:156-183``."""
    u, z, delta, A, Bmat, Cmat, _ = _ssm_inputs(p, x, cfg, dtype=dtype)
    y, _ = _scan(u, delta, A, Bmat, Cmat, cfg)
    return _gate_out(p, y, u, z, dtype=dtype)


def mamba_layer_with_state(p: Params, x: torch.Tensor, cfg, *, dtype):
    """Prefill forward from the zero state; returns (out [B,S,D], conv tail [B,K-1,di], h_final [B,di,ds] f32)."""
    u, z, delta, A, Bmat, Cmat, tail = _ssm_inputs(p, x, cfg, dtype=dtype)
    y, h_final = _scan(u, delta, A, Bmat, Cmat, cfg)
    return _gate_out(p, y, u, z, dtype=dtype), tail, h_final


def init_mamba_cache(cfg, batch: int, *, n_layers_of_kind: int, dtype, device) -> Dict:
    """Zero decode carry: the conv tail in the compute dtype, the SSM state in f32."""
    di, ds, K = _d_inner(cfg), cfg.mamba.d_state, cfg.mamba.d_conv
    n = n_layers_of_kind
    return {
        "conv": torch.zeros((n, batch, K - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((n, batch, di, ds), dtype=torch.float32, device=device),
    }


def mamba_decode_step(p: Params, x: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor,
                      cfg, *, dtype):
    """One token, x: [B,1,D]: the conv carry, one decay-and-drive update of the state, the C contraction.

    Returns (out [B,1,D], conv_state [B,K-1,di] in its own dtype, ssm_state [B,di,ds] f32).
    """
    u, z, delta, A, Bmat, Cmat, tail = _ssm_inputs(p, x, cfg, dtype=dtype, conv_state=conv_state)
    decay = torch.exp(delta[..., None] * A)[:, 0]                                  # [B,di,ds]
    drive = ((delta * u.float())[..., None] * Bmat.float()[:, :, None, :])[:, 0]   # [B,di,ds]
    h = decay * ssm_state + drive
    y = torch.einsum("bdn,bn->bd", h, Cmat.float()[:, 0])[:, None, :]
    return _gate_out(p, y, u, z, dtype=dtype), tail.to(conv_state.dtype), h

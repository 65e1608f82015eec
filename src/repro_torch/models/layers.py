"""Primitive layers — counterpart of ``src/repro/models/layers.py``.

Conventions copied from the reference:

- params are nested dicts of tensors; leaf names match the JAX pytree paths
  (``units/pos0/mixer/wq/w``), so :mod:`repro_torch.convert` can move a JAX
  parameter tree across unchanged;
- weights are stored in ``param_dtype`` (f32 master weights) and cast to the
  compute ``dtype`` at use; :func:`cast_for_compute` does that cast once, which
  gives the same bits;
- norms, RoPE angles and softcaps compute in f32 and return the input dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "Init",
    "init_dense",
    "dense",
    "init_norm",
    "norm",
    "init_embedding",
    "embed",
    "unembed",
    "rope_freqs",
    "apply_rope",
    "init_mlp",
    "mlp",
    "softcap",
    "cast_for_compute",
]

Params = Dict[str, Any]


class Init:
    """Draws parameter leaves from one ``torch.Generator`` onto one device.

    ``lead`` is prepended to every shape: unit parameters carry the leading
    ``n_units`` dimension that the reference gets from ``vmap``.  On the
    ``meta`` device nothing is drawn or allocated (shapes only).
    """

    def __init__(self, generator: Optional[torch.Generator], device, param_dtype: torch.dtype,
                 lead: Tuple[int, ...] = ()):
        self.generator = generator
        self.device = torch.device(device)
        self.param_dtype = param_dtype
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "Init":
        return Init(self.generator, self.device, self.param_dtype, self.lead + (n,))

    def normal(self, shape: Tuple[int, ...], std: float) -> torch.Tensor:
        """N(0, std²) drawn in f32 and cast, as the reference draws every leaf.

        The draw is scaled in place, so one f32 leaf is alive at a time: with
        bf16 parameters the peak is the weights plus the largest leaf in f32.
        """
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=self.param_dtype, device="meta")
        w = torch.randn(shape, generator=self.generator, device=self.device, dtype=torch.float32)
        return w.mul_(std).to(self.param_dtype)

    def uniform(self, shape: Tuple[int, ...], low: float, high: float) -> torch.Tensor:
        """U(low, high) drawn in f32, left in f32 for the caller to transform and cast."""
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device="meta")
        w = torch.rand(shape, generator=self.generator, device=self.device, dtype=torch.float32)
        return w.mul_(high - low).add_(low)

    def fill(self, shape: Tuple[int, ...], value: float) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=self.param_dtype, device=self.device)

    def constant(self, value: torch.Tensor) -> torch.Tensor:
        """``value``, the same in every stacked unit, in the parameter dtype."""
        shape = self.lead + tuple(value.shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=self.param_dtype, device="meta")
        return value.to(device=self.device, dtype=self.param_dtype).expand(shape).clone()


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


def init_dense(init: Init, in_dim: int, out_shape: Tuple[int, ...], *, bias: bool = False,
               scale: Optional[float] = None) -> Params:
    std = scale if scale is not None else 1.0 / in_dim ** 0.5
    p: Params = {"w": init.normal((in_dim, *out_shape), std)}
    if bias:
        p["b"] = init.fill(out_shape, 0.0)
    return p


def dense(p: Params, x: torch.Tensor, *, dtype: torch.dtype) -> torch.Tensor:
    """x: [..., in] @ w: [in, *out] -> [..., *out], in the compute dtype."""
    w = p["w"].to(dtype)
    out = torch.tensordot(x.to(dtype), w, dims=([-1], [0]))
    if "b" in p:
        out = out + p["b"].to(dtype)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(init: Init, kind: str, dim: int) -> Params:
    p: Params = {"scale": init.fill((dim,), 1.0)}
    if kind == "layernorm":
        p["bias"] = init.fill((dim,), 0.0)
    return p


def norm(p: Params, x: torch.Tensor, *, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm / LayerNorm computed in f32, returned in x.dtype."""
    x32 = x.float()
    if kind == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    elif kind == "layernorm":
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def init_embedding(init: Init, vocab: int, dim: int) -> Params:
    return {"table": init.normal((vocab, dim), 0.02)}


def embed(p: Params, tokens: torch.Tensor, *, dtype: torch.dtype) -> torch.Tensor:
    return p["table"].to(dtype)[tokens.long()]


def unembed(p: Params, x: torch.Tensor, *, dtype: torch.dtype) -> torch.Tensor:
    """Project activations back to vocab logits (tied head)."""
    return torch.matmul(x.to(dtype), p["table"].to(dtype).t())


# ---------------------------------------------------------------------------
# RoPE (full or partial-fraction rotary, interleaved pairs)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, fraction: float, theta: float, device=None) -> torch.Tensor:
    rot_dim = int(head_dim * fraction) // 2 * 2
    if rot_dim == 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exponent)  # [rot_dim // 2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] absolute positions.  Rotates pairs (0::2, 1::2)."""
    rot = freqs.shape[0] * 2
    if rot == 0:
        return x
    angles = positions[..., None].float() * freqs  # [B, S, rot/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass.to(out.dtype)], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs: swiglu (gated), gelu (non-gated, tanh approximation), squared relu
# ---------------------------------------------------------------------------


def init_mlp(init: Init, d_model: int, d_ff: int, *, activation: str) -> Params:
    p: Params = {}
    if activation == "swiglu":
        p["wi_gate"] = init_dense(init, d_model, (d_ff,))
    p["wi_up"] = init_dense(init, d_model, (d_ff,))
    p["wo"] = init_dense(init, d_ff, (d_model,))
    return p


def mlp(p: Params, x: torch.Tensor, *, activation: str, dtype: torch.dtype) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(dense(p["wi_gate"], x, dtype=dtype)) * dense(p["wi_up"], x, dtype=dtype)
    elif activation == "gelu":
        h = F.gelu(dense(p["wi_up"], x, dtype=dtype), approximate="tanh")
    elif activation == "relu2":
        h = torch.relu(dense(p["wi_up"], x, dtype=dtype)).square()
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return dense(p["wo"], h, dtype=dtype)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap) in f32; no-op when cap == 0."""
    if cap and cap > 0.0:
        return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
    return x


_COMPUTE_LEAVES = ("w", "b", "table")
_F32_SUBTREES = ("router",)  # the MoE router gates in f32 from its master weights


def cast_for_compute(params: Params, dtype: torch.dtype) -> Params:
    """Cast every weight that is cast at use (dense ``w``/``b``, embedding ``table``) once.

    Norm scales stay in their master dtype, as :func:`norm` reads them in f32,
    and so does the MoE router, which the reference reads in f32; a leaf
    already in the compute dtype is kept as it is, not copied.
    """
    return {
        name: leaf if name in _F32_SUBTREES
        else cast_for_compute(leaf, dtype) if isinstance(leaf, dict)
        else (leaf.to(dtype) if name in _COMPUTE_LEAVES else leaf)
        for name, leaf in params.items()
    }

"""WKV-6: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro.kernels.rwkv6_scan.wkv6_pallas`` (the Pallas TPU kernel,
``src/repro/kernels/rwkv6_scan.py:96``) behind the dispatcher
``repro.kernels.ops.wkv6`` (``src/repro/kernels/ops.py:43-50``).  The
reference takes the Pallas path only when no state is passed in; its prefill
and decode pass the cache's state, so on a TPU they run the jnp twin
``wkv_chunked`` (``src/repro/models/rwkv6.py:77-149``).  This module computes
``wkv_chunked``'s function (``s0`` in, final state out) everywhere, of which
the Pallas kernel's zero-state form is the special case ``s0=None``.  The
kernel is ``csrc/wkv6.cu``; its source comment gives the design and what
bounds it on the card.

- :func:`wkv6` dispatches on the tensor's device: a CUDA tensor launches the
  kernel (and raises if the build or the launch fails), a CPU tensor runs
  :func:`wkv6_plain`.  ``wkv6.launches`` counts kernel launches.
- :func:`wkv6_plain` is the port of ``wkv_chunked``: ragged tails are padded
  with w = 1 and k = 0, which leaves the carried state untouched, and the
  log-decay is ``log(max(w, 1e-38))`` as in the reference.

Shapes: r, k, v, w ``[B, S, H, C]``, u ``[H, C]``, s0 ``[B, H, C, C]``.  Both
results are f32: out ``[B, S, H, C]`` and the final state ``[B, H, C, C]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._operand import kernel_operand

__all__ = ["wkv6", "wkv6_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)  # the kernel's instantiations


def _check_shapes(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or r.shape[1] < 1:
        raise ValueError(f"r must be [B, S, H, C] with S >= 1; got {tuple(r.shape)}")
    B, S, H, C = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} must match r {tuple(r.shape)}; got {tuple(x.shape)}")
    if u.shape != (H, C):
        raise ValueError(f"u must be [H, C] = {(H, C)}; got {tuple(u.shape)}")
    if s0 is not None and s0.shape != (B, H, C, C):
        raise ValueError(f"s0 must be [B, H, C, C] = {(B, H, C, C)}; got {tuple(s0.shape)}")


def wkv6_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    chunk: int,
    s0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV recurrence in f32; returns (out [B,S,H,C], final state [B,H,C,C]).

    Within a chunk, relative decays exp(L_t − L_τ) have non-positive exponents,
    so the math is stable at any chunk size.
    """
    B, S, H, C = r.shape
    chunk = min(chunk, S)
    S_real = S
    if S % chunk:
        pad = -(-S // chunk) * chunk - S
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        S += pad
    n = S // chunk
    state = (torch.zeros((B, H, C, C), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    logw = torch.log(torch.clamp_min(w.float(), 1e-38))
    rc, kc, vc = (x.reshape(B, n, chunk, H, C).float() for x in (r, k, v))
    lw = logw.reshape(B, n, chunk, H, C)
    uf = u.float()
    tri_lt = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)

    outs = []
    for c in range(n):
        rr, kk, vv, ll = rc[:, c], kc[:, c], vc[:, c], lw[:, c]  # [B, chunk, H, C]
        L = torch.cumsum(ll, dim=1)  # inclusive  L_t
        Lexc = L - ll                 # exclusive  L_{t-1}
        # inter-chunk: r_t ∘ exp(Lexc_t) against the carried state
        out = torch.einsum("bthi,bhij->bthj", rr * torch.exp(Lexc), state)
        # intra-chunk: scores[t, τ] = Σ_i r_t,i exp(Lexc_t,i − L_τ,i) k_τ,i for τ < t
        rel = Lexc[:, :, None] - L[:, None]  # [B, t, τ, H, C]
        rel = torch.where(tri_lt[None, :, :, None, None], rel, torch.full_like(rel, -torch.inf))
        att = torch.einsum("bthi,btuhi,buhi->bthu", rr, torch.exp(rel), kk)
        diag = torch.einsum("bthi,hi,bthi->bth", rr, uf, kk)  # current-token bonus
        out = out + torch.einsum("bthu,buhj->bthj", att, vv) + diag[..., None] * vv
        # state: S ← exp(L_T) ∘ S + Σ_τ exp(L_T − L_τ) k_τ ⊗ v_τ
        decay_all = torch.exp(L[:, -1:] - L)
        state = torch.exp(L[:, -1])[..., None] * state + torch.einsum("buhi,buhj->bhij", decay_all * kk, vv)
        outs.append(out)
    return torch.cat(outs, dim=1)[:, :S_real], state


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/wkv6.cu``."""
    lib.wkv6_forward.argtypes = (
        [ctypes.c_void_p] * 8                        # r, k, v, w, u, s0, out, s_fin
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]     # B, S, H, C, dtype, stream
    )
    lib.wkv6_forward.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load_library

    return _bind(load_library("wkv6"))


def _launch(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, C = r.shape
    operands = (r, k, v, w, u) + (() if s0 is None else (s0,))
    if any(x.device != r.device for x in operands):
        raise ValueError(f"wkv6 operands must share one device; got {[str(x.device) for x in operands]}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 r, k, v of one dtype; got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(x.dtype != torch.float32 for x in operands[3:]):
        raise TypeError(f"kernel takes float32 w, u and s0; got {[x.dtype for x in operands[3:]]}")
    if C not in _HEAD_DIMS or B > 65535 or H > 65535:
        raise ValueError(f"kernel takes C in {_HEAD_DIMS} and B, H <= 65535; got B={B} H={H} C={C}")
    r, k, v, w, u = (kernel_operand(x) for x in (r, k, v, w, u))
    s0 = None if s0 is None else kernel_operand(s0)
    out = torch.empty((B, S, H, C), dtype=torch.float32, device=r.device)
    s_fin = torch.empty((B, H, C, C), dtype=torch.float32, device=r.device)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), out.data_ptr(), s_fin.data_ptr(),
            B, S, H, C, _DTYPE_CODE[r.dtype], stream,
        )
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: {lib.wkv6_error_string(err).decode()}")
    wkv6.launches += 1
    return out, s_fin


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    chunk: int,
    s0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV-6: the CUDA kernel for a CUDA tensor, the plain version for a CPU one.

    ``chunk`` is the plain version's chunk; the kernel steps token by token.
    The kernel has no backward yet: a CUDA input that requires grad raises
    (with grad enabled) instead of returning a result with no gradient.
    """
    _check_shapes(r, k, v, w, u, s0)
    if r.device.type == "cuda":
        if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (r, k, v, w, u, s0)):
            raise NotImplementedError(
                "wkv6: the CUDA kernel has no backward yet (ROADMAP.md queue 2, item 3); its output "
                "would carry no gradient.  Call it under torch.no_grad() or with inputs that need none")
        return _launch(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0)
    raise ValueError(f"wkv6 runs on cuda or cpu tensors, not {r.device}")


#: kernel launches since the count was last set to 0 (CPU calls do not count)
wkv6.launches = 0

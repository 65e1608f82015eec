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
  :func:`wkv6_plain`.  ``wkv6.launches`` counts forward launches and
  ``wkv6.launches_train`` those of the training form among them.
- With grad enabled and an input that needs it, :func:`wkv6` goes through
  :class:`_WKV6Fn`.  On the card its forward is the kernel's training form,
  which also writes the state before every ``CHECKPOINT`` tokens, and its
  backward is ``csrc/wkv6_bwd.cu`` (:func:`wkv6_bwd`, counted by
  ``wkv6_bwd.launches``), which recomputes the old states from those.  On the
  CPU the forward is :func:`wkv6_plain` and the backward
  :func:`wkv6_bwd_plain`.  No CUDA input runs the plain backward.
- :func:`wkv6_plain` is the port of ``wkv_chunked``: ragged tails are padded
  with w = 1 and k = 0, which leaves the carried state untouched, and the
  log-decay is ``log(max(w, 1e-38))`` as in the reference.
- :func:`wkv6_bwd_plain` is the backward's plain version: the recurrence's
  gradient swept token by token, the gradient of ``jax.grad`` of
  ``wkv_chunked``, where w enters through ``log(max(w, 1e-38))``: dw is 0
  where w <= 1e-38.

Shapes: r, k, v, w ``[B, S, H, C]``, u ``[H, C]``, s0 ``[B, H, C, C]``.  Both
results are f32: out ``[B, S, H, C]`` and the final state ``[B, H, C, C]``.
The backward's gradients: dr, dk, dv in r's dtype, dw, du and ds0 in f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._operand import kernel_operand

__all__ = ["wkv6", "wkv6_plain", "wkv6_bwd", "wkv6_bwd_plain", "CHECKPOINT"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)  # the kernels' instantiations
CHECKPOINT = 16               # tokens between the states the training form saves (CK, csrc/wkv6_common.cuh)
_W_MIN = 1e-38                # the reference's clamp of w before its log


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
    so nothing overflows at any chunk size.  Precision does depend on the chunk
    where decays come near the 1e-38 clamp: the cumulative log-decays L of a
    chunk then reach thousands in f32, and their differences lose digits.  With
    4 % of w each at 1e-36, 1e-30, 1e-38, 1e-40 and 0 (f32 B2 S320 H4 C64, output
    rms 10.4) the form missed the chunk-1 recurrence by 1.0e-3, 3.7e-3 and 1.5e-2
    at chunks 16, 64 and 256 on the CPU, and by 2.9e-2 at chunk 256 on an H100
    (f32 B2 S320 H64 C64).  The reference's ``wkv_chunked`` is the same form
    (``tests/test_torch_wkv6.py::test_chunked_form_loses_precision_near_the_clamp``).
    At chunk 1 it is the recurrence itself.
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


def wkv6_bwd_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    s0: Optional[torch.Tensor],
    dout: torch.Tensor,
    ds_fin: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, ...]:
    """The gradients (dr, dk, dv, dw, du, ds0) of (out, final state) against ``dout`` and ``ds_fin``.

    Per head, with S_{t-1} the state before token t and dS_t the gradient of the
    state after it, swept from dS_T = ds_fin (zero when None) down to ds0 = dS_0:

        dr_t = S_{t-1} dout_t + (u∘k_t)(v_t·dout_t)     dk_t = dS_t v_t + (r_t∘u)(v_t·dout_t)
        dv_t = dS_tᵀ k_t + (r_t·(u∘k_t)) dout_t          dw_t = rowsum(dS_t ∘ S_{t-1})
        du = Σ_t r_t∘k_t (v_t·dout_t)                     dS_{t-1} = w_t∘dS_t + r_t ⊗ dout_t

    dw is 0 where w <= 1e-38 (the reference's clamp).  One forward sweep keeps
    every old state, never rebuilt by dividing by w, which the model's decays
    bring close to 0.  All in f32.
    """
    B, S, H, C = r.shape
    rf, kf, vf, wf, df = (x.float() for x in (r, k, v, w, dout))
    uf = u.float()
    zero = torch.zeros((B, H, C, C), dtype=torch.float32, device=r.device)
    state = zero if s0 is None else s0.float()
    old = []
    for t in range(S):
        old.append(state)
        state = wf[:, t, :, :, None] * state + kf[:, t, :, :, None] * vf[:, t, :, None, :]

    vd = (vf * df).sum(-1, keepdim=True)                      # v_t · dout_t   [B, S, H, 1]
    dr = uf * kf * vd
    dk = rf * uf * vd
    dv = (rf * uf * kf).sum(-1, keepdim=True) * df
    dw = torch.empty_like(wf)
    ds = zero if ds_fin is None else ds_fin.float()
    for t in reversed(range(S)):
        dr[:, t] += torch.einsum("bhij,bhj->bhi", old[t], df[:, t])
        dk[:, t] += torch.einsum("bhij,bhj->bhi", ds, vf[:, t])
        dv[:, t] += torch.einsum("bhij,bhi->bhj", ds, kf[:, t])
        dw[:, t] = (ds * old[t]).sum(-1)
        ds = wf[:, t, :, :, None] * ds + rf[:, t, :, :, None] * df[:, t, :, None, :]
    du = (rf * kf * vd).sum(dim=(0, 1))
    dw = torch.where(wf > _W_MIN, dw, torch.zeros_like(dw))
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, ds


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/wkv6.cu``."""
    for fn, n_ptr in ((lib.wkv6_forward, 8), (lib.wkv6_forward_train, 9)):
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr                    # r, k, v, w, u, s0, out, s_fin (, s_chk)
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]     # B, S, H, C, dtype, stream
        )
        fn.restype = ctypes.c_int
    lib.wkv6_checkpoint.argtypes = []
    lib.wkv6_checkpoint.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    if lib.wkv6_checkpoint() != CHECKPOINT:
        raise RuntimeError(f"csrc/wkv6_common.cuh spaces the saved states {lib.wkv6_checkpoint()} tokens apart, "
                           f"the wrapper expects {CHECKPOINT}")
    return lib


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/wkv6_bwd.cu``."""
    lib.wkv6_backward.argtypes = (
        [ctypes.c_void_p] * 14                       # r, k, v, w, u, s_chk, dout, ds_fin, dr, dk, dv, dw, du, ds0
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]     # B, S, H, C, dtype, stream
    )
    lib.wkv6_backward.restype = ctypes.c_int
    lib.wkv6_bwd_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load_library

    return _bind(load_library("wkv6"))


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load_library

    return _bind_bwd(load_library("wkv6_bwd"))


def _check_operands(r, k, v, w, u, s0, extra=()) -> None:
    B, S, H, C = r.shape
    operands = (r, k, v, w, u) + (() if s0 is None else (s0,)) + tuple(extra)
    if any(x.device != r.device for x in operands):
        raise ValueError(f"wkv6 operands must share one device; got {[str(x.device) for x in operands]}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 r, k, v of one dtype; got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(x.dtype != torch.float32 for x in (w, u) + (() if s0 is None else (s0,))):
        raise TypeError(f"kernel takes float32 w, u and s0; got {[x.dtype for x in operands[3:]]}")
    if C not in _HEAD_DIMS or B > 65535 or H > 65535:
        raise ValueError(f"kernel takes C in {_HEAD_DIMS} and B, H <= 65535; got B={B} H={H} C={C}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch(r, k, v, w, u, s0, *, train: bool = False):
    """The forward kernel: (out, s_fin), and with ``train`` also the states it saves,
    f32 ``[B, H, ceil(S / CHECKPOINT), C, C]``, the first of them s0 (or zero)."""
    _check_operands(r, k, v, w, u, s0)
    B, S, H, C = r.shape
    r, k, v, w, u = (kernel_operand(x) for x in (r, k, v, w, u))
    s0 = None if s0 is None else kernel_operand(s0)
    out = torch.empty((B, S, H, C), dtype=torch.float32, device=r.device)
    s_fin = torch.empty((B, H, C, C), dtype=torch.float32, device=r.device)
    s_chk = (torch.empty((B, H, -(-S // CHECKPOINT), C, C), dtype=torch.float32, device=r.device)
             if train else None)
    lib = _lib()
    args = (_ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(s0), _ptr(out), _ptr(s_fin))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        if train:
            err = lib.wkv6_forward_train(*args, _ptr(s_chk), B, S, H, C, _DTYPE_CODE[r.dtype], stream)
        else:
            err = lib.wkv6_forward(*args, B, S, H, C, _DTYPE_CODE[r.dtype], stream)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: {lib.wkv6_error_string(err).decode()}")
    wkv6.launches += 1
    if train:
        wkv6.launches_train += 1
        return out, s_fin, s_chk
    return out, s_fin


def wkv6_bwd(r, k, v, w, u, s_chk, dout, ds_fin=None) -> Tuple[torch.Tensor, ...]:
    """The backward kernel on CUDA tensors: (dr, dk, dv, dw, du, ds0), as :func:`wkv6_bwd_plain`
    gives them, from the states ``s_chk`` that the forward's training form saved."""
    _check_shapes(r, k, v, w, u, None)
    _check_operands(r, k, v, w, u, None, extra=(s_chk, dout) + (() if ds_fin is None else (ds_fin,)))
    B, S, H, C = r.shape
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd launches the CUDA kernel; got a {r.device} tensor (the CPU runs wkv6_bwd_plain)")
    if s_chk.shape != (B, H, -(-S // CHECKPOINT), C, C) or s_chk.dtype != torch.float32:
        raise ValueError(f"s_chk must be f32 [B, H, ceil(S / {CHECKPOINT}), C, C]; got {s_chk.dtype} "
                         f"{tuple(s_chk.shape)}")
    if dout.shape != r.shape or (ds_fin is not None and ds_fin.shape != (B, H, C, C)):
        raise ValueError(f"dout must be {tuple(r.shape)} and ds_fin [B, H, C, C]; got {tuple(dout.shape)}, "
                         f"{None if ds_fin is None else tuple(ds_fin.shape)}")
    r, k, v, w, u, s_chk = (kernel_operand(x) for x in (r, k, v, w, u, s_chk))
    dout = kernel_operand(dout.float())
    ds_fin = None if ds_fin is None else kernel_operand(ds_fin.float())
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dw = torch.empty_like(w)
    du_part = torch.empty((B, H, C), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, C, C), dtype=torch.float32, device=r.device)
    lib = _bwd_lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_backward(
            _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(s_chk), _ptr(dout), _ptr(ds_fin),
            _ptr(dr), _ptr(dk), _ptr(dv), _ptr(dw), _ptr(du_part), _ptr(ds0),
            B, S, H, C, _DTYPE_CODE[r.dtype], stream,
        )
    if err:
        raise RuntimeError(f"wkv6 backward kernel launch failed: {lib.wkv6_bwd_error_string(err).decode()}")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du_part.sum(0), ds0


class _WKV6Fn(torch.autograd.Function):
    """WKV-6 with its gradient: the kernels on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        if r.device.type == "cuda":
            out, s_fin, s_chk = _launch(r, k, v, w, u, s0, train=True)
        else:
            (out, s_fin), s_chk = wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0), None
        ctx.has_s0 = s0 is not None
        ctx.save_for_backward(r, k, v, w, u, s0, s_chk)
        ctx.set_materialize_grads(False)  # an unused final state passes ds_fin None, not a zero tensor
        return out, s_fin

    @staticmethod
    def backward(ctx, dout, ds_fin):
        r, k, v, w, u, s0, s_chk = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        if r.device.type == "cuda":
            dr, dk, dv, dw, du, ds0 = wkv6_bwd(r, k, v, w, u, s_chk, dout, ds_fin)
        else:
            dr, dk, dv, dw, du, ds0 = wkv6_bwd_plain(r, k, v, w, u, s0, dout, ds_fin)
        return dr, dk, dv, dw, du.to(u.dtype), ds0 if ctx.has_s0 else None, None


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
    With grad enabled and an input that requires it, the call goes through
    :class:`_WKV6Fn`: on the card the forward's training form and the backward
    kernel, on the CPU the plain forward and :func:`wkv6_bwd_plain`.
    """
    _check_shapes(r, k, v, w, u, s0)
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"wkv6 runs on cuda or cpu tensors, not {r.device}")
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (r, k, v, w, u, s0)):
        return _WKV6Fn.apply(r, k, v, w, u, s0, chunk)
    if r.device.type == "cuda":
        return _launch(r, k, v, w, u, s0)
    return wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0)


#: forward launches since the count was last set to 0, and those of the training form among them
#: (CPU calls do not count)
wkv6.launches = 0
wkv6.launches_train = 0
#: backward kernel launches since the count was last set to 0
wkv6_bwd.launches = 0

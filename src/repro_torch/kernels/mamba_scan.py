"""Selective scan (Mamba-1): the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro.kernels.mamba_scan.mamba_scan_pallas`` (the Pallas TPU
kernel, ``src/repro/kernels/mamba_scan.py:76``).  The reference takes the
Pallas path only in the stateless training forward ``mamba_layer``; its
prefill runs ``mamba_layer_with_state``, which calls the jnp twin
``ssm_chunked_scan`` (``src/repro/models/mamba.py:82-146``) and keeps the
final state for decode.  This module computes ``ssm_chunked_scan``'s
function (``h0`` in, final state out) everywhere, of which the Pallas
kernel's zero-state output is the special case ``h0=None``.  The kernel is
``csrc/mamba_scan.cu``; its source comment gives the design and what bounds
it on the card.

- :func:`mamba_scan` dispatches on the tensor's device: a CUDA tensor
  launches the kernel (and raises if the build or the launch fails), a CPU
  tensor runs :func:`mamba_scan_plain`.  ``mamba_scan.launches`` counts
  kernel launches.
- With grad enabled and an input that needs it, :func:`mamba_scan` goes
  through :class:`_MambaScanFn`.  On the card its forward is the kernel's
  training form, which also writes the state before every ``CHECKPOINT``
  tokens (counted in ``mamba_scan.launches`` and ``launches_train``), and its
  backward is ``csrc/mamba_scan_bwd.cu`` (:func:`mamba_scan_bwd`, counted by
  ``mamba_scan_bwd.launches``), which recomputes the old states from those.
  On the CPU the forward is :func:`mamba_scan_plain` and the backward
  :func:`mamba_scan_bwd_plain`.  No CUDA input runs the plain backward.
- :func:`mamba_scan_plain` is the port of ``ssm_chunked_scan``: sequential
  over chunks, an associative scan of (decay, drive) pairs inside each, and a
  ragged tail padded with Δ = 0, which leaves the state untouched.
- :func:`mamba_scan_bwd_plain` is the backward's plain version: the
  recurrence's gradient swept token by token, the gradient that ``jax.vjp``
  of ``ssm_chunked_scan`` gives.

Shapes, all f32: u, Δ ``[B, S, di]``, A ``[di, ds]``, B, C ``[B, S, ds]``, h0
``[B, di, ds]``.  Results, f32: y ``[B, S, di]`` and the final state
``[B, di, ds]``.  The backward's gradients are f32 in the inputs' shapes (f64
from the plain backward given f64 inputs).  The
decode step of the model is elementwise, as in the reference, and never calls
the scan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._operand import kernel_operand

__all__ = ["mamba_scan", "mamba_scan_plain", "mamba_scan_bwd", "mamba_scan_bwd_plain", "CHECKPOINT"]

_STATE_DIMS = (4, 8, 16, 32)  # the forward kernel's instantiations
_TRAIN_STATE_DIMS = (4, 8, 16)  # the training form's and the backward kernel's
CHECKPOINT = 16               # tokens between the states the training form saves (CK, csrc/mamba_scan_common.cuh)


def _check_shapes(u, delta, A, Bmat, Cmat, h0) -> None:
    if u.dim() != 3 or u.shape[1] < 1:
        raise ValueError(f"u must be [B, S, di] with S >= 1; got {tuple(u.shape)}")
    B, S, di = u.shape
    if delta.shape != u.shape:
        raise ValueError(f"delta must match u {tuple(u.shape)}; got {tuple(delta.shape)}")
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A must be [di, ds] with di = {di}; got {tuple(A.shape)}")
    ds = A.shape[1]
    for name, x in (("Bmat", Bmat), ("Cmat", Cmat)):
        if x.shape != (B, S, ds):
            raise ValueError(f"{name} must be [B, S, ds] = {(B, S, ds)}; got {tuple(x.shape)}")
    if h0 is not None and h0.shape != (B, di, ds):
        raise ValueError(f"h0 must be [B, di, ds] = {(B, di, ds)}; got {tuple(h0.shape)}")


def _associative_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a, b) under
    (a₁, b₁) ∘ (a₂, b₂) = (a₁·a₂, a₂·b₁ + b₂), the composition of h ↦ a·h + b;
    Hillis–Steele doubling: log₂(length) steps, each a product of decays ≤ 1."""
    n, d = a.shape[1], 1
    while d < n:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return a, b


def mamba_scan_plain(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    Cmat: torch.Tensor,
    *,
    chunk: int,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selective scan in f32; returns (y [B,S,di], final state [B,di,ds]).

    Like the reference it materialises decay ``exp(Δ·A)`` and drive ``Δ·u·B``
    at ``[B, S, di, ds]``.
    """
    Bsz, S, di = u.shape
    ds = A.shape[1]
    chunk = min(chunk, S)
    S_real = S
    u, delta, Bmat, Cmat = (x.float() for x in (u, delta, Bmat, Cmat))
    if S % chunk:  # ragged tail: Δ = 0 gives decay 1 and drive 0, so the state is untouched
        pad = -(-S // chunk) * chunk - S
        u, delta, Bmat, Cmat = (F.pad(x, (0, 0, 0, pad)) for x in (u, delta, Bmat, Cmat))
        S += pad
    n = S // chunk
    decay = torch.exp(delta[..., None] * A.float()[None, None])      # [B,S,di,ds]
    drive = (delta * u)[..., None] * Bmat[:, :, None, :]             # [B,S,di,ds]
    h = torch.zeros((Bsz, di, ds), dtype=torch.float32, device=u.device) if h0 is None else h0.float()
    ys = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        a_run, b_run = _associative_scan(decay[:, sl], drive[:, sl])
        h_all = a_run * h[:, None] + b_run                           # [B,chunk,di,ds]
        ys.append(torch.einsum("btdn,btn->btd", h_all, Cmat[:, sl]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1)[:, :S_real].contiguous(), h.contiguous()


def mamba_scan_bwd_plain(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    Cmat: torch.Tensor,
    h0: Optional[torch.Tensor],
    dy: torch.Tensor,
    dh_fin: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, ...]:
    """The gradients (du, dΔ, dA, dB, dC, dh0) of (y, final state) against ``dy`` and ``dh_fin``.

    Per channel d and state n, with a_t = exp(Δ_t A) and g_t the whole gradient
    reaching the state h_t, swept from g_S = C_S dy_S + dh_fin (dh_fin zero when
    None) down to dh0 = a_1 ∘ g_1:

        g_{t-1} = C_{t-1} dy_{t-1} + a_t ∘ g_t
        du_t = Δ_t Σ_n B_t g_t                 dΔ_t = Σ_n g_t ∘ (A a_t ∘ h_{t-1} + u_t B_t)
        dA   = Σ_{b,t} g_t ∘ Δ_t a_t ∘ h_{t-1}   dB_t = Σ_d g_t Δ_t u_t        dC_t = Σ_d h_t dy_t

    The old states h_{t-1} are never had from h_t by dividing by a decay, which
    large Δ·|A| brings close to 0: one forward sweep keeps the state before every
    ``CHECKPOINT`` tokens, and each span's states are recomputed from its saved
    one on the way back, so at most ``CHECKPOINT`` + S / ``CHECKPOINT`` states of
    ``[B, di, ds]`` are held, never ``[B, S, di, ds]``.  It computes in the
    widest floating dtype of its inputs, and at least f32: f32 on the training
    path, f64 when given f64 inputs, as the exact result that the kernel's
    accuracy is measured against.
    """
    Bsz, S, di = u.shape
    dtype = functools.reduce(torch.promote_types, [x.dtype for x in (u, delta, A, Bmat, Cmat, h0, dy, dh_fin)
                                                   if x is not None], torch.float32)
    uf, df, Af, Bf, Cf, dyf = (x.to(dtype) for x in (u, delta, A, Bmat, Cmat, dy))
    zero = torch.zeros((Bsz, di, A.shape[1]), dtype=dtype, device=u.device)

    def step(h, t):
        return torch.exp(df[:, t, :, None] * Af) * h + (df[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]

    h = zero if h0 is None else h0.to(dtype)
    saved = []
    for t in range(S):
        if t % CHECKPOINT == 0:
            saved.append(h)
        h = step(h, t)

    du, ddelta = torch.empty_like(uf), torch.empty_like(df)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    g_carry = zero if dh_fin is None else dh_fin.to(dtype)  # a_{t+1} ∘ g_{t+1}, dh_fin past the end
    for c in reversed(range(len(saved))):
        t0 = c * CHECKPOINT
        old = [saved[c]]                                       # h_{t-1} for t = t0 .. t0 + len - 1
        for t in range(t0, min(t0 + CHECKPOINT, S) - 1):
            old.append(step(old[-1], t))
        for t in reversed(range(t0, min(t0 + CHECKPOINT, S))):
            h_prev = old[t - t0]
            decay = torch.exp(df[:, t, :, None] * Af)
            drive_b = (df[:, t] * uf[:, t])[..., None]        # Δ_t u_t, [B, di, 1]
            g = dyf[:, t, :, None] * Cf[:, t, None, :] + g_carry
            gb = (g * Bf[:, t, None, :]).sum(-1)
            dh_decay = g * decay * h_prev                      # dL/da_t ∘ a_t
            du[:, t] = df[:, t] * gb
            ddelta[:, t] = (dh_decay * Af).sum(-1) + uf[:, t] * gb
            dA += (dh_decay * df[:, t, :, None]).sum(0)
            dB[:, t] = (g * drive_b).sum(1)
            dC[:, t] = ((decay * h_prev + drive_b * Bf[:, t, None, :]) * dyf[:, t, :, None]).sum(1)
            g_carry = decay * g
    return du, ddelta, dA, dB, dC, g_carry


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/mamba_scan.cu``."""
    for fn, n_ptr in ((lib.mamba_scan_forward, 8), (lib.mamba_scan_forward_train, 9)):
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr                    # u, delta, A, B, C, h0, y, h_fin (, h_chk)
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]     # batch, S, di, ds, stream
        )
        fn.restype = ctypes.c_int
    lib.mamba_scan_checkpoint.argtypes = []
    lib.mamba_scan_checkpoint.restype = ctypes.c_int
    lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
    lib.mamba_scan_error_string.restype = ctypes.c_char_p
    if lib.mamba_scan_checkpoint() != CHECKPOINT:
        raise RuntimeError(f"csrc/mamba_scan_common.cuh spaces the saved states {lib.mamba_scan_checkpoint()} "
                           f"tokens apart, the wrapper expects {CHECKPOINT}")
    return lib


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/mamba_scan_bwd.cu``."""
    lib.mamba_scan_backward.argtypes = (
        [ctypes.c_void_p] * 14                       # u, delta, A, B, C, h_chk, dy, dh_fin,
                                                     # du, ddelta, dA_part, dB_part, dC_part, dh0
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]     # batch, S, di, ds, stream
    )
    lib.mamba_scan_backward.restype = ctypes.c_int
    lib.mamba_scan_bwd_block_channels.argtypes = []
    lib.mamba_scan_bwd_block_channels.restype = ctypes.c_int
    lib.mamba_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.mamba_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load_library

    return _bind(load_library("mamba_scan"))


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load_library

    return _bind_bwd(load_library("mamba_scan_bwd"))


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check_operands(operands, ds: int, dims=_STATE_DIMS, what: str = "kernel") -> None:
    operands = [x for x in operands if x is not None]
    if any(x.device != operands[0].device for x in operands):
        raise ValueError(f"mamba_scan operands must share one device; got {[str(x.device) for x in operands]}")
    if any(x.dtype != torch.float32 for x in operands):
        raise TypeError(f"{what} takes float32 operands; got {[x.dtype for x in operands]}")
    if ds not in dims or operands[0].shape[0] > 65535:
        raise ValueError(f"{what} takes ds in {dims} and B <= 65535; got B={operands[0].shape[0]} ds={ds}")


def _launch(u, delta, A, Bmat, Cmat, h0, *, train: bool = False):
    """The forward kernel: (y, h_fin), and with ``train`` also the states it saves,
    f32 ``[B, ceil(S / CHECKPOINT), di, ds]``, the first of them h0 (or zero)."""
    B, S, di = u.shape
    ds = A.shape[1]
    _check_operands((u, delta, A, Bmat, Cmat, h0), ds, _TRAIN_STATE_DIMS if train else _STATE_DIMS,
                    "the training form" if train else "kernel")
    if not all(x.is_contiguous() for x in (u, delta, A, Bmat, Cmat) + (() if h0 is None else (h0,))):
        raise ValueError("kernel takes contiguous u, delta, A, B, C and h0")
    u, delta, A, Bmat, Cmat = (kernel_operand(x) for x in (u, delta, A, Bmat, Cmat))
    h0 = None if h0 is None else kernel_operand(h0)
    y = torch.empty((B, S, di), dtype=torch.float32, device=u.device)
    h_fin = torch.empty((B, di, ds), dtype=torch.float32, device=u.device)
    h_chk = (torch.empty((B, -(-S // CHECKPOINT), di, ds), dtype=torch.float32, device=u.device)
             if train else None)
    lib = _lib()
    args = (_ptr(u), _ptr(delta), _ptr(A), _ptr(Bmat), _ptr(Cmat), _ptr(h0), _ptr(y), _ptr(h_fin))
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        if train:
            err = lib.mamba_scan_forward_train(*args, _ptr(h_chk), B, S, di, ds, stream)
        else:
            err = lib.mamba_scan_forward(*args, B, S, di, ds, stream)
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: {lib.mamba_scan_error_string(err).decode()}")
    mamba_scan.launches += 1
    if train:
        mamba_scan.launches_train += 1
        return y, h_fin, h_chk
    return y, h_fin


def mamba_scan_bwd(u, delta, A, Bmat, Cmat, h_chk, dy, dh_fin=None) -> Tuple[torch.Tensor, ...]:
    """The backward kernel on CUDA tensors: (du, dΔ, dA, dB, dC, dh0), as :func:`mamba_scan_bwd_plain`
    gives them, from the states ``h_chk`` that the forward's training form saved.  The kernel writes dA
    per batch row and dB, dC per block of channels (as many as the library's
    ``mamba_scan_bwd_block_channels()``); one ``torch.sum`` each adds the partials, in a fixed order."""
    _check_shapes(u, delta, A, Bmat, Cmat, None)
    B, S, di = u.shape
    ds = A.shape[1]
    if u.device.type != "cuda":
        raise ValueError(f"mamba_scan_bwd launches the CUDA kernel; got a {u.device} tensor "
                         f"(the CPU runs mamba_scan_bwd_plain)")
    if h_chk.shape != (B, -(-S // CHECKPOINT), di, ds):
        raise ValueError(f"h_chk must be [B, ceil(S / {CHECKPOINT}), di, ds]; got {tuple(h_chk.shape)}")
    if dy.shape != u.shape or (dh_fin is not None and dh_fin.shape != (B, di, ds)):
        raise ValueError(f"dy must be {tuple(u.shape)} and dh_fin [B, di, ds]; got {tuple(dy.shape)}, "
                         f"{None if dh_fin is None else tuple(dh_fin.shape)}")
    dy = dy.float()
    dh_fin = None if dh_fin is None else dh_fin.float()
    _check_operands((u, delta, A, Bmat, Cmat, h_chk, dy, dh_fin), ds, _TRAIN_STATE_DIMS, "the backward kernel")
    u, delta, A, Bmat, Cmat, h_chk, dy = (kernel_operand(x) for x in (u, delta, A, Bmat, Cmat, h_chk, dy))
    dh_fin = None if dh_fin is None else kernel_operand(dh_fin)
    lib = _bwd_lib()
    n_blk = -(-di // lib.mamba_scan_bwd_block_channels())
    du, ddelta = torch.empty_like(u), torch.empty_like(delta)
    dA_part = torch.empty((B, di, ds), dtype=torch.float32, device=u.device)
    dB_part, dC_part = (torch.empty((B, n_blk, S, ds), dtype=torch.float32, device=u.device) for _ in range(2))
    dh0 = torch.empty((B, di, ds), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.mamba_scan_backward(
            _ptr(u), _ptr(delta), _ptr(A), _ptr(Bmat), _ptr(Cmat), _ptr(h_chk), _ptr(dy), _ptr(dh_fin),
            _ptr(du), _ptr(ddelta), _ptr(dA_part), _ptr(dB_part), _ptr(dC_part), _ptr(dh0),
            B, S, di, ds, stream,
        )
    if err:
        raise RuntimeError(f"mamba_scan backward kernel launch failed: {lib.mamba_scan_bwd_error_string(err).decode()}")
    mamba_scan_bwd.launches += 1
    return du, ddelta, dA_part.sum(0), dB_part.sum(1), dC_part.sum(1), dh0


class _MambaScanFn(torch.autograd.Function):
    """The selective scan with its gradient: the kernels on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, u, delta, A, Bmat, Cmat, h0, chunk):
        if u.device.type == "cuda":
            y, h_fin, h_chk = _launch(u, delta, A, Bmat, Cmat, h0, train=True)
        else:
            (y, h_fin), h_chk = mamba_scan_plain(u, delta, A, Bmat, Cmat, chunk=chunk, h0=h0), None
        ctx.has_h0 = h0 is not None
        ctx.save_for_backward(u, delta, A, Bmat, Cmat, h0, h_chk)
        ctx.set_materialize_grads(False)  # an unused final state passes dh_fin None, not a zero tensor
        return y, h_fin

    @staticmethod
    def backward(ctx, dy, dh_fin):
        u, delta, A, Bmat, Cmat, h0, h_chk = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        if u.device.type == "cuda":
            grads = mamba_scan_bwd(u, delta, A, Bmat, Cmat, h_chk, dy, dh_fin)
        else:
            grads = mamba_scan_bwd_plain(u, delta, A, Bmat, Cmat, h0, dy, dh_fin)
        du, ddelta, dA, dB, dC = (g.to(x.dtype) for g, x in zip(grads, (u, delta, A, Bmat, Cmat)))
        return du, ddelta, dA, dB, dC, grads[5].to(h0.dtype) if ctx.has_h0 else None, None


def mamba_scan(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    Cmat: torch.Tensor,
    *,
    chunk: int,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan: the CUDA kernel for a CUDA tensor, the plain version for a CPU one.

    ``chunk`` is the plain version's chunk; the kernel steps token by token.
    With grad enabled and an input that requires it, the call goes through
    :class:`_MambaScanFn`: on the card the forward's training form and the
    backward kernel, on the CPU the plain forward and :func:`mamba_scan_bwd_plain`.
    """
    _check_shapes(u, delta, A, Bmat, Cmat, h0)
    if u.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mamba_scan runs on cuda or cpu tensors, not {u.device}")
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (u, delta, A, Bmat, Cmat, h0)):
        return _MambaScanFn.apply(u, delta, A, Bmat, Cmat, h0, chunk)
    if u.device.type == "cuda":
        return _launch(u, delta, A, Bmat, Cmat, h0)
    return mamba_scan_plain(u, delta, A, Bmat, Cmat, chunk=chunk, h0=h0)


#: forward launches since the count was last set to 0, and those of the training form among them
#: (CPU calls do not count)
mamba_scan.launches = 0
mamba_scan.launches_train = 0
#: backward kernel launches since the count was last set to 0
mamba_scan_bwd.launches = 0

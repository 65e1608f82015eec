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
- :func:`mamba_scan_plain` is the port of ``ssm_chunked_scan``: sequential
  over chunks, an associative scan of (decay, drive) pairs inside each, and a
  ragged tail padded with Δ = 0, which leaves the state untouched.

Shapes, all f32: u, Δ ``[B, S, di]``, A ``[di, ds]``, B, C ``[B, S, ds]``, h0
``[B, di, ds]``.  Results, f32: y ``[B, S, di]`` and the final state
``[B, di, ds]``.  The decode step of the model is elementwise, as in the
reference, and never calls the scan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._operand import kernel_operand

__all__ = ["mamba_scan", "mamba_scan_plain"]

_STATE_DIMS = (4, 8, 16, 32)  # the kernel's instantiations


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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/mamba_scan.cu``."""
    lib.mamba_scan_forward.argtypes = (
        [ctypes.c_void_p] * 8                        # u, delta, A, B, C, h0, y, h_fin
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]     # batch, S, di, ds, stream
    )
    lib.mamba_scan_forward.restype = ctypes.c_int
    lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
    lib.mamba_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load_library

    return _bind(load_library("mamba_scan"))


def _launch(u, delta, A, Bmat, Cmat, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, di = u.shape
    ds = A.shape[1]
    operands = (u, delta, A, Bmat, Cmat) + (() if h0 is None else (h0,))
    if any(x.device != u.device for x in operands):
        raise ValueError(f"mamba_scan operands must share one device; got {[str(x.device) for x in operands]}")
    if any(x.dtype != torch.float32 for x in operands):
        raise TypeError(f"kernel takes float32 u, delta, A, B, C and h0; got {[x.dtype for x in operands]}")
    if not all(x.is_contiguous() for x in operands):
        raise ValueError("kernel takes contiguous u, delta, A, B, C and h0")
    if ds not in _STATE_DIMS or B > 65535:
        raise ValueError(f"kernel takes ds in {_STATE_DIMS} and B <= 65535; got B={B} ds={ds}")
    u, delta, A, Bmat, Cmat = (kernel_operand(x) for x in (u, delta, A, Bmat, Cmat))
    h0 = None if h0 is None else kernel_operand(h0)
    y = torch.empty((B, S, di), dtype=torch.float32, device=u.device)
    h_fin = torch.empty((B, di, ds), dtype=torch.float32, device=u.device)
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.mamba_scan_forward(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
            B, S, di, ds, stream,
        )
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: {lib.mamba_scan_error_string(err).decode()}")
    mamba_scan.launches += 1
    return y, h_fin


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
    The kernel has no backward yet: a CUDA input that requires grad raises
    (with grad enabled) instead of returning a result with no gradient.
    """
    _check_shapes(u, delta, A, Bmat, Cmat, h0)
    if u.device.type == "cuda":
        if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (u, delta, A, Bmat, Cmat, h0)):
            raise NotImplementedError(
                "mamba_scan: the CUDA kernel has no backward yet (ROADMAP.md queue 2, item 2); its output "
                "would carry no gradient.  Call it under torch.no_grad() or with inputs that need none")
        return _launch(u, delta, A, Bmat, Cmat, h0)
    if u.device.type == "cpu":
        return mamba_scan_plain(u, delta, A, Bmat, Cmat, chunk=chunk, h0=h0)
    raise ValueError(f"mamba_scan runs on cuda or cpu tensors, not {u.device}")


#: kernel launches since the count was last set to 0 (CPU calls do not count)
mamba_scan.launches = 0

"""Flash attention: the CUDA kernels' wrappers and their plain PyTorch versions.

The forward replaces ``repro.kernels.flash_attention.flash_attention_pallas``
(the Pallas TPU kernel, ``src/repro/kernels/flash_attention.py:126``); its
kernel is ``csrc/flash_attention.cu``.  The Pallas kernel has no backward (the
reference trains through JAX's autodiff of its blocked jnp twin), so the
backward is kernels of its own, ``csrc/flash_attention_bwd.cu``.  Each source
comment gives the design and what bounds it on the card.

- :func:`flash_attention` dispatches on the tensor's device: a CUDA tensor
  launches the kernel (and raises if the build or the launch fails), a CPU
  tensor runs :func:`flash_attention_plain`.  On the card the dtype picks the
  kernel, by a fixed rule: bf16 runs the tensor-core (``wgmma``) kernel, f32
  the scalar one.  ``flash_attention.launches`` counts kernel launches, and
  ``launches_wgmma`` / ``launches_scalar`` count them by kernel.
- When grad is enabled and q, k or v requires grad, :func:`flash_attention`
  goes through a ``torch.autograd.Function``: its forward also writes each
  row's log-sum-exp, and its backward is :func:`flash_attention_bwd`, which
  runs the three backward kernels on a CUDA tensor (``launches_rowdot``,
  ``launches_dkdv`` and ``launches_dq`` count them) and
  :func:`flash_attention_bwd_plain` on a CPU one.  The backward takes
  ``q_offset == 0`` only.
- :func:`kernel_geometry` and :func:`tensor_map_geometry` give the launch
  geometry on the host (tile sizes, padding, shared memory, TMA boxes); the
  C side derives the same, and binding a library holds the two together: the
  kernel geometry for every (dtype, head dim) the wrapper takes, the tensor
  maps for the shapes in ``_MAP_CHECKS``.
- :func:`flash_attention_plain` is the port of the reference's blocked
  online-softmax twin (``repro.models.attention.flash_attention``,
  ``src/repro/models/attention.py:80-163``): ragged S/T are zero-padded to the
  chunk grid and padded keys are masked out.

Shapes: q ``[B, S, H, hd]``, k and v ``[B, T, Kv, hd]`` with ``H % Kv == 0``;
the output is ``[B, S, H, hd]`` in q's dtype.  Query i sits at absolute
position ``q_offset + i``, key j at ``j``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._operand import kernel_operand

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_with_lse", "flash_attention_bwd",
           "flash_attention_bwd_plain", "backward_launches",
           "kernel_geometry", "tensor_map_geometry", "backward_geometry", "KernelGeometry", "BackwardGeometry"]

_BIG_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
# (B, L, heads, hd, rows) the tensor maps are held to when a library is bound: B2 with
# ragged S, gemma2's and jamba's long prompts (q and K/V tiles), stablelm's hd 80, hd 8
_MAP_CHECKS = ((2, 300, 8, 256, 128), (1, 4608, 4, 256, 64), (1, 4096, 32, 128, 128),
               (1, 4096, 8, 128, 128), (1, 23, 32, 80, 128), (3, 17, 2, 8, 128))


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """How the card runs one (dtype, head dim); ``csrc/flash_attention.cu`` derives the same."""

    variant: str       # "wgmma" (bf16, tensor cores) or "scalar" (f32, CUDA cores)
    hd: int            # head dim the kernel sees: bf16 rounds up to 8 (the wrapper zero-pads)
    hd_pad: int        # Q·Kᵀ contraction depth: bf16 rounds up to wgmma's k-step of 16
    boxes: int         # 64-column (128-byte) TMA boxes per row; 0 for the scalar kernel
    block_q: int       # query rows per block
    block_kv: int      # keys per tile
    threads: int       # per block
    smem_bytes: int    # dynamic shared memory per block

    def as_c(self) -> Tuple[int, ...]:
        """The seven numbers ``fa_geometry`` writes, in its order."""
        return (int(self.variant == "wgmma"), self.hd_pad, self.boxes, self.block_q, self.block_kv,
                self.threads, self.smem_bytes)


def kernel_geometry(dtype: torch.dtype, hd: int) -> KernelGeometry:
    """The kernel and launch geometry for q, k, v of ``dtype`` and head dim ``hd``.

    bf16 runs the tensor-core kernel: 128 query rows per block (two
    warpgroups of 64), 64 keys per tile when the row takes
    more than two 64-column boxes and 128 otherwise, a 2-stage K/V ring, tiles
    kept in bf16.  f32 runs the scalar kernel: 64 rows, 32-key tiles in f32.
    """
    if dtype not in _DTYPE_CODE or not 0 < hd <= _MAX_HEAD_DIM:
        raise ValueError(f"no flash kernel for dtype {dtype} and head dim {hd}")
    if dtype == torch.float32:
        smem = 4 * (64 * hd + 32 * (hd + 4) + 32 * hd)
        return KernelGeometry("scalar", hd, hd, 0, 64, 32, 256, smem)
    hd8 = -(-hd // 8) * 8
    boxes = -(-hd8 // 64)
    block_kv = 64 if boxes >= 3 else 128
    row_bytes = 128 * boxes
    stages = 2
    barriers = 8 * (1 + 3 * stages) + 4 * stages  # Q, K, V full and stage-empty mbarriers, release counters
    smem = 1024 + 128 * row_bytes + 2 * stages * block_kv * row_bytes + barriers
    return KernelGeometry("wgmma", hd8, -(-hd8 // 16) * 16, boxes, 128, block_kv, 2 * 128, smem)


def tensor_map_geometry(B: int, L: int, heads: int, hd: int, rows: int):
    """The TMA map of a contiguous bf16 ``[B, L, heads, hd]`` tensor, as the C side encodes it.

    Returns ``(dims, strides, box)``: dims innermost first ``(hd, heads, L, B)``,
    the byte strides of dims 1-3, and the box ``(64, 1, rows, 1)``.  L keeps a
    dimension of its own, so a tile that runs past L reads zeros, never the
    next batch row; a box wider than hd reads zeros past hd.
    """
    if hd % 8:
        raise ValueError(f"TMA strides must be multiples of 16 bytes: bf16 head dim {hd} is not a multiple of 8")
    return (hd, heads, L, B), (2 * hd, 2 * hd * heads, 2 * hd * heads * L), (64, 1, rows, 1)


@dataclasses.dataclass(frozen=True)
class BackwardGeometry:
    """How the card runs the backward for one (dtype, head dim); ``csrc/flash_attention_bwd.cu`` derives the same."""

    variant: str       # "mma" (bf16, mma.sync on the tensor cores) or "scalar" (f32, CUDA cores)
    hd: int            # head dim the kernels see: bf16 rounds up to a multiple of 64 (the wrapper zero-pads)
    block_q: int       # queries per tile
    block_k: int       # keys per tile
    threads: int       # per block
    smem_dkdv: int     # dynamic shared memory of the dk / dv kernel
    smem_dq: int       # and of the dq kernel

    def as_c(self) -> Tuple[int, ...]:
        """The seven numbers ``fa_bwd_geometry`` writes, in its order."""
        return (int(self.variant == "mma"), self.hd, self.block_q, self.block_k, self.threads, self.smem_dkdv,
                self.smem_dq)


def backward_geometry(dtype: torch.dtype, hd: int) -> BackwardGeometry:
    """The backward kernels' geometry for q, k, v of ``dtype`` and head dim ``hd``.

    bf16: 64-query x 32-key tiles, 8 warps, head dim padded to whole 64-column
    groups, shared rows 16 bytes longer than the data; dk / dv keep K and V
    and two stages of Q and dO, dq keeps Q and dO and two stages of K and V,
    each with its p / ds tiles as bf16 hi and lo parts and f32 lse and D.
    f32: 16 x 16 tiles of one score per thread, rows padded by one float.
    """
    if dtype not in _DTYPE_CODE or not 0 < hd <= _MAX_HEAD_DIM:
        raise ValueError(f"no flash backward for dtype {dtype} and head dim {hd}")
    if dtype == torch.float32:
        tiles = 4 * 16 * (hd + 1)
        return BackwardGeometry("scalar", hd, 16, 16, 256, 4 * (tiles + 2 * 16 * hd + 2 * 256 + 32),
                                4 * (tiles + 16 * hd + 256 + 32))
    hd64 = -(-hd // 64) * 64
    row = 2 * (hd64 + 8)
    ps = 64 * 40 * 2
    return BackwardGeometry("mma", hd64, 64, 32, 256, 2 * 32 * row + 4 * 64 * row + 4 * ps + 4 * 64 * 4,
                            2 * 64 * row + 4 * 32 * row + 2 * ps + 2 * 64 * 4)


def _mask_block(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool, window: int) -> torch.Tensor:
    """[cq, ck] boolean validity mask."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return ok


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    logit_softcap: float = 0.0,
    chunk_q: int = 512,
    chunk_kv: int = 1024,
    q_offset: int = 0,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Blockwise online-softmax attention in f32; never builds the [S, T] matrix.

    With ``return_lse`` also returns each row's log-sum-exp of its (capped,
    masked) scores, f32 ``[B, H, S]``: ``m + log l`` of the running max and sum.
    """
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if H % Kv:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {Kv}")
    G = H // Kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cq, ck = min(chunk_q, S), min(chunk_kv, T)
    S_real, T_real = S, T
    qf, kf, vf = q.float(), k.float(), v.float()
    if S % cq or T % ck:
        S, T = -(-S // cq) * cq, -(-T // ck) * ck
        qf = F.pad(qf, (0, 0, 0, 0, 0, S - S_real))
        kf = F.pad(kf, (0, 0, 0, 0, 0, T - T_real))
        vf = F.pad(vf, (0, 0, 0, 0, 0, T - T_real))
    nq, nk = S // cq, T // ck
    qb = qf.reshape(B, nq, cq, Kv, G, hd)
    kb = kf.reshape(B, nk, ck, Kv, hd)
    vb = vf.reshape(B, nk, ck, Kv, hd)
    q_pos = q_offset + torch.arange(S, device=q.device).reshape(nq, cq)
    k_pos = torch.arange(T, device=q.device).reshape(nk, ck)

    blocks, lse_blocks = [], []
    for iq in range(nq):
        q_chunk = qb[:, iq]  # [B, cq, Kv, G, hd]
        m = torch.full((B, Kv, G, cq), _BIG_NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Kv, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Kv, G, cq, hd), dtype=torch.float32, device=q.device)
        for ik in range(nk):
            s = torch.einsum("bqkgd,btkd->bkgqt", q_chunk, kb[:, ik]) * scale
            if logit_softcap and logit_softcap > 0.0:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            ok = _mask_block(q_pos[iq], k_pos[ik], causal=causal, window=window)
            ok &= (k_pos[ik] < T_real)[None, :]  # padded keys never attended
            s = torch.where(ok, s, torch.full_like(s, _BIG_NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vb[:, ik])
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]  # [B, Kv, G, cq, hd]
        blocks.append(out.permute(0, 3, 1, 2, 4))         # [B, cq, Kv, G, hd]
        lse_blocks.append(m + torch.log(torch.clamp_min(l, 1e-30)))  # [B, Kv, G, cq]
    out = torch.cat(blocks, dim=1).reshape(B, S, H, hd)[:, :S_real].to(q.dtype)
    if not return_lse:
        return out
    return out, torch.cat(lse_blocks, dim=-1).reshape(B, H, S)[..., :S_real].contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    logit_softcap: float = 0.0,
    chunk_q: int = 512,
    chunk_kv: int = 1024,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of :func:`flash_attention_plain` (``q_offset`` 0), blockwise in f32.

    The backward kernels' arithmetic, step by step: from the forward's output
    ``o`` and log-sum-exp ``lse`` (f32 ``[B, H, S]``) and the output's gradient
    ``do``, with ``D = rowsum(do∘o)``, per block of scores ``s = scale·q·kᵀ``,
    ``t = tanh(s/cap)``, ``p = exp(cap·t - lse)`` under the mask (0 outside),
    ``dv += pᵀ·do``, ``ds = p∘(do·vᵀ - D)∘(1 - t²)`` (no last factor without a
    cap), ``dk += scale·dsᵀ·q`` summed over the G heads of a KV head, and
    ``dq += scale·ds·k``.  Blocks that the mask empties are skipped.  The
    gradients come back in the inputs' dtypes.
    """
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if H % Kv:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {Kv}")
    if lse.shape != (B, H, S):
        raise ValueError(f"lse must be [B, H, S] = {(B, H, S)}; got {tuple(lse.shape)}")
    G = H // Kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cap = logit_softcap if logit_softcap and logit_softcap > 0.0 else 0.0
    cq, ck = min(chunk_q, S), min(chunk_kv, T)
    S_real, T_real = S, T
    S, T = -(-S // cq) * cq, -(-T // ck) * ck
    dev = q.device
    row_pad = (0, 0, 0, 0, 0, S - S_real)
    qf, of, dof = (F.pad(x.float(), row_pad) for x in (q, o, do))
    kf, vf = (F.pad(x.float(), (0, 0, 0, 0, 0, T - T_real)) for x in (k, v))
    D = (dof * of).sum(-1)                                          # [B, S, H]
    lse_s = F.pad(lse.float().permute(0, 2, 1), (0, 0, 0, S - S_real))  # [B, S, H]
    nq, nk = S // cq, T // ck
    qb, dob = qf.reshape(B, nq, cq, Kv, G, hd), dof.reshape(B, nq, cq, Kv, G, hd)
    Db, lseb = D.reshape(B, nq, cq, Kv, G), lse_s.reshape(B, nq, cq, Kv, G)
    kb, vb = kf.reshape(B, nk, ck, Kv, hd), vf.reshape(B, nk, ck, Kv, hd)
    dq = torch.zeros_like(qb)
    dk = torch.zeros_like(kb)
    dv = torch.zeros_like(vb)
    q_pos = torch.arange(S, device=dev).reshape(nq, cq)
    k_pos = torch.arange(T, device=dev).reshape(nk, ck)
    for iq in range(nq):
        q_lo, q_hi = iq * cq, min(S_real, (iq + 1) * cq) - 1
        lse_c = lseb[:, iq].permute(0, 2, 3, 1)[..., None]          # [B, Kv, G, cq, 1]
        D_c = Db[:, iq].permute(0, 2, 3, 1)[..., None]
        for ik in range(nk):
            k_lo, k_hi = ik * ck, (ik + 1) * ck - 1
            if (causal and k_lo > q_hi) or (window and window > 0 and k_hi <= q_lo - window):
                continue                                            # no query of the block sees these keys
            s = torch.einsum("bqkgd,btkd->bkgqt", qb[:, iq], kb[:, ik]) * scale
            if cap:
                t = torch.tanh(s / cap)
                s = cap * t
            ok = _mask_block(q_pos[iq], k_pos[ik], causal=causal, window=window)
            ok &= (k_pos[ik] < T_real)[None, :] & (q_pos[iq] < S_real)[:, None]
            p = torch.exp(torch.where(ok, s - lse_c, torch.full_like(s, -math.inf)))
            dp = torch.einsum("bqkgd,btkd->bkgqt", dob[:, iq], vb[:, ik])
            ds = p * (dp - D_c)
            if cap:
                ds = ds * (1.0 - t * t)
            dv[:, ik] += torch.einsum("bkgqt,bqkgd->btkd", p, dob[:, iq])
            dk[:, ik] += torch.einsum("bkgqt,bqkgd->btkd", ds, qb[:, iq]) * scale
            dq[:, iq] += torch.einsum("bkgqt,btkd->bqkgd", ds, kb[:, ik]) * scale
    dq = dq.reshape(B, S, H, hd)[:, :S_real].to(q.dtype)
    dk = dk.reshape(B, T, Kv, hd)[:, :T_real].to(k.dtype)
    dv = dv.reshape(B, T, Kv, hd)[:, :T_real].to(v.dtype)
    return dq, dk, dv


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/flash_attention.cu``.

    Raises unless the library derives the same launch geometry as
    :func:`kernel_geometry` for every dtype and head dim the wrapper takes,
    and encodes the tensor maps of :func:`tensor_map_geometry`.
    """
    lib.fa_forward.argtypes = (
        [ctypes.c_void_p] * 5                        # q, k, v, out, lse (or null)
        + [ctypes.c_int] * 8                         # B, S, T, H, Kv, hd, causal, window
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )                                                # softcap, q_offset, scale, dtype, stream
    lib.fa_forward.restype = ctypes.c_int
    lib.fa_geometry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.fa_geometry.restype = ctypes.c_int
    lib.fa_tensor_map.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.fa_tensor_map.restype = None
    lib.fa_error_string.argtypes = [ctypes.c_int]
    lib.fa_error_string.restype = ctypes.c_char_p
    out = (ctypes.c_longlong * 7)()
    for dtype, code in _DTYPE_CODE.items():
        for hd in range(4, _MAX_HEAD_DIM + 1, 4):
            geom = kernel_geometry(dtype, hd)
            err = lib.fa_geometry(code, geom.hd, out)
            if err or tuple(out) != geom.as_c():
                raise RuntimeError(f"flash_attention: the kernel's geometry {tuple(out)} (err {err}) differs from "
                                   f"the wrapper's {geom.as_c()} for {dtype}, hd {geom.hd}")
    tmap = (ctypes.c_longlong * 11)()
    for shape in _MAP_CHECKS:
        lib.fa_tensor_map(*shape, tmap)
        want = tuple(n for part in tensor_map_geometry(*shape) for n in part)
        if tuple(tmap) != want:
            raise RuntimeError(f"flash_attention: the kernel's tensor map {tuple(tmap)} differs from the "
                               f"wrapper's {want} for [B, L, heads, hd], rows = {shape}")
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load_library

    return _bind(load_library("flash_attention"))


def _launch(q, k, v, *, causal, window, logit_softcap, q_offset, scale, return_lse=False):
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must share one device; got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q, k, v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (B, T, Kv, hd) or v.shape != k.shape:
        raise ValueError(f"k, v must be [B, T, Kv, hd] matching q {tuple(q.shape)}; got {tuple(k.shape)}, {tuple(v.shape)}")
    if H % Kv or hd % 4 or not 0 < hd <= _MAX_HEAD_DIM:
        raise ValueError(f"kernel needs H % Kv == 0, hd % 4 == 0 and hd <= {_MAX_HEAD_DIM}; got H={H} Kv={Kv} hd={hd}")
    if B > 65535 or H > 65535:
        raise ValueError(f"kernel grid takes B, H <= 65535; got B={B} H={H}")
    geom = kernel_geometry(q.dtype, hd)
    if geom.hd != hd:  # zero columns: no change to Q·Kᵀ, and output columns that are cut off again
        q, k, v = (F.pad(x, (0, geom.hd - hd)) for x in (q, k, v))
    q, k, v = (kernel_operand(x) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out[..., :hd], lse) if return_lse else out[..., :hd]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None,
            B, S, T, H, Kv, geom.hd, int(causal), int(window or 0), float(logit_softcap or 0.0),
            int(q_offset), float(scale), _DTYPE_CODE[q.dtype], stream,
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {lib.fa_error_string(err).decode()}")
    flash_attention.launches += 1
    if geom.variant == "wgmma":
        flash_attention.launches_wgmma += 1
    else:
        flash_attention.launches_scalar += 1
    out = out if geom.hd == hd else out[..., :hd].contiguous()
    return (out, lse) if return_lse else out


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/flash_attention_bwd.cu``.

    Raises unless the library derives the same geometry as
    :func:`backward_geometry` for every dtype and head dim the wrapper takes.
    """
    lib.fa_bwd_dot.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.fa_bwd_dot.restype = ctypes.c_int
    common = ([ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.fa_bwd_dkdv.argtypes = [ctypes.c_void_p] * 8 + common  # q k v do lse D dk dv, B S T H Kv hd causal window, ...
    lib.fa_bwd_dkdv.restype = ctypes.c_int
    lib.fa_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + common    # q k v do lse D dq, ...
    lib.fa_bwd_dq.restype = ctypes.c_int
    lib.fa_bwd_geometry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.fa_bwd_geometry.restype = ctypes.c_int
    lib.fa_bwd_error_string.argtypes = [ctypes.c_int]
    lib.fa_bwd_error_string.restype = ctypes.c_char_p
    out = (ctypes.c_longlong * 7)()
    for dtype, code in _DTYPE_CODE.items():
        for hd in range(1, _MAX_HEAD_DIM + 1):
            geom = backward_geometry(dtype, hd)
            err = lib.fa_bwd_geometry(code, hd, out)
            if err or tuple(out) != geom.as_c():
                raise RuntimeError(f"flash_attention_bwd: the kernels' geometry {tuple(out)} (err {err}) differs "
                                   f"from the wrapper's {geom.as_c()} for {dtype}, hd {hd}")
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load_library

    return _bind_bwd(load_library("flash_attention_bwd"))


def backward_launches(q, k, v, o, lse, do, *, causal=True, window=0, logit_softcap=0.0, scale=None):
    """The backward of CUDA tensors as its three kernel launches, for callers that time each one.

    Checks the operands, pads the head dim and allocates D and the gradients;
    returns ``(launches, finish)``: ``launches`` lists ``(name, launch)`` in the
    order they must run (``rowdot``, ``dkdv``, ``dq``), each ``launch()`` running
    one kernel on the current stream and adding one to its count, and
    ``finish()`` returns ``(dq, dk, dv)`` once all three have run.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    tensors = (q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernels take CUDA tensors, not {q.device}")
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"q, k, v, o, lse, do must share one device; got {[str(x.device) for x in tensors]}")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype for x in (k, v, o, do)) or lse.dtype != torch.float32:
        raise TypeError(f"backward takes float32 or bfloat16 q, k, v, o, do of one dtype and f32 lse; got "
                        f"{[str(x.dtype) for x in tensors]}")
    if k.shape != (B, T, Kv, hd) or v.shape != k.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"shapes q/o/do {tuple(q.shape)}, k/v [B, T, Kv, hd]; got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, do {tuple(do.shape)}")
    if lse.shape != (B, H, S):
        raise ValueError(f"lse must be [B, H, S] = {(B, H, S)}; got {tuple(lse.shape)}")
    if H % Kv or not 0 < hd <= _MAX_HEAD_DIM or B > 65535 or H > 65535:
        raise ValueError(f"backward needs H % Kv == 0, 0 < hd <= {_MAX_HEAD_DIM}, B, H <= 65535; "
                         f"got B={B} H={H} Kv={Kv} hd={hd}")
    geom = backward_geometry(q.dtype, hd)
    if geom.hd != hd:  # zero columns change no score, and their gradients are cut off again
        q, k, v, o, do = (F.pad(x, (0, geom.hd - hd)) for x in (q, k, v, o, do))
    q, k, v, o, do = (kernel_operand(x) for x in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)

    def finish():
        return (dq, dk, dv) if geom.hd == hd else tuple(x[..., :hd].contiguous() for x in (dq, dk, dv))

    lib = _bwd_lib()
    code = _DTYPE_CODE[q.dtype]
    shape = (B, S, T, H, Kv, geom.hd, int(causal), int(window or 0), float(logit_softcap or 0.0), float(scale), code)
    calls = {
        "rowdot": lambda stream: lib.fa_bwd_dot(o.data_ptr(), do.data_ptr(), D.data_ptr(), B, S, H, geom.hd, code,
                                                stream),
        "dkdv": lambda stream: lib.fa_bwd_dkdv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                               lse.data_ptr(), D.data_ptr(), dk.data_ptr(), dv.data_ptr(), *shape,
                                               stream),
        "dq": lambda stream: lib.fa_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                           D.data_ptr(), dq.data_ptr(), *shape, stream),
    }

    def launcher(name):
        def launch():
            with torch.cuda.device(q.device):
                err = calls[name](torch.cuda.current_stream(q.device).cuda_stream)
            if err:
                raise RuntimeError(f"flash attention backward kernel {name} failed to launch: "
                                   f"{lib.fa_bwd_error_string(err).decode()}")
            counter = f"launches_{name}"
            setattr(flash_attention_bwd, counter, getattr(flash_attention_bwd, counter) + 1)
        return launch

    return [(name, launcher(name)) for name in calls], finish


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0, logit_softcap=0.0, scale=None):
    """dq, dk, dv: the backward kernels for CUDA tensors, :func:`flash_attention_bwd_plain` for CPU ones."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap, scale=scale)
    if q.device.type == "cuda":
        launches, finish = backward_launches(q, k, v, o, lse, do, **kw)
        for _, launch in launches:
            launch()
        return finish()
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, not {q.device}")


#: backward kernel launches since each count was last set to 0 (CPU calls do not count)
flash_attention_bwd.launches_rowdot = 0
flash_attention_bwd.launches_dkdv = 0
flash_attention_bwd.launches_dq = 0


def flash_attention_with_lse(q, k, v, *, causal=True, window=0, logit_softcap=0.0, scale=None):
    """(out, lse) of :func:`flash_attention` with ``q_offset`` 0: the kernel for a CUDA tensor
    (it also writes f32 [B, H, S] log-sum-exps), the plain version for a CPU one."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, q_offset=0, return_lse=True, **kw)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, return_lse=True, **kw)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")


class _FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient: the forward keeps o and the log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap, scale):
        kw = dict(causal=causal, window=window, logit_softcap=logit_softcap, scale=scale)
        out, lse = flash_attention_with_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    logit_softcap: float = 0.0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention: the CUDA kernel for a CUDA tensor, the plain version for a CPU one.

    Differentiable when grad is enabled and q, k or v requires grad (then
    ``q_offset`` must be 0); otherwise the call is the forward alone, as
    serving makes it.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q_offset:
            raise NotImplementedError(f"the flash attention backward takes q_offset == 0 only; got {q_offset}")
        if q.device.type not in ("cuda", "cpu"):
            raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
        return _FlashAttentionFn.apply(q, k, v, bool(causal), int(window or 0), float(logit_softcap or 0.0),
                                       float(scale))
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap, q_offset=q_offset, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")


#: kernel launches since the count was last set to 0 (CPU calls do not count)
flash_attention.launches = 0
#: of those, launches of the tensor-core kernel (bf16) and of the scalar kernel (f32)
flash_attention.launches_wgmma = 0
flash_attention.launches_scalar = 0

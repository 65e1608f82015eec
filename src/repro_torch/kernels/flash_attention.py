"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` (the Pallas
TPU kernel, ``src/repro/kernels/flash_attention.py:126``).  The kernel is
``csrc/flash_attention.cu``; its source comment gives the design and what
bounds it on the card.

- :func:`flash_attention` dispatches on the tensor's device: a CUDA tensor
  launches the kernel (and raises if the build or the launch fails), a CPU
  tensor runs :func:`flash_attention_plain`.  On the card the dtype picks the
  kernel, by a fixed rule: bf16 runs the tensor-core (``wgmma``) kernel, f32
  the scalar one.  ``flash_attention.launches`` counts kernel launches, and
  ``launches_wgmma`` / ``launches_scalar`` count them by kernel.
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

__all__ = ["flash_attention", "flash_attention_plain", "kernel_geometry", "tensor_map_geometry", "KernelGeometry"]

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
) -> torch.Tensor:
    """Blockwise online-softmax attention in f32; never builds the [S, T] matrix."""
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

    blocks = []
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
    out = torch.cat(blocks, dim=1).reshape(B, S, H, hd)
    return out[:, :S_real].to(q.dtype)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/flash_attention.cu``.

    Raises unless the library derives the same launch geometry as
    :func:`kernel_geometry` for every dtype and head dim the wrapper takes,
    and encodes the tensor maps of :func:`tensor_map_geometry`.
    """
    lib.fa_forward.argtypes = (
        [ctypes.c_void_p] * 4                        # q, k, v, out
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


def _launch(q, k, v, *, causal, window, logit_softcap, q_offset, scale) -> torch.Tensor:
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
    if out.numel() == 0:
        return out[..., :hd]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
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
    return out if geom.hd == hd else out[..., :hd].contiguous()


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
    """Fused attention: the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
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

"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` (the Pallas
TPU kernel, ``src/repro/kernels/flash_attention.py:126``).  The kernel is
``csrc/flash_attention.cu``; its source comment gives the design and what
bounds it on the card.

- :func:`flash_attention` dispatches on the tensor's device: a CUDA tensor
  launches the kernel (and raises if the build or the launch fails), a CPU
  tensor runs :func:`flash_attention_plain`.  ``flash_attention.launches``
  counts kernel launches.
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
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["flash_attention", "flash_attention_plain"]

_BIG_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256


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
    """Declare the C interface of a library built from ``csrc/flash_attention.cu``."""
    lib.fa_forward.argtypes = (
        [ctypes.c_void_p] * 4                        # q, k, v, out
        + [ctypes.c_int] * 8                         # B, S, T, H, Kv, hd, causal, window
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )                                                # softcap, q_offset, scale, dtype, stream
    lib.fa_forward.restype = ctypes.c_int
    lib.fa_error_string.argtypes = [ctypes.c_int]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load_library

    return _bind(load_library("flash_attention"))


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, Kv, hd, int(causal), int(window or 0), float(logit_softcap or 0.0),
            int(q_offset), float(scale), _DTYPE_CODE[q.dtype], stream,
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {lib.fa_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


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

"""Port attention (plain blocked version, dense oracle, CUDA kernel) against the JAX reference.

The plain version and the port's oracle are held against
``repro.kernels.ref.attention_ref`` and the Pallas kernel in interpret mode,
at the reference's own tolerances (``tests/test_kernels.py``): 2e-5 in f32,
2e-2 in bf16.  The CUDA kernel itself runs only on a card (``gpu`` marker);
at the longer card-only shapes its bf16 gate takes the 2e-2 relative to the
rms of the plain output, as ``chip_smoke.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import attention_ref as jax_attention_ref
import repro_torch.kernels.flash_attention as fa
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
    kernel_geometry,
    tensor_map_geometry,
)
from repro_torch.kernels.ref import attention_ref

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
SMEM_PER_BLOCK = 232_448  # H100: the most dynamic shared memory one block may use
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# B, S, T, H, Kv, hd, causal, window, cap, q_offset, bq, bk
CASES = {
    # the five shape cases of tests/test_kernels.py
    "mha-causal": (2, 64, 64, 4, 2, 16, True, 0, 0.0, 0, 32, 32),
    "window-cap": (1, 128, 128, 4, 4, 32, True, 32, 50.0, 0, 32, 64),
    "bidir-gqa4": (2, 64, 64, 8, 2, 16, False, 0, 0.0, 0, 16, 32),
    "hd8-cap30": (1, 96, 96, 2, 1, 8, True, 0, 30.0, 0, 32, 32),
    "cross-T-ne-S": (1, 64, 128, 4, 2, 16, False, 0, 0.0, 0, 64, 32),
    # gemma2-2b geometry: H8 Kv4 hd256, softcap 50, local window
    "gemma2-local": (1, 64, 64, 8, 4, 256, True, 16, 50.0, 0, 32, 32),
    "gemma2-global": (1, 64, 64, 8, 4, 256, True, 0, 50.0, 0, 32, 32),
    # ragged prompt length (the serve path's 4-24 token prompts)
    "ragged-23": (2, 23, 23, 8, 4, 16, True, 0, 50.0, 0, 23, 23),
    # jamba's attention layer (H32 Kv8 hd128, no window or softcap) at a serve prompt's length
    "jamba-ragged-23": (1, 23, 23, 32, 8, 128, True, 0, 0.0, 0, 23, 23),
    # queries continuing a cached prefix: T = q_offset + S
    "q-offset": (1, 16, 48, 4, 2, 16, True, 24, 50.0, 32, 16, 16),
    # stablelm-3b's head dim: 80 is no multiple of 64, so the kernel's last column box is partial
    "stablelm-hd80": (1, 32, 32, 4, 4, 80, True, 0, 0.0, 0, 16, 16),
}

# kernel-vs-plain cases on the card only (the plain version is slow at these sizes on the CPU):
# B, S, T, H, Kv, hd, causal, window, cap, q_offset
GPU_CASES = {
    **{f"hd{hd}": (1, 200, 200, 4, 2, hd, True, 0, 50.0, 0) for hd in (8, 16, 32, 80, 128, 256)},
    "hd12-padded": (1, 100, 100, 2, 2, 12, True, 0, 0.0, 0),   # bf16: the wrapper pads hd to 16
    "window100": (1, 1024, 1024, 8, 4, 256, True, 100, 50.0, 0),
    "B2-ragged-S": (2, 300, 300, 8, 4, 256, True, 0, 50.0, 0),
    "q-offset-1024": (1, 300, 1324, 8, 4, 256, True, 4096, 50.0, 1024),
    "bidirectional": (2, 130, 260, 4, 4, 128, False, 0, 0.0, 0),
}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(case, dtype, seed=0):
    B, S, T, H, Kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd))]
    jx = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrs]
    return jx, tx


def _kw(case):
    causal, window, cap, q_offset = case[6:10]
    return dict(causal=causal, window=window, logit_softcap=cap, q_offset=q_offset)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rms_tol(dtype, plain):
    """bf16: atol 2e-2 x rms(plain), rtol 2e-2 (kernel and plain differ by one output rounding);
    f32: the reference's 2e-5."""
    if dtype == "float32":
        return TOL[dtype]
    return dict(atol=2e-2 * plain.float().pow(2).mean().sqrt().item(), rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_and_oracle_match_jax_reference(name, dtype):
    case = CASES[name]
    (qj, kj, vj), (qt, kt, vt) = _inputs(case, dtype)
    ref = _np(jax_attention_ref(qj, kj, vj, **_kw(case)))
    bq, bk = case[10:]
    plain = flash_attention_plain(qt, kt, vt, chunk_q=bq // 2 or 1, chunk_kv=bk // 2 or 1, **_kw(case))
    assert plain.dtype == TORCH_DTYPE[dtype] and plain.shape == qt.shape
    np.testing.assert_allclose(_np(plain), ref, **TOL[dtype])
    np.testing.assert_allclose(_np(attention_ref(qt, kt, vt, **_kw(case))), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name, dtype):
    case = CASES[name]
    (qj, kj, vj), (qt, kt, vt) = _inputs(case, dtype, seed=1)
    bq, bk = case[10:]
    pallas = flash_attention_pallas(qj, kj, vj, block_q=bq, block_kv=bk, interpret=True, **_kw(case))
    plain = flash_attention_plain(qt, kt, vt, chunk_q=bq, chunk_kv=bk, **_kw(case))
    np.testing.assert_allclose(_np(plain), _np(pallas), **TOL[dtype])


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    case = CASES["ragged-23"]
    _, (q, k, v) = _inputs(case, "float32")
    before = flash_attention.launches
    out = flash_attention(q, k, v, **_kw(case))
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, **_kw(case)), rtol=0, atol=0)


@pytest.mark.parametrize("dtype, variant", [(torch.bfloat16, "wgmma"), (torch.float32, "scalar")])
def test_geometry_variant_by_dtype(dtype, variant):
    assert kernel_geometry(dtype, 256).variant == variant
    with pytest.raises(ValueError):
        kernel_geometry(torch.float16, 256)


@pytest.mark.parametrize("hd, hd_pad, boxes", [(8, 16, 1), (16, 16, 1), (32, 32, 1), (80, 80, 2),
                                               (128, 128, 2), (256, 256, 4)])
def test_geometry_pads_head_dim_to_wgmma_and_tma(hd, hd_pad, boxes):
    g = kernel_geometry(torch.bfloat16, hd)
    assert (g.hd, g.hd_pad, g.boxes) == (hd, hd_pad, boxes)
    assert g.block_kv == (64 if hd > 128 else 128) and g.block_q == 128 and g.threads == 256


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [8, 12, 16, 32, 64, 80, 128, 192, 256])
def test_geometry_fits_shared_memory(dtype, hd):
    g = kernel_geometry(dtype, hd)
    assert 0 < g.smem_bytes <= SMEM_PER_BLOCK
    if dtype == torch.bfloat16:  # hd 4 mod 8 is zero-padded to the next multiple of 8
        assert g.hd == -(-hd // 8) * 8


def test_tensor_map_keeps_sequence_and_batch_apart():
    """B2 with S = 300, not a multiple of the 128-row q tile: the map's third dim is S itself, so
    the last tile's rows 300..383 fall outside it (zero-filled), never into batch row 1."""
    B, S, H, hd = 2, 300, 8, 256
    dims, strides, box = tensor_map_geometry(B, S, H, hd, kernel_geometry(torch.bfloat16, hd).block_q)
    x = torch.empty((B, S, H, hd), dtype=torch.bfloat16)
    assert dims == (hd, H, S, B)
    assert strides == tuple(2 * st for st in reversed(x.stride()[:-1]))
    assert all(st % 16 == 0 for st in strides)
    assert box == (64, 1, 128, 1)
    assert -(-S // box[2]) * box[2] > dims[2]
    with pytest.raises(ValueError):
        tensor_map_geometry(B, S, H, 12, 128)  # 24-byte head rows: TMA needs 16-byte strides


class _FakeLibrary:
    """The C interface of a built library, answering as ``csrc/flash_attention.cu`` does,
    except that its tensor map may merge L and B (``merge_l_and_b``)."""

    def __init__(self, merge_l_and_b):
        def fa_geometry(code, hd, out):
            dtype = next(d for d, c in fa._DTYPE_CODE.items() if c == code)
            out[:] = kernel_geometry(dtype, hd).as_c()
            return 0

        def fa_tensor_map(B, L, heads, hd, rows, out):
            dims, strides, box = tensor_map_geometry(B, L, heads, hd, rows)
            if merge_l_and_b:  # one [B * L] sequence: a tile past L reads the next batch row
                dims, strides = (hd, heads, B * L, 1), strides[:2] + (strides[2] * B,)
            out[:] = dims + strides + box

        self.fa_geometry, self.fa_tensor_map = fa_geometry, fa_tensor_map
        self.fa_forward = lambda *args: 0
        self.fa_error_string = lambda err: b""


@pytest.mark.parametrize("merge_l_and_b", [False, True])
def test_binding_holds_the_tensor_map_to_the_wrappers(merge_l_and_b):
    lib = _FakeLibrary(merge_l_and_b)
    if merge_l_and_b:
        with pytest.raises(RuntimeError, match="tensor map"):
            fa._bind(lib)
    else:
        assert fa._bind(lib) is lib


def test_zero_padding_the_head_dim_leaves_attention_unchanged():
    """What the wrapper does for a bf16 head dim of 4 mod 8, held on the plain version."""
    case = (1, 40, 40, 2, 2, 12, True, 0, 30.0, 0)
    _, (q, k, v) = _inputs(case, "float32")
    kw = _kw(case)
    pad = [torch.nn.functional.pad(x, (0, 4)) for x in (q, k, v)]
    padded = flash_attention_plain(*pad, scale=1 / 12 ** 0.5, **kw)
    torch.testing.assert_close(padded[..., :12], flash_attention_plain(q, k, v, **kw), rtol=0, atol=0)
    assert padded[..., 12:].abs().max() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    case = CASES[name]
    _, tx = _inputs(case, dtype, seed=2)
    q, k, v = (x.cuda() for x in tx)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **_kw(case))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    plain = flash_attention_plain(q, k, v, **_kw(case))
    np.testing.assert_allclose(_np(out.cpu()), _np(plain.cpu()), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(GPU_CASES))
def test_cuda_kernel_variant_matches_plain(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    case = GPU_CASES[name]
    _, tx = _inputs(case, dtype, seed=3)
    q, k, v = (x.cuda() for x in tx)
    variant = "launches_wgmma" if dtype == "bfloat16" else "launches_scalar"
    before = flash_attention.launches, getattr(flash_attention, variant)
    out = flash_attention(q, k, v, **_kw(case))
    torch.cuda.synchronize()
    assert (flash_attention.launches, getattr(flash_attention, variant)) == (before[0] + 1, before[1] + 1)
    plain = flash_attention_plain(q, k, v, **_kw(case))
    assert out.shape == q.shape and out.dtype == q.dtype
    np.testing.assert_allclose(_np(out.cpu()), _np(plain.cpu()), **_rms_tol(dtype, plain))

"""Port attention (plain blocked version, dense oracle, CUDA kernel) against the JAX reference.

The plain version and the port's oracle are held against
``repro.kernels.ref.attention_ref`` and the Pallas kernel in interpret mode,
at the reference's own tolerances (``tests/test_kernels.py``): 2e-5 in f32,
2e-2 in bf16.  The CUDA kernel itself runs only on a card (``gpu`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.ref import attention_ref

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
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

"""Port WKV-6 (plain chunked version, sequential oracle, CUDA kernel) against the JAX reference.

The plain version is held against the reference's chunked twin
``repro.models.rwkv6.wkv_chunked`` (the function the reference's prefill and
decode run, with a state in and out) and against the Pallas kernel
``wkv6_pallas`` in interpret mode (zero state); the port's oracle against the
JAX ``wkv6_ref``.  All in f32 at the reference's scan tolerance, 1e-4
(``tests/test_kernels.py``).  The CUDA kernel itself runs only on a card
(``gpu`` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import wkv6_ref as jax_wkv6_ref
from repro.kernels.rwkv6_scan import wkv6_pallas
from repro.models.rwkv6 import wkv_chunked
from repro_torch.kernels._operand import kernel_operand
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain

TOL = dict(atol=1e-4, rtol=1e-4)

# B, S, H, C, chunk
CASES = {
    # the three shape cases of tests/test_kernels.py
    "ref-c16": (2, 64, 2, 16, 16),
    "ref-c8": (1, 128, 4, 8, 32),
    "ref-c32": (1, 32, 1, 32, 8),
    # a ragged tail (padded with w = 1, k = 0) and a single decode token
    "ragged-20": (2, 20, 2, 16, 16),
    "decode-1": (4, 1, 2, 16, 16),
}
# card only (the plain version at these sizes is slow on a CPU): the full width's long
# prompt, a ragged last tile and step (4095), decode at 4 slots, a 7-token call (the short
# geometry of calls of at most 8 tokens, in two groups), and the smoke C = 16's ragged
# tail; held at chip_smoke.py's scan gate, atol 1e-4 x rms(plain) with rtol 1e-4
GPU_CASES = {
    "rwkv6-4096": (1, 4096, 64, 64, 256),
    "rwkv6-ragged-4095": (1, 4095, 64, 64, 256),
    "rwkv6-decode-B4": (4, 1, 64, 64, 256),
    "rwkv6-short-7": (2, 7, 64, 64, 256),
    "smoke-ragged-4095": (1, 4095, 4, 16, 16),
}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _arrays(B, S, H, C, seed=0):
    """r, k, v ~ N(0, 1); w in (0.45, 0.95) as the reference's tests draw it; u = 0.1·N; s0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, C)).astype(np.float32) for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, S, H, C)))) + 0.45).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, C))).astype(np.float32)
    s0 = rng.standard_normal((B, H, C, C)).astype(np.float32)
    return r, k, v, w, u, s0


def _torch(*arrs):
    return tuple(torch.from_numpy(a.copy()) for a in arrs)


def _jax(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


@pytest.mark.parametrize("with_s0", [False, True], ids=["s0-absent", "s0-present"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_wkv_chunked(name, with_s0):
    B, S, H, C, chunk = CASES[name]
    r, k, v, w, u, s0 = _arrays(B, S, H, C)
    s0 = s0 if with_s0 else None
    j_out, j_state = wkv_chunked(*_jax(r, k, v, w, u), chunk=chunk, s0=None if s0 is None else jnp.asarray(s0))
    t_out, t_state = wkv6_plain(*_torch(r, k, v, w, u), chunk=chunk, s0=None if s0 is None else torch.from_numpy(s0))
    assert t_out.dtype == torch.float32 and t_out.shape == (B, S, H, C)
    assert t_state.dtype == torch.float32 and t_state.shape == (B, H, C, C)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state), **TOL)


@pytest.mark.parametrize("name", ["ref-c16", "ref-c8", "ref-c32"])
def test_plain_without_state_matches_pallas_interpret(name):
    B, S, H, C, chunk = CASES[name]
    r, k, v, w, u, _ = _arrays(B, S, H, C, seed=1)
    pallas = wkv6_pallas(*_jax(r, k, v, w, u), chunk=chunk, interpret=True)
    plain, _ = wkv6_plain(*_torch(r, k, v, w, u), chunk=chunk)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("with_s0", [False, True], ids=["s0-absent", "s0-present"])
@pytest.mark.parametrize("name", ["ref-c16", "ragged-20", "decode-1"])
def test_oracle_matches_jax_oracle(name, with_s0):
    B, S, H, C, _ = CASES[name]
    r, k, v, w, u, s0 = _arrays(B, S, H, C, seed=2)
    s0 = s0 if with_s0 else None
    j_out, j_state = jax_wkv6_ref(*_jax(r, k, v, w, u), s0=None if s0 is None else jnp.asarray(s0))
    t_out, t_state = wkv6_ref(*_torch(r, k, v, w, u), s0=None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state), **TOL)


@pytest.mark.parametrize("chunk", [1, 7, 16, 64])
def test_plain_is_chunk_invariant(chunk):
    """Any chunking, ragged ones included, gives the sequential oracle's answer."""
    r, k, v, w, u, s0 = _torch(*_arrays(1, 64, 2, 8, seed=3))
    ref_out, ref_state = wkv6_ref(r, k, v, w, u, s0=s0)
    out, state = wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0)
    torch.testing.assert_close(out, ref_out, **TOL)
    torch.testing.assert_close(state, ref_state, **TOL)


@pytest.mark.parametrize("cut", [1, 32, 45])
def test_split_sequence_carried_through_s0_equals_whole(cut):
    r, k, v, w, u, _ = _torch(*_arrays(1, 64, 2, 8, seed=4))
    full, s_full = wkv6_plain(r, k, v, w, u, chunk=16)
    h1, s1 = wkv6_plain(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut], u, chunk=16)
    h2, s2 = wkv6_plain(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:], u, chunk=16, s0=s1)
    torch.testing.assert_close(torch.cat([h1, h2], dim=1), full, **TOL)
    torch.testing.assert_close(s2, s_full, **TOL)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    B, S, H, C, chunk = CASES["ragged-20"]
    r, k, v, w, u, s0 = _torch(*_arrays(B, S, H, C))
    before = wkv6.launches
    out, state = wkv6(r, k, v, w, u, chunk=chunk, s0=s0)
    assert wkv6.launches == before
    want_out, want_state = wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(state, want_state, rtol=0, atol=0)


def test_kernel_operand_is_contiguous_and_16_byte_aligned():
    """The kernels copy 16-byte chunks: a contiguous view that starts 4 bytes into its
    storage is copied to an aligned tensor with the same values; an aligned one is kept
    (the three wrappers pass every operand through this helper)."""
    flat = torch.arange(1 + 2 * 8 * 2 * 8, dtype=torch.float32)
    view = flat[1:].view(2, 8, 2, 8)
    assert view.is_contiguous() and view.data_ptr() % 16
    fixed = kernel_operand(view)
    assert fixed.data_ptr() % 16 == 0 and fixed.is_contiguous()
    torch.testing.assert_close(fixed, view, rtol=0, atol=0)
    aligned = flat[:-1].view(2, 8, 2, 8)
    assert kernel_operand(aligned) is aligned
    strided = aligned.transpose(1, 2)
    assert kernel_operand(strided).is_contiguous()


def test_wrapper_rejects_mismatched_shapes():
    r, k, v, w, u, s0 = _torch(*_arrays(2, 8, 2, 8))
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, w, u[:1], chunk=4)
    with pytest.raises(ValueError, match="s0 must be"):
        wkv6(r, k, v, w, u, chunk=4, s0=s0[:1])
    with pytest.raises(ValueError, match="w must match"):
        wkv6(r, k, v, w[:, :4], u, chunk=4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True], ids=["s0-absent", "s0-present"])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(GPU_CASES))
def test_cuda_kernel_matches_plain(name, with_s0, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, S, H, C, chunk = CASES[name] if name in CASES else GPU_CASES[name]
    r, k, v, w, u, s0 = (x.cuda() for x in _torch(*_arrays(B, S, H, C, seed=5)))
    r, k, v = (x.to(getattr(torch, dtype)) for x in (r, k, v))
    s0 = s0 if with_s0 else None
    before = wkv6.launches
    out, state = wkv6(r, k, v, w, u, chunk=chunk, s0=s0)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert out.dtype == torch.float32 and state.dtype == torch.float32
    want_out, want_state = wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0)
    for got, want in ((out, want_out), (state, want_state)):
        tol = TOL if name in CASES else dict(atol=1e-4 * want.pow(2).mean().sqrt().item(), rtol=1e-4)
        torch.testing.assert_close(got, want, **tol)

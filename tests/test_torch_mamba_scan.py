"""Port selective scan (plain chunked version, sequential oracle, CUDA kernel) against the JAX reference.

The plain version is held against the reference's chunked twin
``repro.models.mamba.ssm_chunked_scan`` (the function the reference's prefill
runs, with a state in and out) and against the Pallas kernel
``mamba_scan_pallas`` in interpret mode (zero state); the port's oracle
against the JAX ``mamba_scan_ref``.  All in f32 at the reference's scan
tolerance, 1e-4 (``tests/test_kernels.py``).  The CUDA kernel itself runs
only on a card (``gpu`` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.mamba_scan as ms
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.kernels.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro.models.mamba import ssm_chunked_scan
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
from repro_torch.kernels.ref import mamba_scan_ref

TOL = dict(atol=1e-4, rtol=1e-4)

# B, S, di, ds, chunk
CASES = {
    # the three shape cases of tests/test_kernels.py
    "ref-ds8": (2, 64, 32, 8, 16),
    "ref-ds16": (1, 32, 64, 16, 8),
    "ref-ds4": (1, 128, 16, 4, 32),
    # a ragged tail (padded with delta = 0), a single decode token, one chunk longer than S
    "ragged-20": (2, 20, 32, 8, 16),
    "decode-1": (4, 1, 32, 8, 16),
    "chunk-256": (1, 40, 32, 16, 256),
    "ragged-di-40": (2, 33, 40, 16, 16),  # the kernel's one block of 64 channels holds 40
}
# card only (the plain version at these sizes is slow on a CPU): jamba's full width at
# its long prompt, a ragged last tile and step (4095), decode at 4 slots, a 7-token call
# at a ragged di (the short geometry of calls of at most 8 tokens), and a ragged di
# (200: the last block of 64 channels holds 8; 202: rows that are not whole 16-byte
# chunks); held at chip_smoke.py's scan gate, atol 1e-4 x rms(plain) with rtol 1e-4
GPU_CASES = {
    "jamba-4096": (1, 4096, 8192, 16, 256),
    "jamba-ragged-4095": (1, 4095, 8192, 16, 256),
    "jamba-decode-B4": (4, 1, 8192, 16, 256),
    "ragged-di-200": (2, 300, 200, 16, 256),
    "ragged-di-202": (2, 300, 202, 16, 256),
    "short-7-di-202": (2, 7, 202, 16, 256),
}
PALLAS_BLOCK_D = {"ref-ds8": 16, "ref-ds16": 64, "ref-ds4": 16}  # tests/test_kernels.py's block_d


def _arrays(B, S, di, ds, seed=0):
    """u, B, C ~ N(0, 1); delta = softplus(N); A = -exp(0.5 N); h0 ~ N(0, 1): as the reference's tests draw them."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal((di, ds)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, ds)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32)
    return u, delta, A, Bm, Cm, h0


def _torch(*arrs):
    return tuple(torch.from_numpy(a.copy()) for a in arrs)


def _jax(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-absent", "h0-present"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_ssm_chunked_scan(name, with_h0):
    B, S, di, ds, chunk = CASES[name]
    u, delta, A, Bm, Cm, h0 = _arrays(B, S, di, ds)
    h0 = h0 if with_h0 else None
    j_y, j_h = ssm_chunked_scan(*_jax(u, delta, A, Bm, Cm), chunk=chunk,
                                h0=None if h0 is None else jnp.asarray(h0))
    t_y, t_h = mamba_scan_plain(*_torch(u, delta, A, Bm, Cm), chunk=chunk,
                                h0=None if h0 is None else torch.from_numpy(h0))
    assert t_y.dtype == torch.float32 and t_y.shape == (B, S, di)
    assert t_h.dtype == torch.float32 and t_h.shape == (B, di, ds)
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), **TOL)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), **TOL)


@pytest.mark.parametrize("name", sorted(PALLAS_BLOCK_D))
def test_plain_without_state_matches_pallas_interpret(name):
    B, S, di, ds, chunk = CASES[name]
    u, delta, A, Bm, Cm, _ = _arrays(B, S, di, ds, seed=1)
    pallas = mamba_scan_pallas(*_jax(u, delta, A, Bm, Cm), chunk=chunk, block_d=PALLAS_BLOCK_D[name],
                               interpret=True)
    plain, _ = mamba_scan_plain(*_torch(u, delta, A, Bm, Cm), chunk=chunk)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-absent", "h0-present"])
@pytest.mark.parametrize("name", ["ref-ds8", "ragged-20", "decode-1"])
def test_oracle_matches_jax_oracle(name, with_h0):
    B, S, di, ds, _ = CASES[name]
    u, delta, A, Bm, Cm, h0 = _arrays(B, S, di, ds, seed=2)
    h0 = h0 if with_h0 else None
    j_y, j_h = jax_mamba_scan_ref(*_jax(u, delta, A, Bm, Cm), h0=None if h0 is None else jnp.asarray(h0))
    t_y, t_h = mamba_scan_ref(*_torch(u, delta, A, Bm, Cm), h0=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), **TOL)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), **TOL)


@pytest.mark.parametrize("chunk", [1, 7, 16, 64, 256])
def test_plain_is_chunk_invariant(chunk):
    """Any chunking, ragged ones and one longer than S included, gives the sequential oracle's answer."""
    u, delta, A, Bm, Cm, h0 = _torch(*_arrays(1, 64, 16, 8, seed=3))
    ref_y, ref_h = mamba_scan_ref(u, delta, A, Bm, Cm, h0=h0)
    y, h = mamba_scan_plain(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.testing.assert_close(y, ref_y, **TOL)
    torch.testing.assert_close(h, ref_h, **TOL)


@pytest.mark.parametrize("cut", [1, 32, 45])
def test_split_sequence_carried_through_h0_equals_whole(cut):
    u, delta, A, Bm, Cm, _ = _torch(*_arrays(1, 64, 16, 8, seed=4))
    full, h_full = mamba_scan_plain(u, delta, A, Bm, Cm, chunk=16)
    y1, h1 = mamba_scan_plain(u[:, :cut], delta[:, :cut], A, Bm[:, :cut], Cm[:, :cut], chunk=16)
    y2, h2 = mamba_scan_plain(u[:, cut:], delta[:, cut:], A, Bm[:, cut:], Cm[:, cut:], chunk=16, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), full, **TOL)
    torch.testing.assert_close(h2, h_full, **TOL)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    B, S, di, ds, chunk = CASES["ragged-20"]
    u, delta, A, Bm, Cm, h0 = _torch(*_arrays(B, S, di, ds))
    before = mamba_scan.launches
    y, h = mamba_scan(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
    assert mamba_scan.launches == before
    want_y, want_h = mamba_scan_plain(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)


def test_wrapper_rejects_mismatched_shapes():
    u, delta, A, Bm, Cm, h0 = _torch(*_arrays(2, 8, 32, 8))
    with pytest.raises(ValueError, match="delta must match"):
        mamba_scan(u, delta[:, :4], A, Bm, Cm, chunk=4)
    with pytest.raises(ValueError, match="A must be"):
        mamba_scan(u, delta, A[:16], Bm, Cm, chunk=4)
    with pytest.raises(ValueError, match="Cmat must be"):
        mamba_scan(u, delta, A, Bm, Cm[..., :4], chunk=4)
    with pytest.raises(ValueError, match="h0 must be"):
        mamba_scan(u, delta, A, Bm, Cm, chunk=4, h0=h0[:1])
    with pytest.raises(ValueError, match="S >= 1"):
        mamba_scan(u[:, :0], delta[:, :0], A, Bm[:, :0], Cm[:, :0], chunk=4)


def test_kernel_launch_refuses_what_it_does_not_take():
    """The kernel's own checks, made before anything is built or launched: f32 only,
    contiguous only, ds in the instantiated set and a batch the grid can hold."""
    u, delta, A, Bm, Cm, h0 = _torch(*_arrays(2, 8, 32, 8))
    with pytest.raises(TypeError, match="float32"):
        ms._launch(u.bfloat16(), delta, A, Bm, Cm, None)
    with pytest.raises(TypeError, match="float32"):
        ms._launch(u, delta, A, Bm, Cm, h0.double())
    with pytest.raises(ValueError, match="contiguous"):
        ms._launch(u, delta, A, Bm.transpose(1, 2).contiguous().transpose(1, 2), Cm, None)
    u5, d5, A5, B5, C5, _ = _torch(*_arrays(2, 8, 32, 5))
    with pytest.raises(ValueError, match="ds in"):
        ms._launch(u5, d5, A5, B5, C5, None)
    wide = torch.zeros((65536, 1, 32)), torch.zeros((65536, 1, 32)), A, torch.zeros((65536, 1, 8))
    with pytest.raises(ValueError, match="B <= 65535"):
        ms._launch(*wide, wide[-1], None)


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-absent", "h0-present"])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(GPU_CASES))
def test_cuda_kernel_matches_plain(name, with_h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, S, di, ds, chunk = CASES[name] if name in CASES else GPU_CASES[name]
    u, delta, A, Bm, Cm, h0 = (x.cuda() for x in _torch(*_arrays(B, S, di, ds, seed=5)))
    h0 = h0 if with_h0 else None
    before = mamba_scan.launches
    y, h = mamba_scan(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    want_y, want_h = mamba_scan_plain(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
    for got, want in ((y, want_y), (h, want_h)):
        tol = TOL if name in CASES else dict(atol=1e-4 * want.pow(2).mean().sqrt().item(), rtol=1e-4)
        torch.testing.assert_close(got, want, **tol)


def test_plain_returns_contiguous_results():
    """y (cut from a padded tail) and the final state (a slice of the last chunk) come back
    contiguous, as the kernel returns them, so that either can be fed on as it is."""
    u, delta, A, Bm, Cm, h0 = _torch(*_arrays(4, 20, 32, 8, seed=6))
    y, h = mamba_scan_plain(u, delta, A, Bm, Cm, chunk=16, h0=h0)
    assert y.is_contiguous() and h.is_contiguous()

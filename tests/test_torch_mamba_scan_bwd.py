"""The selective scan's backward: its plain version and the autograd Function on the CPU, against JAX.

``mamba_scan_bwd_plain`` gives the gradients (du, dΔ, dA, dB, dC, dh0) of the
forward's (y, final state) against (dy, dh_fin).  It is held against
``jax.vjp`` of the reference's chunked twin ``ssm_chunked_scan`` (whose
gradient the reference trains with) at chunks 16 and 256, and of its
sequential oracle ``mamba_scan_ref``, in f32 at the reference's scan tolerance,
1e-4 (``tests/test_kernels.py``): with and without h0 and dh_fin, ragged S
across the chunks and the kernels' saved states (every 16 tokens), one token,
and decays near 0 (large Δ·|A|).  ``mamba_scan`` with inputs that need grad
goes through ``_MambaScanFn``, which on the CPU runs the plain forward and
this backward; it is held against autograd of ``mamba_scan_plain``.  The CUDA
kernels run only on a card (``tests/test_torch_scans_need_no_grad.py``,
``gpu`` marker, and ``chip_smoke.py``); the backward kernel's ``gpu`` test below
holds it against the exact gradients (this plain backward in f64) at
``chip_smoke.py``'s gate, at small sizes: ds 4, 8 and 16, ragged S and di, with
and without h0 and dh_fin, two calls bitwise equal.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro.models.mamba import ssm_chunked_scan
import repro_torch.kernels.mamba_scan as ms
from repro_torch.kernels.mamba_scan import CHECKPOINT, mamba_scan, mamba_scan_bwd, mamba_scan_bwd_plain, mamba_scan_plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
GRADS = ("du", "ddelta", "dA", "dB", "dC", "dh0")

# B, S, di, ds, chunk of ssm_chunked_scan, h0 given, dh_fin given
CASES = {
    "c16": (2, 64, 32, 8, 16, False, False),
    "c16-h0-dhfin": (2, 64, 32, 8, 16, True, True),
    "c16-ds16-dhfin": (1, 48, 24, 16, 16, False, True),
    "c16-ds4-h0": (2, 32, 16, 4, 16, True, False),
    # ragged: S ends mid-chunk and mid-way between the saved states
    "ragged-37": (2, 37, 16, 8, 16, True, True),
    "c256-ragged-300": (1, 300, 16, 16, 256, False, True),
    "c256-longer-than-S": (2, 40, 24, 8, 256, True, False),
    "decode-1": (3, 1, 16, 8, 16, True, True),
}


def _arrays(B, S, di, ds, seed=0, near_zero_decay=False):
    """u, B, C ~ N(0, 1); Δ = softplus(N); A = -exp(0.5 N), as the reference's tests draw them; h0, dy,
    dh_fin ~ N(0, 1).  With ``near_zero_decay`` a third of Δ is scaled by 40, so that exp(Δ A) reaches
    1e-10 and below (and underflows to 0 for some)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    if near_zero_decay:
        delta = np.where(rng.random((B, S, di)) < 1 / 3, 40 * delta, delta).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal((di, ds)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, ds)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32)
    dy = rng.standard_normal((B, S, di)).astype(np.float32)
    dh_fin = rng.standard_normal((B, di, ds)).astype(np.float32)
    return u, delta, A, Bm, Cm, h0, dy, dh_fin


def _case(name, seed=0, near_zero_decay=False):
    B, S, di, ds, chunk, with_h0, with_dhfin = CASES[name]
    u, delta, A, Bm, Cm, h0, dy, dh_fin = _arrays(B, S, di, ds, seed, near_zero_decay)
    return chunk, (u, delta, A, Bm, Cm, h0 if with_h0 else None, dy, dh_fin if with_dhfin else None)


def _jax_grads(fn, u, delta, A, Bm, Cm, h0, dy, dh_fin):
    """jax.vjp of fn(u, delta, A, B, C, h0) -> (y, h_final), with a zero h0 / dh_fin where they are None."""
    B, S, di = u.shape
    ds = A.shape[1]
    h0_j = jnp.zeros((B, di, ds), jnp.float32) if h0 is None else jnp.asarray(h0)
    dh_j = jnp.zeros((B, di, ds), jnp.float32) if dh_fin is None else jnp.asarray(dh_fin)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (u, delta, A, Bm, Cm)), h0_j)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), dh_j))]


def _plain_grads(u, delta, A, Bm, Cm, h0, dy, dh_fin):
    t = lambda x: None if x is None else torch.from_numpy(x.copy())  # noqa: E731
    return [g.numpy() for g in mamba_scan_bwd_plain(t(u), t(delta), t(A), t(Bm), t(Cm), t(h0), t(dy), t(dh_fin))]


def _assert_grads(got, want, name):
    for gname, g, wnt in zip(GRADS, got, want):
        assert g.dtype == np.float32 and g.shape == wnt.shape, gname
        assert np.isfinite(g).all(), gname
        np.testing.assert_allclose(g, wnt, **TOL, err_msg=f"{name} {gname}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bwd_matches_vjp_of_ssm_chunked_scan(name):
    chunk, args = _case(name)
    want = _jax_grads(lambda u, d, A, Bm, Cm, h0: ssm_chunked_scan(u, d, A, Bm, Cm, chunk=chunk, h0=h0), *args)
    B, S, di = args[0].shape
    ds = args[2].shape[1]
    shapes = [(B, S, di)] * 2 + [(di, ds), (B, S, ds), (B, S, ds), (B, di, ds)]
    assert [w.shape for w in want] == shapes
    _assert_grads(_plain_grads(*args), want, name)


@pytest.mark.parametrize("name", ["c16-h0-dhfin", "ragged-37", "decode-1"])
def test_plain_bwd_matches_vjp_of_the_oracle(name):
    _, args = _case(name, seed=1)
    want = _jax_grads(lambda u, d, A, Bm, Cm, h0: jax_mamba_scan_ref(u, d, A, Bm, Cm, h0=h0), *args)
    _assert_grads(_plain_grads(*args), want, name)


@pytest.mark.parametrize("name", ["c16-h0-dhfin", "c256-ragged-300"])
def test_decays_near_zero(name):
    """A third of Δ scaled by 40: exp(Δ A) down to 1e-10 and below, some of it 0 in f32.  The old states
    are never divided by a decay, so every gradient stays finite and on JAX's, chunked and sequential."""
    chunk, args = _case(name, seed=2, near_zero_decay=True)
    decay = np.exp(args[1][..., None] * args[2])
    assert (decay < 1e-10).mean() > 0.05 and (decay == 0).any()
    got = _plain_grads(*args)
    for fn in (lambda u, d, A, Bm, Cm, h0: ssm_chunked_scan(u, d, A, Bm, Cm, chunk=chunk, h0=h0),
               lambda u, d, A, Bm, Cm, h0: jax_mamba_scan_ref(u, d, A, Bm, Cm, h0=h0)):
        _assert_grads(got, _jax_grads(fn, *args), name)


def test_plain_bwd_keeps_states_only_at_checkpoints(monkeypatch):
    """The plain backward never holds [B, S, di, ds]: it saves the state before every CHECKPOINT tokens and
    recomputes one span at a time, so its largest tensor is one state, and its exponentials are S for the
    forward sweep, at most S for the recomputation and S for the backward sweep."""
    _, args = _case("c256-ragged-300", seed=3)
    calls = []
    real_exp = torch.exp

    def counting(x, *a, **kw):
        calls.append(tuple(x.shape))
        return real_exp(x, *a, **kw)

    monkeypatch.setattr(torch, "exp", counting)
    _plain_grads(*args)
    B, S, di = args[0].shape
    ds = args[2].shape[1]
    assert set(calls) == {(B, di, ds)}
    assert len(calls) <= 3 * S and S % CHECKPOINT != 0


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-absent", "h0-present"])
@pytest.mark.parametrize("use_state", [False, True], ids=["y-only", "y-and-state"])
def test_function_on_cpu_matches_autograd_of_plain(with_h0, use_state):
    """mamba_scan with inputs that need grad (the Function: plain forward, plain backward) against autograd
    through mamba_scan_plain's own ops; only y used leaves dh_fin None."""
    chunk, (u, delta, A, Bm, Cm, h0, dy, dh_fin) = _case("ragged-37", seed=4)
    h0 = h0 if with_h0 else None
    grads = []
    for fn in (mamba_scan, mamba_scan_plain):
        leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (u, delta, A, Bm, Cm)]
        h0_t = None if h0 is None else torch.from_numpy(h0.copy()).requires_grad_()
        y, state = fn(*leaves, chunk=chunk, h0=h0_t)
        loss = (y * torch.from_numpy(dy)).sum()
        if use_state:
            loss = loss + (state * torch.from_numpy(dh_fin)).sum()
        grads.append(torch.autograd.grad(loss, leaves + ([] if h0_t is None else [h0_t])))
    assert y.grad_fn is not None
    for gname, got, want in zip(GRADS, *grads):
        torch.testing.assert_close(got, want, **TOL, msg=gname)


def test_function_returns_no_h0_gradient_without_h0():
    """Without h0 the Function gives five gradients and the final state still carries one (dh_fin)."""
    u, delta, A, Bm, Cm, _, dy, dh_fin = _arrays(2, 64, 32, 8, seed=5)
    leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (u, delta, A, Bm, Cm)]
    y, state = mamba_scan(*leaves, chunk=16)
    assert type(y.grad_fn).__name__ == "_MambaScanFnBackward"
    loss = (y * torch.from_numpy(dy)).sum() + (state * torch.from_numpy(dh_fin)).sum()
    got = torch.autograd.grad(loss, leaves)
    want = mamba_scan_bwd_plain(*(x.detach() for x in leaves), None, torch.from_numpy(dy), torch.from_numpy(dh_fin))
    for gname, g, w in zip(GRADS, got, want):
        assert torch.equal(g, w), gname


@pytest.mark.parametrize("name", ["c16-ds4-h0", "c16-ds16-dhfin", "ragged-37"])
def test_plain_bwd_in_f64_is_exact(name):
    """Given f64 inputs the plain backward computes in f64, the exact gradients that chip_smoke.py holds the
    kernel against: equal to autograd through the recurrence written out in f64 to 1e-10 of each gradient's
    rms, while the f32 call on the same inputs stays within the scan tolerance of them."""
    _, args = _case(name, seed=6)
    u, delta, A, Bm, Cm, h0, dy, dh_fin = (None if x is None else torch.from_numpy(x.astype(np.float64))
                                           for x in args)
    got = mamba_scan_bwd_plain(u, delta, A, Bm, Cm, h0, dy, dh_fin)
    assert all(g.dtype == torch.float64 for g in got)
    leaves = [x.clone().requires_grad_() for x in (u, delta, A, Bm, Cm) + (() if h0 is None else (h0,))]
    u_, delta_, A_, Bm_, Cm_ = leaves[:5]
    h = leaves[5] if h0 is not None else torch.zeros((u.shape[0], u.shape[2], A.shape[1]), dtype=torch.float64)
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp(delta_[:, t, :, None] * A_) * h + (delta_[:, t] * u_[:, t])[..., None] * Bm_[:, t, None, :]
        ys.append((h * Cm_[:, t, None, :]).sum(-1))
    loss = (torch.stack(ys, 1) * dy).sum() + (0 if dh_fin is None else (h * dh_fin).sum())
    want = torch.autograd.grad(loss, leaves)
    f32 = mamba_scan_bwd_plain(*(None if x is None else x.float() for x in (u, delta, A, Bm, Cm, h0, dy, dh_fin)))
    for gname, g, w, g32 in zip(GRADS, got, want, f32):
        rms = w.pow(2).mean().sqrt().item()
        torch.testing.assert_close(g, w, atol=1e-10 * rms, rtol=1e-10, msg=gname)
        assert g32.dtype == torch.float32
        torch.testing.assert_close(g32.double(), w, atol=TOL["atol"] * rms, rtol=TOL["rtol"], msg=gname)


# the backward kernel on the card: B, S, di, ds, h0 and dh_fin given, near-zero decays
GPU_CASES = {
    "ds4-h0-dhfin": (2, 64, 64, 4, True, False),
    "ds8": (2, 64, 128, 8, False, False),
    "ds16-h0-dhfin": (2, 64, 128, 16, True, False),
    "ds16-ragged-37": (2, 37, 128, 16, True, False),         # a last span of 5 tokens
    "ds16-ragged-di-202": (2, 300, 202, 16, True, False),    # rows not whole 16-byte chunks, a last block of 10
    "ds8-ragged-di-202": (1, 45, 202, 8, False, False),
    "ds4-ragged-di-40": (1, 21, 40, 4, True, False),
    "ds16-near-zero-decay": (2, 64, 128, 16, True, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GPU_CASES))
def test_cuda_kernel_matches_exact_gradients(name):
    """The kernel fed by the forward's training form, against this plain backward in f64 at chip_smoke.py's gate
    (mamba_bwd_tols: the f32 plain version's own max |error| plus 1e-4 x rms, rtol 1e-4); two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, S, di, ds, carried, near_zero = GPU_CASES[name]
    u, delta, A, Bm, Cm, h0, dy, dh_fin = (torch.from_numpy(x).cuda()
                                           for x in _arrays(B, S, di, ds, seed=7, near_zero_decay=near_zero))
    h0, dh_fin = (h0, dh_fin) if carried else (None, None)
    _, _, h_chk = ms._launch(u, delta, A, Bm, Cm, h0, train=True)
    before = mamba_scan_bwd.launches
    got = mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy, dh_fin)
    again = mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy, dh_fin)
    torch.cuda.synchronize()
    assert mamba_scan_bwd.launches == before + 2
    plain = mamba_scan_bwd_plain(u, delta, A, Bm, Cm, h0, dy, dh_fin)
    exact = mamba_scan_bwd_plain(*(None if x is None else x.double() for x in (u, delta, A, Bm, Cm, h0, dy, dh_fin)))
    tols = chip_smoke.mamba_bwd_tols(exact, plain)
    for gname, g, g2, e, p in zip(GRADS, got, again, exact, plain):
        assert g.dtype == torch.float32 and g.shape == p.shape, gname
        assert torch.equal(g, g2), f"{name} {gname}: two calls differ"
        tol = tols[chip_smoke.SCAN_GRADS[GRADS.index(gname)]]
        torch.testing.assert_close(g.double(), e, atol=tol["atol"], rtol=tol["rtol"], msg=f"{name} {gname}")

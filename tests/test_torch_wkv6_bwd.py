"""The WKV-6 backward's plain version and the autograd Function on the CPU, against JAX.

``wkv6_bwd_plain`` gives the gradients (dr, dk, dv, dw, du, ds0) of the
forward's (out, final state) against (dout, ds_fin).  It is held against
``jax.vjp`` of the reference's chunked twin ``wkv_chunked`` (whose gradient the
reference trains with) and of its sequential oracle ``wkv6_ref``, in f32 at the
reference's scan tolerance, 1e-4 (``tests/test_kernels.py``): with and without
s0 and ds_fin, ragged S across chunk boundaries, and decays near the 1e-38
clamp.  There ``wkv_chunked``'s own gradient is not finite (its exp(-inf)
masks), so the oracle, with the same clamp, is the ground: the gradient of w is
0 where w <= 1e-38.  ``wkv6`` with inputs that need grad goes through
``_WKV6Fn``, which on the CPU runs the plain forward and this backward; it is
held against autograd of ``wkv6_plain``.  The CUDA kernel runs only on a card
(``tests/test_torch_scans_need_no_grad.py``, ``gpu`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv6 import wkv_chunked
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd_plain, wkv6_plain

TOL = dict(atol=1e-4, rtol=1e-4)
GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")

# B, S, H, C, chunk of wkv_chunked, s0 given, ds_fin given
CASES = {
    "c16": (2, 64, 2, 16, 16, False, False),
    "c16-s0-dsfin": (2, 64, 2, 16, 16, True, True),
    "c8-dsfin": (1, 128, 4, 8, 32, False, True),
    "c32-s0": (1, 32, 1, 32, 8, True, False),
    # ragged: S crosses the chunk and the kernels' saved states (every 16 tokens) mid-way
    "ragged-37": (2, 37, 2, 8, 16, True, True),
    "ragged-20": (2, 20, 2, 16, 16, False, True),
    "decode-1": (4, 1, 2, 16, 16, True, True),
}


def _arrays(B, S, H, C, seed=0):
    """r, k, v ~ N(0, 1); w in (0.45, 0.95) as the reference's tests draw it; u = 0.1·N; s0, dout, ds_fin ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, C)).astype(np.float32) for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, S, H, C)))) + 0.45).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, C))).astype(np.float32)
    s0 = rng.standard_normal((B, H, C, C)).astype(np.float32)
    dout = rng.standard_normal((B, S, H, C)).astype(np.float32)
    ds_fin = rng.standard_normal((B, H, C, C)).astype(np.float32)
    return r, k, v, w, u, s0, dout, ds_fin


def _near_clamp(w, seed):
    """w with a tenth of its entries at 1e-36, a twentieth each at 1e-30, 1e-40 (under the clamp) and 0."""
    m = np.random.default_rng(seed).random(w.shape)
    for lo, hi, value in ((0.0, 0.1, 1e-36), (0.1, 0.15, 1e-30), (0.15, 0.2, 1e-40), (0.2, 0.25, 0.0)):
        w = np.where((m >= lo) & (m < hi), np.float32(value), w)
    return w.astype(np.float32)


def _jax_grads(fn, r, k, v, w, u, s0, dout, ds_fin):
    """jax.vjp of fn(r, k, v, w, u, s0) -> (out, state), with a zero s0 / ds_fin where they are None."""
    B, S, H, C = r.shape
    s0_j = jnp.zeros((B, H, C, C), jnp.float32) if s0 is None else jnp.asarray(s0)
    ds_j = jnp.zeros((B, H, C, C), jnp.float32) if ds_fin is None else jnp.asarray(ds_fin)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (r, k, v, w, u)), s0_j)
    return [np.asarray(g) for g in vjp((jnp.asarray(dout), ds_j))]


def _plain_grads(r, k, v, w, u, s0, dout, ds_fin):
    t = lambda x: None if x is None else torch.from_numpy(x.copy())  # noqa: E731
    return [g.numpy() for g in wkv6_bwd_plain(t(r), t(k), t(v), t(w), t(u), t(s0), t(dout), t(ds_fin))]


def _case(name, seed=0):
    B, S, H, C, chunk, with_s0, with_dsfin = CASES[name]
    r, k, v, w, u, s0, dout, ds_fin = _arrays(B, S, H, C, seed)
    return chunk, (r, k, v, w, u, s0 if with_s0 else None, dout, ds_fin if with_dsfin else None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bwd_matches_vjp_of_wkv_chunked(name):
    chunk, args = _case(name)
    want = _jax_grads(lambda r, k, v, w, u, s0: wkv_chunked(r, k, v, w, u, chunk=chunk, s0=s0), *args)
    got = _plain_grads(*args)
    B, S, H, C = args[0].shape
    shapes = [(B, S, H, C)] * 4 + [(H, C), (B, H, C, C)]
    for gname, g, wnt, shape in zip(GRADS, got, want, shapes):
        assert g.dtype == np.float32 and g.shape == shape, gname
        np.testing.assert_allclose(g, wnt, **TOL, err_msg=f"{name} {gname}")


@pytest.mark.parametrize("name", ["c16-s0-dsfin", "ragged-37", "decode-1"])
def test_plain_bwd_matches_vjp_of_the_oracle(name):
    _, args = _case(name, seed=1)
    want = _jax_grads(lambda r, k, v, w, u, s0: jax_wkv6_ref(r, k, v, w, u, s0=s0), *args)
    for gname, g, wnt in zip(GRADS, _plain_grads(*args), want):
        np.testing.assert_allclose(g, wnt, **TOL, err_msg=f"{name} {gname}")


@pytest.mark.parametrize("name", ["c16-s0-dsfin", "ragged-37"])
def test_decays_near_the_clamp(name):
    """w at 1e-36 and 1e-30 (above the clamp), 1e-40 and 0 (under it): against the oracle's vjp with the
    reference's clamp max(w, 1e-38).  On the CPU JAX flushes the subnormal 1e-38 to 0, so under the clamp
    its max ties and splits the gradient; there the plain backward's dw must be exactly 0."""
    _, (r, k, v, w, u, s0, dout, ds_fin) = _case(name, seed=2)
    w = _near_clamp(w, seed=3)
    args = (r, k, v, w, u, s0, dout, ds_fin)
    want = _jax_grads(lambda r, k, v, w, u, s0: jax_wkv6_ref(r, k, v, jnp.maximum(w, 1e-38), u, s0=s0), *args)
    got = _plain_grads(*args)
    above = w > 1e-38
    assert above.mean() < 0.95 and (~above).sum() > 0
    for gname, g, wnt in zip(GRADS, got, want):
        assert np.isfinite(g).all(), gname
        if gname == "dw":
            np.testing.assert_allclose(g[above], wnt[above], **TOL, err_msg=f"{name} dw")
            assert not g[~above].any(), "dw must be 0 where w <= 1e-38"
        else:
            np.testing.assert_allclose(g, wnt, **TOL, err_msg=f"{name} {gname}")


@pytest.mark.parametrize("with_s0", [False, True], ids=["s0-absent", "s0-present"])
@pytest.mark.parametrize("use_state", [False, True], ids=["out-only", "out-and-state"])
def test_function_on_cpu_matches_autograd_of_plain(with_s0, use_state):
    """wkv6 with inputs that need grad (the Function: plain forward, plain backward) against autograd
    through wkv6_plain's own ops; only out used leaves ds_fin None."""
    chunk, (r, k, v, w, u, s0, dout, ds_fin) = _case("ragged-37", seed=4)
    s0 = s0 if with_s0 else None
    grads = []
    for fn in (wkv6, wkv6_plain):
        leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (r, k, v, w, u)]
        s0_t = None if s0 is None else torch.from_numpy(s0.copy()).requires_grad_()
        out, state = fn(*leaves, chunk=chunk, s0=s0_t)
        loss = (out * torch.from_numpy(dout)).sum()
        if use_state:
            loss = loss + (state * torch.from_numpy(ds_fin)).sum()
        grads.append(torch.autograd.grad(loss, leaves + ([] if s0_t is None else [s0_t])))
    assert out.grad_fn is not None
    for gname, got, want in zip(GRADS, *grads):
        torch.testing.assert_close(got, want, **TOL, msg=gname)


def test_function_keeps_the_input_dtypes():
    """bf16 r, k, v give bf16 dr, dk, dv (computed in f32), f32 w and u f32 dw and du."""
    _, (r, k, v, w, u, _, dout, _) = _case("c16", seed=5)
    rkv = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (r, k, v)]
    wu = [torch.from_numpy(x).requires_grad_() for x in (w, u)]
    out, _ = wkv6(*rkv, *wu, chunk=16)
    grads = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), rkv + wu)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32] * 2
    want = wkv6_bwd_plain(*(x.detach() for x in rkv + wu), None, torch.from_numpy(dout), None)
    for got, wnt in zip(grads, want):
        assert torch.equal(got, wnt)


def test_plain_bwd_matches_autograd_of_the_port_oracle():
    """The port's sequential oracle wkv6_ref, differentiated by autograd, at decays above the clamp."""
    _, (r, k, v, w, u, s0, dout, ds_fin) = _case("ragged-37", seed=6)
    leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (r, k, v, w, u, s0)]
    out, state = wkv6_ref(*leaves[:5], s0=leaves[5])
    want = torch.autograd.grad((out * torch.from_numpy(dout)).sum() + (state * torch.from_numpy(ds_fin)).sum(),
                               leaves)
    got = wkv6_bwd_plain(*(torch.from_numpy(x) for x in (r, k, v, w, u, s0, dout, ds_fin)))
    for gname, g, wnt in zip(GRADS, got, want):
        torch.testing.assert_close(g, wnt, **TOL, msg=gname)


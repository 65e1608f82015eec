"""Port layers (repro_torch.models.layers) against the JAX reference, f32, tol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pair(rng, *shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_dense_with_bias():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, 2, 5, 32)
    wj, wt = _pair(rng, 32, 4, 8)
    bj, bt = _pair(rng, 4, 8)
    out_j = jl.dense({"w": wj, "b": bj}, xj, dtype=jnp.float32)
    out_t = tl.dense({"w": wt, "b": bt}, xt, dtype=torch.float32)
    _close(out_t, out_j)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, 2, 7, 64, scale=3.0)
    sj, st = _pair(rng, 64)
    bj, bt = _pair(rng, 64)
    out_j = jl.norm({"scale": sj, "bias": bj}, xj, kind=kind)
    out_t = tl.norm({"scale": st, "bias": bt}, xt, kind=kind)
    _close(out_t, out_j)


@pytest.mark.parametrize("max_pos", [24, 5000])
@pytest.mark.parametrize("head_dim,fraction", [(16, 1.0), (32, 0.25), (80, 0.25), (256, 1.0)])
def test_rope(head_dim, fraction, max_pos):
    """Full and partial-fraction RoPE on interleaved pairs, at short and long positions."""
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, 2, 9, 3, head_dim)
    pos = rng.integers(0, max_pos, size=(2, 9)).astype(np.int32)
    fj = jl.rope_freqs(head_dim, fraction, 10000.0)
    ft = tl.rope_freqs(head_dim, fraction, 10000.0)
    _close(ft, fj)
    _close(tl.apply_rope(xt, torch.from_numpy(pos.astype(np.int64)), ft), jl.apply_rope(xj, jnp.asarray(pos), fj))


@pytest.mark.parametrize("activation", ["gelu", "swiglu", "relu2"])
def test_mlp(activation):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng, 2, 6, 32)
    names = (["wi_gate"] if activation == "swiglu" else []) + ["wi_up"]
    pj, pt = {}, {}
    for name in names:
        wj, wt = _pair(rng, 32, 64, scale=0.2)
        pj[name], pt[name] = {"w": wj}, {"w": wt}
    wj, wt = _pair(rng, 64, 32, scale=0.2)
    pj["wo"], pt["wo"] = {"w": wj}, {"w": wt}
    out_j = jl.mlp(pj, xj, activation=activation, dtype=jnp.float32)
    out_t = tl.mlp(pt, xt, activation=activation, dtype=torch.float32)
    _close(out_t, out_j)


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap(cap):
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng, 3, 50, scale=40.0)
    _close(tl.softcap(xt, cap), jl.softcap(xj, cap))


def test_embed_unembed():
    rng = np.random.default_rng(6)
    tj, tt = _pair(rng, 100, 16)
    tokens = rng.integers(0, 100, size=(2, 7))
    e_j = jl.embed({"table": tj}, jnp.asarray(tokens, jnp.int32), dtype=jnp.float32)
    e_t = tl.embed({"table": tt}, torch.from_numpy(tokens), dtype=torch.float32)
    _close(e_t, e_j)
    _close(tl.unembed({"table": tt}, e_t, dtype=torch.float32),
           jl.unembed({"table": tj}, e_j, dtype=jnp.float32))


def test_cast_for_compute_keeps_norm_scales_f32():
    params = {"norm1": {"scale": torch.ones(4)}, "ffn": {"wo": {"w": torch.randn(4, 4)}},
              "embed": {"table": torch.randn(8, 4)}}
    out = tl.cast_for_compute(params, torch.bfloat16)
    assert out["norm1"]["scale"].dtype == torch.float32
    assert out["ffn"]["wo"]["w"].dtype == torch.bfloat16
    assert out["embed"]["table"].dtype == torch.bfloat16
    assert torch.equal(out["ffn"]["wo"]["w"], params["ffn"]["wo"]["w"].to(torch.bfloat16))

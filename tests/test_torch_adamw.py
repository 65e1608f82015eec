"""The port's functional AdamW, schedule and clipping against ``repro.optim.adamw``.

Same inputs from a seed on both sides; params, moments, grad_norm and lr after
one and three updates agree to f32 rounding (rtol 1e-6, atol 1e-7: both sides
compute the same f32 operations in the same order, up to fused multiply-adds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import clip_by_global_norm as jax_clip
from repro.optim.adamw import cosine_schedule as jax_cosine_schedule
from repro.optim.adamw import global_norm as jax_global_norm
from repro_torch.optim import AdamW, AdamWConfig, clip_by_global_norm, cosine_schedule, global_norm
from repro_torch.optim.adamw import tree_leaves, tree_unflatten

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"embed": {"table": (16, 8)}, "units": {"pos0": {"w": (8, 4, 2), "b": (4, 2)}}, "final": {"scale": (8,)}}


def _tree(rng, scale=1.0):
    def build(node):
        return {k: build(v) if isinstance(v, dict) else (scale * rng.standard_normal(v)).astype(np.float32)
                for k, v in node.items()}
    return build(SHAPES)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy()) for k, v in tree.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(torch_tree, jax_tree):
    for a, b in zip(tree_leaves(torch_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_tree_order_is_jax_flatten_order():
    tree = _tree(np.random.default_rng(0))
    for a, b in zip(tree_leaves(_torch(tree)), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a.numpy(), b)
    leaves = tree_leaves(_torch(tree))
    assert tree_leaves(tree_unflatten(tree, leaves)) == leaves


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 5), (10, 10)])
def test_cosine_schedule_matches(warmup, total):
    ours = cosine_schedule(1e-3, warmup_steps=warmup, total_steps=total)
    ref = jax_cosine_schedule(1e-3, warmup_steps=warmup, total_steps=total)
    for step in range(0, total + 3):
        np.testing.assert_allclose(float(ours(torch.tensor(step, dtype=torch.int32))),
                                   float(ref(jnp.asarray(step, jnp.int32))), **TOL)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_global_norm_and_clipping_match(scale):
    tree = _tree(np.random.default_rng(1), scale)
    np.testing.assert_allclose(float(global_norm(_torch(tree))), float(jax_global_norm(_jax(tree))), **TOL)
    clipped, norm = clip_by_global_norm(_torch(tree), 1.0)
    jclipped, jnorm = jax_clip(_jax(tree), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), **TOL)
    _close(clipped, jclipped)


@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("grad_scale", [0.1, 30.0])   # below and above the clip norm of 1
def test_updates_match_reference(n_updates, grad_scale):
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1, clip_norm=1.0)
    ours, ref = AdamW(AdamWConfig(**cfg)), JaxAdamW(JaxAdamWConfig(**cfg))
    rng = np.random.default_rng(2)
    params_np = _tree(rng)
    params, jparams = _torch(params_np), _jax(params_np)
    state, jstate = ours.init(params), ref.init(jparams)
    for _ in range(n_updates):
        grads_np = _tree(rng, grad_scale)
        params, state, stats = ours.update(_torch(grads_np), state, params)
        jparams, jstate, jstats = ref.update(_jax(grads_np), jstate, jparams)
        np.testing.assert_allclose(float(stats["grad_norm"]), float(jstats["grad_norm"]), **TOL)
        np.testing.assert_allclose(float(stats["lr"]), float(jstats["lr"]), **TOL)
        _close(params, jparams)
        _close(state["mu"], jstate["mu"])
        _close(state["nu"], jstate["nu"])
        assert int(state["count"]) == int(jstate["count"])


def test_update_is_in_place():
    opt = AdamW(AdamWConfig())
    params = _torch(_tree(np.random.default_rng(3)))
    leaves = tree_leaves(params)
    state = opt.init(params)
    mu = tree_leaves(state["mu"])
    new_params, new_state, _ = opt.update(_torch(_tree(np.random.default_rng(4))), state, params)
    assert all(a is b for a, b in zip(tree_leaves(new_params), leaves))
    assert all(a is b for a, b in zip(tree_leaves(new_state["mu"]), mu))

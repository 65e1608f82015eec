"""The port's MoE FFN against the JAX reference on the CPU (f32, TF32 off).

GShard one-hot dispatch with per-expert capacity: the port must route, fill
and drop exactly as the reference does, so these cases make capacity bind
(tokens dropped), run the ``moe_block`` path, and tie router probabilities
exactly (where the lower expert index must win, as in ``jax.lax.top_k``).
Weights come from the JAX init, inputs from numpy; outputs are held at 1e-5
(one f32 block, no scan).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import moe as JMOE
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import moe as TMOE
from repro_torch.models.layers import Init, cast_for_compute

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "jamba-v0.1-52b"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _configs(**kw):
    """The jamba smoke configs (4 experts, top-2, d_ff 64), with ``kw`` applied to both and
    ``moe_kw`` to both MoE specs."""
    moe_kw = kw.pop("moe_kw", {})
    jcfg, tcfg = jax_smoke_variant(JAX_ARCHS[ARCH]), smoke_variant(get_config(ARCH))
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw), **kw)
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe_kw), **kw)
    return jcfg, tcfg


def _params(jcfg, router=None, seed=0):
    jp = jax.tree.map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(seed), jcfg, param_dtype=jnp.float32))
    if router is not None:
        jp["router"]["w"] = router(np.array(jp["router"]["w"]))
    tp = {k: convert.unflatten({p: torch.from_numpy(np.array(v)) for p, v in convert.flatten(sub).items()})
          for k, sub in jp.items()}
    return jax.tree.map(jnp.asarray, jp), tp


def _x(S, d, seed=0, shift=0.0, B=2):
    return (np.random.default_rng(seed).standard_normal((B, S, d)) + shift).astype(np.float32)


def _run(jcfg, tcfg, jp, tp, x):
    jout, jaux = JMOE.moe_layer(jp, jnp.asarray(x), jcfg, dtype=jnp.float32)
    tout, taux = TMOE.moe_layer(tp, torch.from_numpy(x), tcfg, dtype=torch.float32)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    return tout


def _demand(tp, x, tcfg, choices=1):
    """Requests per row and expert from the first ``choices`` of each token, by the port's own gating."""
    logits = torch.from_numpy(x) @ tp["router"]["w"]
    _, idx, _ = TMOE._top_k_gating(logits, tcfg.moe.top_k)
    return torch.nn.functional.one_hot(idx[..., :choices], tcfg.moe.n_experts).sum(dim=(1, 2))


def test_moe_matches_jax():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    _run(jcfg, tcfg, jp, tp, _x(24, tcfg.d_model))


@pytest.mark.parametrize("variant", [dict(activation="relu2"), dict(activation="gelu"),
                                     dict(moe_kw=dict(shared_expert=True))])
def test_unported_expert_variants_are_refused(variant):
    """Only jamba's swiglu experts without a shared expert are ported; the rest raise, in init and forward."""
    _, tcfg = _configs(**variant)
    init = Init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
        TMOE.init_moe(init, tcfg)
    _, tp = _params(_configs()[0])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
        TMOE.moe_layer(tp, torch.from_numpy(_x(4, tcfg.d_model)), tcfg, dtype=torch.float32)


def test_moe_matches_jax_where_capacity_drops_tokens():
    """Expert 0 is every token's first choice: 32 requests against C = ceil(32·2·1.25/4) = 20 slots."""
    jcfg, tcfg = _configs()

    def prefer_expert0(w):
        w[:, 0] += 0.3
        return w

    jp, tp = _params(jcfg, router=prefer_expert0)
    x = _x(32, tcfg.d_model, shift=2.0)
    C = int(np.ceil(32 * 2 * 1.25 / 4))
    assert (_demand(tp, x, tcfg)[:, 0] > C).all()
    _run(jcfg, tcfg, jp, tp, x)


def test_moe_block_path_matches_jax():
    """moe_block 8 of S 32: capacity is counted per block (C = 5) and binds."""
    jcfg, tcfg = _configs(moe_block=8)
    jp, tp = _params(jcfg, seed=1)
    x = _x(32, tcfg.d_model, seed=1)
    blocks = x.reshape(8, 8, tcfg.d_model)
    assert (_demand(tp, blocks, tcfg, choices=2) > 5).any()
    _run(jcfg, tcfg, jp, tp, x)
    # a block that does not divide S falls back to whole-row dispatch, as in the reference
    _run(jcfg.replace(moe_block=7), tcfg.replace(moe_block=7), jp, tp, _x(32, tcfg.d_model, seed=2))


@pytest.mark.parametrize("tie", ["all-experts", "experts-1-and-2"])
def test_exact_ties_pick_the_lower_expert_as_jax_does(tie):
    jcfg, tcfg = _configs()

    def tied(w):
        if tie == "all-experts":
            return np.zeros_like(w)
        w[:, 2] = w[:, 1]
        return w

    jp, tp = _params(jcfg, router=tied, seed=2)
    x = _x(20, tcfg.d_model, seed=3)
    logits = x @ np.asarray(jp["router"]["w"])
    jgates, jidx, _ = JMOE._top_k_gating(jnp.asarray(logits), 2)
    tgates, tidx, _ = TMOE._top_k_gating(torch.from_numpy(logits), 2)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tgates.numpy(), np.asarray(jgates), rtol=1e-6)
    if tie == "all-experts":
        assert (tidx.numpy() == [0, 1]).all()
    _run(jcfg, tcfg, jp, tp, x)


def test_single_token_rows_as_decode_sends_them():
    """Decode routes B rows of one token: C = ceil(1·2·1.25/4) = 1 slot per expert and row."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=4)
    _run(jcfg, tcfg, jp, tp, _x(1, tcfg.d_model, seed=5, B=4))


def test_router_stays_f32_under_bf16_compute():
    """The reference gates in f32 from the router's master weights; the engine's cast keeps them."""
    _, tcfg = _configs()
    p = TMOE.init_moe(Init(torch.Generator().manual_seed(0), "cpu", torch.float32), tcfg)
    cast = cast_for_compute({"ffn": p}, torch.bfloat16)["ffn"]
    assert cast["router"]["w"] is p["router"]["w"]
    assert all(cast[k]["w"].dtype == torch.bfloat16 for k in ("w_gate", "w_up", "w_down"))


def test_init_layout_and_distributions():
    _, tcfg = _configs(d_model=256, moe_kw=dict(d_ff=512))
    p = TMOE.init_moe(Init(torch.Generator().manual_seed(0), "cpu", torch.float32, (2,)), tcfg)
    jcfg, _ = _configs(d_model=256, moe_kw=dict(d_ff=512))
    jp = jax.eval_shape(lambda: JMOE.init_moe(jax.random.PRNGKey(0), jcfg, param_dtype=jnp.float32))
    jshapes = {"/".join(str(k.key) for k in path): (2,) + tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {k: tuple(v.shape) for k, v in convert.flatten(p).items()} == jshapes
    np.testing.assert_allclose(p["w_gate"]["w"].std().item(), 256 ** -0.5, rtol=0.05)
    np.testing.assert_allclose(p["w_down"]["w"].std().item(), 512 ** -0.5, rtol=0.05)
    np.testing.assert_allclose(p["router"]["w"].std().item(), 256 ** -0.5, rtol=0.05)

"""The port's training loss and its gradients against ``Model.train_loss`` and ``jax.grad``.

gemma2-2b's smoke variant (2 layers: a 16-token window layer and a global
one, softcaps 50 and 30, sandwich norms), parameters moved from JAX through
``convert.params_from_jax``, batches from the same ``SyntheticLM``.  The loss
agrees at rtol 1e-5 (``tests/test_train.py:41``), every gradient leaf at
atol 1e-5 and rtol 1e-4 (``tests/test_train.py:43``), in f32, with ``remat``
"none" and "unit", ``gather_ce`` both ways and ``remat_loss_chunk`` on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models.model import Model as JaxModel
from repro_torch import convert
from repro_torch.configs import SHAPES, ShapeConfig, get_config, smoke_variant
from repro_torch.data import ShardedPipeline, SyntheticLM
from repro_torch.models import Model

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
B, S, CHUNK = 2, 32, 16


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_side():
    jcfg = jax_smoke_variant(JAX_ARCHS["gemma2-2b"])
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    batch = ShardedPipeline(SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=S, period=16, vocab_eff=256),
                            global_batch=B).batch_at(0)
    return jcfg, jparams, batch


def _jax_loss_and_grads(jcfg, jparams, batch):
    model = JaxModel(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(lambda p: model.train_loss(p, jbatch, loss_chunk=CHUNK), has_aux=True)(jparams)
    return float(loss), convert.flatten(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(tcfg, jparams, batch):
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    flat = convert.flatten(params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    loss, metrics = Model(tcfg, device="cpu").train_loss(params, batch, loss_chunk=CHUNK)
    assert metrics["loss"] is loss and float(metrics["moe_aux"]) == 0.0
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss.detach()), dict(zip(flat, grads))


@pytest.mark.parametrize("remat", ["none", "unit"])
@pytest.mark.parametrize("gather_ce", [False, True])
def test_loss_and_grads_match_jax(jax_side, remat, gather_ce):
    jcfg, jparams, batch = jax_side
    jcfg = dataclasses.replace(jcfg, remat=remat, gather_ce=gather_ce)
    tcfg = smoke_variant(get_config("gemma2-2b")).replace(remat=remat, gather_ce=gather_ce)
    want_loss, want = _jax_loss_and_grads(jcfg, jparams, batch)
    got_loss, got = _port_loss_and_grads(tcfg, jparams, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert g.dtype == torch.float32, path
        np.testing.assert_allclose(g.numpy(), want[path], **GRAD_TOL, err_msg=path)


def test_loss_chunk_remat_matches_jax(jax_side):
    jcfg, jparams, batch = jax_side
    jcfg = dataclasses.replace(jcfg, remat_loss_chunk=True)
    tcfg = smoke_variant(get_config("gemma2-2b")).replace(remat_loss_chunk=True)
    want_loss, want = _jax_loss_and_grads(jcfg, jparams, batch)
    got_loss, got = _port_loss_and_grads(tcfg, jparams, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[path], **GRAD_TOL, err_msg=path)


def test_unit_remat_recomputes_attention_in_the_backward(jax_side):
    """remat="unit" saves nothing inside a unit: the forward of each attention layer runs again."""
    from repro_torch.kernels import flash_attention as fa

    _, jparams, batch = jax_side
    calls = []
    real = fa._FlashAttentionFn.forward

    def counting(ctx, *args):
        calls.append(1)
        return real(ctx, *args)

    for remat, want in (("none", 2), ("unit", 4)):
        tcfg = smoke_variant(get_config("gemma2-2b")).replace(remat=remat)
        calls.clear()
        fa._FlashAttentionFn.forward = staticmethod(counting)
        try:
            _port_loss_and_grads(tcfg, jparams, batch)
        finally:
            fa._FlashAttentionFn.forward = staticmethod(real)
        assert len(calls) == want, remat


def test_dots_remat_is_refused(jax_side):
    _, jparams, batch = jax_side
    tcfg = smoke_variant(get_config("gemma2-2b")).replace(remat="dots")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 3h"):
        _port_loss_and_grads(tcfg, jparams, batch)


def test_other_families_are_refused():
    """No family is refused any more: jamba's Mamba mixers train through the selective scan's autograd
    Function (tests/test_torch_mamba_train.py holds them to jax.grad), as rwkv6 and olmoe do
    (tests/test_torch_ssm_moe_train.py); only remat="dots" is refused, for jamba as for gemma2."""
    tcfg = smoke_variant(get_config("jamba-v0.1-52b"))
    model = Model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    flat = convert.flatten(params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    batch = {"tokens": np.zeros((1, 16), np.int32), "targets": np.zeros((1, 16), np.int32)}
    loss, _ = model.train_loss(params, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    mamba_grads = [g for path, g in zip(flat, grads) if "/mixer/A_log" in path]
    assert mamba_grads and all(g.abs().sum() > 0 for g in mamba_grads)
    with pytest.raises(NotImplementedError, match="item 3h"):
        Model(tcfg.replace(remat="dots"), device="cpu").train_loss(params, batch)


def test_input_shapes_and_make_batch():
    model = Model(smoke_variant(get_config("gemma2-2b")), device="cpu")
    shape = ShapeConfig("t", "train", 32, 4)
    assert model.input_shapes(shape) == {"tokens": ((4, 32), torch.int32), "targets": ((4, 32), torch.int32)}
    assert model.input_shapes(SHAPES["prefill_32k"]) == {"tokens": ((32, 32768), torch.int32)}
    assert model.input_shapes(SHAPES["decode_32k"]) == {"tokens": ((128, 1), torch.int32)}
    a = model.make_batch(torch.Generator().manual_seed(0), shape)
    b = model.make_batch(torch.Generator().manual_seed(0), shape)
    assert sorted(a) == ["targets", "tokens"]
    for key in a:
        assert a[key].dtype == torch.int32 and a[key].shape == (4, 32) and torch.equal(a[key], b[key])
        assert 0 <= int(a[key].min()) and int(a[key].max()) < model.cfg.vocab_size
    loss, _ = model.train_loss(model.init(torch.Generator().manual_seed(0)), a, loss_chunk=16)
    assert torch.isfinite(loss)

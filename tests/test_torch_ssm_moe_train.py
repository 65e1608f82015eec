"""Training of rwkv6-7b and olmoe-1b-7b through the port, against ``Model.train_loss`` and ``jax.grad``.

The smoke variants cut to 2 layers (rwkv6: WKV-6 time-mix and channel-mix,
head_dim 16, ``ssm_chunk`` 16; olmoe: attention with qk-norm and a 4-expert
top-2 MoE), parameters moved from JAX through ``convert.params_from_jax``,
batches from the same ``SyntheticLM``, f32 with TF32 off.  The loss, the MoE's
load-balance loss ``moe_aux`` and every gradient leaf agree at
``tests/test_torch_train_loss.py``'s tolerances (loss rtol 1e-5, leaves atol
1e-5 and rtol 1e-4), under remat "none" and "unit"; 1 and 4 microbatches
agree with the reference's ``_microbatched_grads``; the launcher trains both
smoke models with a falling loss.  On the CPU the WKV-6 gradient is
``wkv6_bwd_plain``'s, through ``_WKV6Fn``.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models.model import Model as JaxModel
from repro.train.step import _microbatched_grads as jax_microbatched_grads
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import ShardedPipeline, SyntheticLM
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.train.step import _microbatched_grads

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
ARCHS = ("rwkv6-7b", "olmoe-1b-7b")
N_LAYERS, B, S, CHUNK = 2, 4, 40, 20   # S = 40 crosses rwkv6's 16-token chunks into a ragged tail


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", params=ARCHS)
def arch_side(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_smoke_variant(JAX_ARCHS[arch]), n_layers=N_LAYERS)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    batch = ShardedPipeline(SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=S, period=16, vocab_eff=256),
                            global_batch=B).batch_at(0)
    return arch, jcfg, jparams, batch


def _tcfg(arch, **kw):
    return smoke_variant(get_config(arch)).replace(n_layers=N_LAYERS, **kw)


def _port_params(tcfg, jparams):
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    flat = convert.flatten(params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    return params, flat


def _assert_grads(got, want):
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert g.dtype == torch.float32, path
        np.testing.assert_allclose(g.numpy(), want[path], **GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("remat", ["none", "unit"])
def test_loss_aux_and_grads_match_jax(arch_side, remat):
    arch, jcfg, jparams, batch = arch_side
    jcfg = dataclasses.replace(jcfg, remat=remat)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: JaxModel(jcfg).train_loss(p, jbatch, loss_chunk=CHUNK), has_aux=True)(jparams)
    want = convert.flatten(jax.tree.map(np.asarray, jgrads))

    tcfg = _tcfg(arch, remat=remat)
    params, flat = _port_params(tcfg, jparams)
    loss, metrics = Model(tcfg, device="cpu").train_loss(params, batch, loss_chunk=CHUNK)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["moe_aux"].detach()), float(jmetrics["moe_aux"]), rtol=LOSS_RTOL,
                               atol=1e-12)
    assert (float(jmetrics["moe_aux"]) > 0) == (arch == "olmoe-1b-7b")
    _assert_grads(dict(zip(flat, grads)), want)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_microbatches_match_jax(arch_side, microbatches):
    """The step's mean loss and grads over 1 or 4 row slices, against the reference's; the metrics carry
    moe_aux only for one microbatch, as the reference's do."""
    arch, jcfg, jparams, batch = arch_side
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, jmetrics, jgrads = jax_microbatched_grads(JaxModel(jcfg), jparams, jbatch, microbatches, CHUNK)
    want = convert.flatten(jax.tree.map(np.asarray, jgrads))

    tcfg = _tcfg(arch)
    params, _ = _port_params(tcfg, jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = _microbatched_grads(Model(tcfg, device="cpu"), params, tbatch, microbatches, CHUNK)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL, atol=1e-12)
    _assert_grads(convert.flatten(grads), want)


def test_rwkv_training_runs_the_wkv6_function():
    """rwkv6's loss goes through _WKV6Fn once per layer, and twice under remat="unit" (recomputed)."""
    batch = ShardedPipeline(SyntheticLM(vocab_size=_tcfg("rwkv6-7b").vocab_size, seq_len=S, period=16,
                                        vocab_eff=256), global_batch=B).batch_at(0)
    calls = []
    real = wk._WKV6Fn.forward

    def counting(ctx, *args):
        calls.append(1)
        return real(ctx, *args)

    for remat, want in (("none", N_LAYERS), ("unit", 2 * N_LAYERS)):
        tcfg = _tcfg("rwkv6-7b", remat=remat)
        params = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
        flat = convert.flatten(params)
        for leaf in flat.values():
            leaf.requires_grad_(True)
        calls.clear()
        wk._WKV6Fn.forward = staticmethod(counting)
        try:
            loss, _ = Model(tcfg, device="cpu").train_loss(params, batch, loss_chunk=CHUNK)
            torch.autograd.grad(loss, list(flat.values()))
        finally:
            wk._WKV6Fn.forward = staticmethod(real)
        assert len(calls) == want, remat


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_smoke_model_on_the_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "6", "--seq-len", "32",
                                "--global-batch", "4", "--lr", "1e-2"])
    assert rc == 0
    result = json.loads(out.getvalue())
    assert result["final_step"] == 6 and result["device"] == "cpu"
    assert np.isfinite(result["last_loss"]) and result["last_loss"] < result["first_loss"]


@pytest.mark.parametrize("arch,n_layers,fits", [("rwkv6-7b", None, False), ("rwkv6-7b", 12, True),
                                                ("olmoe-1b-7b", None, False), ("olmoe-1b-7b", 6, True),
                                                ("gemma2-2b", None, True)])
def test_launcher_refuses_a_state_that_does_not_fit_the_card(arch, n_layers, fits):
    """16 bytes a parameter against an 80 GB card's free memory, before anything is drawn: rwkv6-7b
    (7.27 B parameters) and olmoe-1b-7b (6.92 B) only cut in depth, as chip_smoke.py trains them."""
    cfg = get_config(arch) if n_layers is None else get_config(arch).replace(n_layers=n_layers)
    if fits:
        launch_train.check_state_fits(cfg, 79_000_000_000)
    else:
        with pytest.raises(RuntimeError, match="build_trainer"):
            launch_train.check_state_fits(cfg, 79_000_000_000)

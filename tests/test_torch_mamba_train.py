"""Training of jamba's Mamba layers through the port, against ``Model.train_loss`` and ``jax.grad``.

The jamba-v0.1-52b smoke model (one 8-layer unit: seven Mamba-1 layers with
d_state 8 and ``ssm_chunk`` 16, one attention layer, a 4-expert top-2 MoE on
the odd layers; d_model 64), parameters moved from JAX through
``convert.params_from_jax``, batches from the same ``SyntheticLM``, f32 with
TF32 off.  S = 40 ends both the plain scan's 16-token chunks and the
training form's 16-token saved states in a ragged tail.  The loss, the MoE's
load-balance loss ``moe_aux`` and every gradient leaf agree at
``tests/test_torch_train_loss.py``'s tolerances (loss rtol 1e-5, leaves atol
1e-5 and rtol 1e-4) under remat "none" and "unit": JAX's oracle is computed
once, since JAX's remat does not change values.  On the CPU the scan's
gradient is ``mamba_scan_bwd_plain``'s, through ``_MambaScanFn``.  The port's
stateless ``mamba_layer`` is held to the reference's at 2e-3, as prefill is;
the launcher trains the smoke model and takes a cut of the pattern.  1 and 4
microbatches are in ``tests/test_torch_mamba_train_microbatches.py``, so that
the test workers split the JAX compile time.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import mamba as jax_mamba
from repro.models.model import Model as JaxModel
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import ShardedPipeline, SyntheticLM
from repro_torch.kernels import mamba_scan as ms
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models import mamba as port_mamba

ARCH = "jamba-v0.1-52b"
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
LAYER_TOL = dict(atol=2e-3, rtol=2e-3)   # the reference's prefill tolerance
B, S, CHUNK = 2, 40, 20


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_side():
    """The smoke model's JAX parameters, a batch, and jax.value_and_grad of train_loss on them: computed once."""
    jcfg = jax_smoke_variant(JAX_ARCHS[ARCH])
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    batch = ShardedPipeline(SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=S, period=16, vocab_eff=256),
                            global_batch=B).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JaxModel(jcfg).train_loss(p, jbatch, loss_chunk=CHUNK), has_aux=True)(jparams)
    want = dict(loss=float(loss), moe_aux=float(metrics["moe_aux"]),
                grads=convert.flatten(jax.tree.map(np.asarray, grads)))
    return jcfg, jparams, batch, want


def _port_params(tcfg, jparams):
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    flat = convert.flatten(params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    return params, flat


@pytest.mark.parametrize("remat", ["none", "unit"])
def test_loss_aux_and_grads_match_jax(jax_side, remat):
    _, jparams, batch, want = jax_side
    tcfg = smoke_variant(get_config(ARCH)).replace(remat=remat)
    params, flat = _port_params(tcfg, jparams)
    loss, metrics = Model(tcfg, device="cpu").train_loss(params, batch, loss_chunk=CHUNK)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["moe_aux"].detach()), want["moe_aux"], rtol=LOSS_RTOL, atol=1e-12)
    assert want["moe_aux"] > 0
    assert sorted(grads) == sorted(want["grads"])
    for path, g in grads.items():
        assert g.dtype == torch.float32, path
        np.testing.assert_allclose(g.numpy(), want["grads"][path], **GRAD_TOL, err_msg=path)
    # the Mamba leaves get a gradient through the scan: A_log only through dA, dt_bias through dΔ
    for leaf in ("A_log", "dt_bias", "x_proj/w", "conv_w"):
        paths = [p for p in grads if p.startswith("units/pos") and p.endswith(f"mixer/{leaf}")]
        assert len(paths) == 7 and all(grads[p].abs().sum() > 0 for p in paths), leaf


def test_training_runs_the_scan_function():
    """Each Mamba layer's scan goes through _MambaScanFn once, and twice under remat="unit" (recomputed);
    on the CPU its backward is mamba_scan_bwd_plain's, once per layer either way."""
    calls = {"forward": 0, "backward": 0}
    real_fwd, real_bwd = ms._MambaScanFn.forward, ms.mamba_scan_bwd_plain

    def counting_fwd(ctx, *args):
        calls["forward"] += 1
        return real_fwd(ctx, *args)

    def counting_bwd(*args):
        calls["backward"] += 1
        return real_bwd(*args)

    base = smoke_variant(get_config(ARCH))
    batch = ShardedPipeline(SyntheticLM(vocab_size=base.vocab_size, seq_len=S, period=16, vocab_eff=256),
                            global_batch=B).batch_at(0)
    for remat, want in (("none", 7), ("unit", 14)):
        tcfg = base.replace(remat=remat)
        params = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
        flat = convert.flatten(params)
        for leaf in flat.values():
            leaf.requires_grad_(True)
        calls.update(forward=0, backward=0)
        ms._MambaScanFn.forward, ms.mamba_scan_bwd_plain = staticmethod(counting_fwd), counting_bwd
        try:
            loss, _ = Model(tcfg, device="cpu").train_loss(params, batch, loss_chunk=CHUNK)
            torch.autograd.grad(loss, list(flat.values()))
        finally:
            ms._MambaScanFn.forward, ms.mamba_scan_bwd_plain = staticmethod(real_fwd), real_bwd
        assert calls == {"forward": want, "backward": 7}, remat


def test_mamba_layer_matches_reference(jax_side):
    """The stateless training forward of one Mamba layer (pattern position 0), port against reference."""
    jcfg, jparams, _, _ = jax_side
    tcfg = smoke_variant(get_config(ARCH))
    jlayer = jax.tree.map(lambda a: np.asarray(a)[0], jparams["units"]["pos0"]["mixer"])
    tlayer = convert.unflatten({p: torch.from_numpy(np.array(a)) for p, a in convert.flatten(jlayer).items()})
    x = np.random.default_rng(3).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    want = jax_mamba.mamba_layer(jax.tree.map(jnp.asarray, jlayer), jnp.asarray(x), jcfg, dtype=jnp.float32)
    got = port_mamba.mamba_layer(tlayer, torch.from_numpy(x), tcfg, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    prefill, _, _ = port_mamba.mamba_layer_with_state(tlayer, torch.from_numpy(x), tcfg, dtype=torch.float32)
    assert torch.equal(got, prefill)  # the same function as the prefill's output


def test_launcher_trains_the_smoke_model_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6", "--seq-len", "32",
                                "--global-batch", "4", "--lr", "1e-2"])
    assert rc == 0
    result = json.loads(out.getvalue())
    assert result["final_step"] == 6 and result["device"] == "cpu"
    assert np.isfinite(result["last_loss"]) and result["last_loss"] < result["first_loss"]


def test_launcher_cuts_the_pattern():
    """``n_layers`` as pattern positions keeps one unit of those layers, every width kept: jamba's (1, 4) is
    a Mamba + MoE layer and the attention layer, as chip_smoke.py trains it; an int still cuts the depth."""
    full = get_config(ARCH)
    cut = launch_train.cut_config(full, (1, 4))
    assert cut == full.replace(n_layers=2, pattern=(full.pattern[1], full.pattern[4]))
    assert [(s.mixer, s.ffn) for s in cut.pattern] == [("mamba", "moe"), ("attn", "dense")]
    assert launch_train.cut_config(full, 16) == full.replace(n_layers=16)
    with pytest.raises(ValueError, match="pattern positions"):
        launch_train.cut_config(full, (8,))
    trainer = launch_train.build_trainer(ARCH, smoke=True, n_layers=(0, 4), device="cpu", seq_len=16,
                                         global_batch=2)
    small = smoke_variant(full)
    assert trainer.model.cfg == small.replace(n_layers=2, pattern=(small.pattern[0], small.pattern[4]))
    assert sorted(trainer.state["params"]["units"]) == ["pos0", "pos1"]
    assert trainer.run(2)["final_step"] == 2

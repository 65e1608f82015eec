"""The port's train step, loop and launcher against ``repro.train`` and ``repro.launch.train``.

gemma2-2b's smoke variant in f32 on the CPU.  1 and 4 microbatches agree
(``tests/test_train.py:28-43``: loss rtol 1e-5, params atol 1e-5 rtol 1e-4);
three steps of the port's ``build_train_step`` follow the reference's run on a
``(1,)`` data mesh from the same initial parameters and batches, losses at
rtol 1e-4; the launcher trains the smoke model with a falling loss and
refuses what is not ported yet.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models.model import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train.step import build_train_step as jax_build_train_step
from repro.train.step import init_state as jax_init_state
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import ShardedPipeline, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import FaultInjector, Trainer, TrainerConfig, build_train_step, init_state

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pipe(vocab, B=4, S=32):
    return ShardedPipeline(SyntheticLM(vocab_size=vocab, seq_len=S, period=16, vocab_eff=256), global_batch=B)


def _port_state(model, opt, params):
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return {"params": params, "opt_state": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}


def _batch(np_batch):
    return {k: torch.from_numpy(v) for k, v in np_batch.items()}


def test_microbatch_equivalence():
    """1 microbatch == 4 microbatches (same grads, to fp tolerance)."""
    cfg = smoke_variant(get_config("gemma2-2b"))
    model, opt = Model(cfg, device="cpu"), AdamW(AdamWConfig(**OPT))
    state1 = init_state(model, opt, torch.Generator().manual_seed(0))
    state4 = init_state(model, opt, torch.Generator().manual_seed(0))
    batch = _batch(_pipe(cfg.vocab_size).batch_at(0))
    state1, m1 = build_train_step(model, opt, microbatches=1, loss_chunk=16)(state1, batch)
    state4, m4 = build_train_step(model, opt, microbatches=4, loss_chunk=16)(state4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m4["grad_norm"]), rtol=1e-4)
    assert int(state1["step"]) == int(state4["step"]) == 1
    for a, b in zip(tree_leaves(state1["params"]), tree_leaves(state4["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5, rtol=1e-4)


def test_three_steps_follow_the_reference():
    jcfg = jax_smoke_variant(JAX_ARCHS["gemma2-2b"])
    jmodel, jopt = JaxModel(jcfg), JaxAdamW(JaxAdamWConfig(**OPT))
    jstate = jax_init_state(jmodel, jopt, jax.random.PRNGKey(0))
    cfg = smoke_variant(get_config("gemma2-2b"))
    model, opt = Model(cfg, device="cpu"), AdamW(AdamWConfig(**OPT))
    state = _port_state(model, opt, convert.params_from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg, "cpu"))
    mesh = jax.make_mesh((1,), ("data",))
    jstep = jax_build_train_step(jmodel, jopt, mesh, microbatches=1, loss_chunk=16)
    step = build_train_step(model, opt, microbatches=1, loss_chunk=16)
    pipe = _pipe(cfg.vocab_size)
    for i in range(3):
        np_batch = pipe.batch_at(i)
        with set_mesh(mesh):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in np_batch.items()})
        state, m = step(state, _batch(np_batch))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=f"step {i} {key}")
    assert int(state["step"]) == int(jstate["step"]) == 3


def _launch(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(argv)
    return rc, out.getvalue()


def test_launcher_trains_the_smoke_model_on_the_cpu():
    rc, out = _launch(["--arch", "gemma2-2b", "--smoke", "--device", "cpu", "--steps", "8", "--seq-len", "32",
                       "--global-batch", "4"])
    assert rc == 0
    result = json.loads(out)
    assert result["final_step"] == 8 and result["restarts"] == 0 and result["device"] == "cpu"
    assert result["max_memory_allocated_bytes"] is None
    assert np.isfinite(result["last_loss"]) and result["last_loss"] < result["first_loss"]


@pytest.mark.parametrize("argv,item", [(["--ckpt-every", "1"], "item 3e"), (["--cross-pod", "manual"], "item 6")])
def test_launcher_refuses_what_is_not_ported(argv, item, capsys):
    rc = launch_train.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu", "--steps", "1", *argv])
    assert rc != 0
    assert item in capsys.readouterr().err


def test_step_refuses_cross_pod_modes():
    cfg = smoke_variant(get_config("gemma2-2b"))
    model, opt = Model(cfg, device="cpu"), AdamW(AdamWConfig(**OPT))
    for mode in ("manual", "compressed"):
        with pytest.raises(NotImplementedError, match="item 6"):
            build_train_step(model, opt, cross_pod=mode)
    with pytest.raises(ValueError):
        build_train_step(model, opt, cross_pod="bogus")


def test_trainer_without_checkpoints_reraises_a_fault():
    cfg = smoke_variant(get_config("gemma2-2b"))
    model, opt = Model(cfg, device="cpu"), AdamW(AdamWConfig(**OPT))
    faults = FaultInjector(fail_at=[2])
    trainer = Trainer(model, opt, _pipe(cfg.vocab_size, B=2, S=16), TrainerConfig(loss_chunk=16), fault_hook=faults)
    with pytest.raises(RuntimeError, match="injected node failure at step 2"):
        trainer.run(4)
    assert faults.fired == [2] and trainer.current_step() == 2 and len(trainer.metrics_log) == 2
    with pytest.raises(NotImplementedError, match="item 3e"):
        Trainer(model, opt, _pipe(cfg.vocab_size), ckpt=object())

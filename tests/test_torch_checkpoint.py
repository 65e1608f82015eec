"""The port's checkpoint/restart through SCISPACE against ``repro.train.checkpoint`` and ``repro.train.trainer``.

gemma2-2b's smoke variant in f32 on the CPU, TF32 off.  For the same state
the port's shard files are byte-identical to the reference
``CheckpointManager``'s at 1, 2 and 4 shards; restoring them gives JAX's
state exactly, and the next step's loss matches JAX's at rtol 1e-5
(``tests/test_train.py:41``).  Saved steps are found by an SDS search in
both modes.  A Trainer that fails at step 6 and restores step 4 ends equal
to an uninterrupted run; this is the property of the reference's own restart
test, which fails inside the meshed JAX trainer, so it is asserted in torch.
Only a ``NodeFailure`` is answered with a restore.
"""

import contextlib
import io
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import Collaboration as JaxCollaboration
from repro.models.model import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import CheckpointManager as JaxCheckpointManager
from repro.train.step import build_train_step as jax_build_train_step
from repro.train.step import init_state as jax_init_state
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import Collaboration
from repro_torch.data import ShardedPipeline, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import (CheckpointManager, FaultInjector, NodeFailure, Trainer, TrainerConfig,
                               build_train_step, init_state)

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)
LOSS_RTOL = 1e-5  # tests/test_train.py:41
SAVE_KEYS = {"bytes", "pack_s", "write_s", "publish_s", "total_s", "meu_rpcs"}  # the reference's save accounting


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture()
def port_collab():
    """Two in-memory data centers × two DTNs each, as ``tests/conftest.py::collab``, from the port's core."""
    c = Collaboration()
    c.add_datacenter("dc0", n_dtns=2)
    c.add_datacenter("dc1", n_dtns=2)
    yield c
    c.close()


def _pipe(vocab, B=4, S=32):
    return ShardedPipeline(SyntheticLM(vocab_size=vocab, seq_len=S, period=16, vocab_eff=256), global_batch=B)


def _smoke():
    cfg = smoke_variant(get_config("gemma2-2b"))
    return cfg, Model(cfg, device="cpu"), AdamW(AdamWConfig(**OPT))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _state_from_host(host, cfg):
    """The port's train state holding a JAX host state's values."""
    params = convert.params_from_jax(host["params"], cfg, "cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    moments = lambda tree: {k: moments(v) if isinstance(v, dict) else _tensor(v) for k, v in tree.items()}
    opt = host["opt_state"]
    return {"params": params, "opt_state": {"mu": moments(opt["mu"]), "nu": moments(opt["nu"]),
                                            "count": _tensor(opt["count"])}, "step": _tensor(host["step"])}


def _shard_path(run, step, shard):
    return f"/ckpt/{run}/step{step:08d}/shard{shard}.sci"


@pytest.fixture(scope="module")
def jax_run():
    """JAX: init from PRNGKey(1), one step on a 1-device mesh, the reference's shard files of that state at
    1, 2 and 4 shards, and the loss of the step after it."""
    cfg = jax_smoke_variant(JAX_ARCHS["gemma2-2b"])
    model, opt = JaxModel(cfg), JaxAdamW(JaxAdamWConfig(**OPT))
    state = jax_init_state(model, opt, jax.random.PRNGKey(1))
    mesh = jax.make_mesh((1,), ("data",))
    step = jax_build_train_step(model, opt, mesh, microbatches=1, loss_chunk=16)
    pipe = _pipe(cfg.vocab_size)
    batch = lambda i: {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
    with set_mesh(mesh):
        state, _ = step(state, batch(0))
        host = jax.tree.map(np.asarray, state)
        _, metrics = step(state, batch(1))
    collab = JaxCollaboration()
    collab.add_datacenter("dc0", n_dtns=2)
    try:
        files = {}
        for n in (1, 2, 4):
            JaxCheckpointManager(collab, run=f"rt{n}", home_dc="dc0", n_shards=n).save(host, 1)
            files[n] = [collab.dc("dc0").backend.read(_shard_path(f"rt{n}", 1, s)) for s in range(n)]
    finally:
        collab.close()
    return SimpleNamespace(host=host, files=files, next_loss=float(metrics["loss"]), pipe=pipe)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_files_are_the_references_bytes(jax_run, port_collab, n_shards):
    cfg, _, _ = _smoke()
    mgr = CheckpointManager(port_collab, run=f"rt{n_shards}", home_dc="dc0", n_shards=n_shards)
    report = mgr.save(_state_from_host(jax_run.host, cfg), 1)
    got = [port_collab.dc("dc0").backend.read(_shard_path(f"rt{n_shards}", 1, s)) for s in range(n_shards)]
    assert [len(b) for b in got] == [len(b) for b in jax_run.files[n_shards]]
    for s, (a, b) in enumerate(zip(got, jax_run.files[n_shards])):
        assert a == b, f"shard {s} of {n_shards} differs from the reference's"
    assert report["bytes"] == sum(len(b) for b in got) and report["meu_rpcs"] > 0
    assert set(report) == SAVE_KEYS


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_restore_is_the_jax_state_and_the_next_step_follows_jax(jax_run, port_collab, n_shards):
    cfg, model, opt = _smoke()
    mgr = CheckpointManager(port_collab, run="next", home_dc="dc0", n_shards=n_shards)
    mgr.save(_state_from_host(jax_run.host, cfg), 1)
    like = init_state(model, opt, torch.Generator().manual_seed(5))
    state = mgr.restore(like)
    jflat = jax.tree_util.tree_flatten_with_path(jax_run.host)[0]
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in jflat}
    got = convert.flatten(state)
    assert list(got) == list(want)  # JAX's leaf order
    for path, leaf in got.items():
        assert leaf.device.type == "cpu" and leaf.dtype == convert.flatten(like)[path].dtype
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    for leaf in tree_leaves(state["params"]):
        leaf.requires_grad_(True)
    step = build_train_step(model, opt, microbatches=1, loss_chunk=16)
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in jax_run.pipe.batch_at(1).items()})
    np.testing.assert_allclose(float(metrics["loss"]), jax_run.next_loss, rtol=LOSS_RTOL)
    assert int(state["step"]) == 2


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("mode", ["native", "workspace"])
def test_checkpoint_roundtrip_and_discovery(port_collab, mode, n_shards):
    """tests/test_train.py:87-101 in torch, in both write modes."""
    _, model, opt = _smoke()
    state = init_state(model, opt, torch.Generator().manual_seed(1))
    mgr = CheckpointManager(port_collab, run=f"rt{mode}{n_shards}", home_dc="dc0", mode=mode, n_shards=n_shards)
    mgr.save(state, 7)
    mgr.save(state, 12)
    assert mgr.list_steps() == [7, 12] and mgr.latest_step() == 12
    for step in (None, 7):
        out = mgr.restore(state, step)
        for (pa, a), (pb, b) in zip(convert.flatten(state).items(), convert.flatten(out).items()):
            assert pa == pb
            np.testing.assert_array_equal(a.detach().numpy(), b.numpy(), err_msg=pa)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(port_collab, run="none-yet", home_dc="dc0").restore(state)


def test_save_refuses_a_leaf_it_cannot_read_back(port_collab):
    mgr = CheckpointManager(port_collab, run="bf16", home_dc="dc0")
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save({"params": {"w": torch.zeros(4, dtype=torch.bfloat16)}, "step": torch.zeros((), dtype=torch.int32)}, 1)


def _trainer(model, opt, cfg, **kw):
    return Trainer(model, opt, _pipe(cfg.vocab_size, B=2, S=16), TrainerConfig(loss_chunk=16, **kw.pop("tcfg", {})),
                   seed=3, **kw)


@pytest.mark.parametrize("fail_at,restored", [(6, 4), (2, 0)])
def test_restart_equals_the_uninterrupted_run(port_collab, fail_at, restored):
    """Fail at step 6, restore step 4 and replay; fail at step 2, before any checkpoint, and start again from
    the trainer's seed: either way the run ends equal to one that never failed."""
    cfg, model, opt = _smoke()
    clean = _trainer(model, opt, cfg)
    clean_result = clean.run(10)
    ckpt = CheckpointManager(port_collab, run=f"replay{fail_at}", home_dc="dc0")
    faults = FaultInjector(fail_at=[fail_at])
    trainer = _trainer(model, opt, cfg, tcfg=dict(ckpt_every=4), ckpt=ckpt, fault_hook=faults)
    live = [id(t) for t in tree_leaves(trainer.state)]
    result = trainer.run(10)
    assert faults.fired == [fail_at] and result["restarts"] == 1
    assert result["final_step"] == clean_result["final_step"] == 10
    np.testing.assert_allclose(result["final_loss"], clean_result["final_loss"], rtol=LOSS_RTOL)
    events = [m for m in trainer.metrics_log if "event" in m]
    assert len(events) == 1 and events[0].pop("restore_s") > 0
    assert events == [{"step": restored, "event": f"restart(injected node failure at step {fail_at})",
                       "restored_step": restored or None}]
    assert ckpt.list_steps() == [4, 8]
    saves = [(m["step"], m["ckpt"]) for m in trainer.metrics_log if "ckpt" in m]
    assert [step for step, _ in saves] == [4, 8]
    assert all(set(report) == SAVE_KEYS and report["bytes"] > 0 for _, report in saves)
    # restored in place: the same tensors, the parameters still autograd leaves
    assert [id(t) for t in tree_leaves({k: trainer.state[k] for k in ("params", "opt_state")})] == live[:-1]
    assert all(p.requires_grad and p.is_leaf for p in tree_leaves(trainer.state["params"]))
    for (path, a), (_, b) in zip(convert.flatten(trainer.state).items(), convert.flatten(clean.state).items()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy(), err_msg=path)
    replayed = [m["loss"] for m in trainer.metrics_log if "loss" in m][fail_at:]
    np.testing.assert_allclose(replayed, [m["loss"] for m in clean.metrics_log][restored:], rtol=LOSS_RTOL)


def test_only_a_node_failure_is_restored(port_collab):
    """A RuntimeError from the step itself (a failed launch, a CUDA error, out of memory) propagates."""
    cfg, model, opt = _smoke()
    trainer = _trainer(model, opt, cfg, tcfg=dict(ckpt_every=1), ckpt=CheckpointManager(port_collab, run="fault",
                                                                                         home_dc="dc0"))
    step_fn = trainer.step_fn

    def failing(state, batch):
        if int(state["step"]) == 2:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return step_fn(state, batch)

    trainer.step_fn = failing
    with pytest.raises(RuntimeError, match="illegal memory access") as info:
        trainer.run(4)
    assert not isinstance(info.value, NodeFailure) and issubclass(NodeFailure, RuntimeError)
    assert trainer.current_step() == 2 and not any("event" in m for m in trainer.metrics_log)
    assert trainer.ckpt.list_steps() == [1, 2]


def test_launcher_checkpoints_and_finds_its_steps():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu", "--steps", "4", "--seq-len", "32",
                                "--global-batch", "4", "--ckpt-every", "2", "--run", "launch"])
    assert rc == 0
    result = json.loads(out.getvalue())
    assert result["ckpt_steps_discovered_via_sds"] == [2, 4] and result["final_step"] == 4
    assert result["restarts"] == 0 and len(result["step_ms"]) == 4
    assert [save["step"] for save in result["ckpt_saves"]] == [2, 4]
    assert all(set(save) == SAVE_KEYS | {"step"} for save in result["ckpt_saves"])

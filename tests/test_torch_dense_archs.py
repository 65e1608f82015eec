"""The four archs with an untied output head against the JAX reference on the CPU.

codeqwen1.5-7b (QKV biases, SwiGLU, RoPE base 1e6), stablelm-3b (LayerNorm,
partial RoPE, head_dim 80), nemotron-4-15b (squared ReLU, GQA 48/8) and
olmoe-1b-7b (q/k RMSNorm, 64 experts top-8).  JAX parameters move across
through ``convert.params_from_jax``, ``lm_head`` as a leaf of its own; inputs
are drawn from numpy seeds.  Tolerances are the reference's: logits 2e-3
(``tests/test_models_smoke.py``), the loss rtol 1e-5 and the microbatch
equivalence atol 1e-5 / rtol 1e-4 (``tests/test_train.py:28-43``), each
gradient leaf atol 1e-5 / rtol 1e-4 (as ``tests/test_torch_train_loss.py``
holds gemma2's).  The serving launcher's weights in the compute dtype are
held bitwise to the f32 masters cast at use.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import Collaboration as JaxCollaboration
from repro.models.model import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import CheckpointManager as JaxCheckpointManager
from repro.train.step import init_state as jax_init_state
from repro_torch import convert
from repro_torch.configs import ARCHS, ModelConfig, get_config, smoke_variant
from repro_torch.core import Collaboration
from repro_torch.data import ShardedPipeline, SyntheticLM
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models import transformer as TT
from repro_torch.models.layers import cast_for_compute
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import CheckpointManager, build_train_step, init_state

UNTIED = ["codeqwen1.5-7b", "stablelm-3b", "nemotron-4-15b", "olmoe-1b-7b"]
DENSE = UNTIED[:3]  # olmoe trains in tests/test_torch_ssm_moe_train.py, with its MoE
# parameters by JAX eval_shape of Model.init, lm_head included
PARAM_COUNTS = {"codeqwen1.5-7b": 8_190_038_016, "stablelm-3b": 2_795_688_960,
                "nemotron-4-15b": 15_628_775_424, "olmoe-1b-7b": 6_919_100_416}
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)
MAX_LEN = 32
B, S, CHUNK = 2, 32, 16


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX model, JAX params, port model, port params) of the arch's smoke variant, from PRNGKey(0)."""
    jmodel = JaxModel(jax_smoke_variant(JAX_ARCHS[arch]))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = smoke_variant(get_config(arch))
    return jmodel, jparams, Model(tcfg, device="cpu"), convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                                                              tcfg, "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tokens(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, n))


def _jax_paths(arch):
    """{path: shape} of the reference's full-width parameters (eval_shape, nothing allocated)."""
    flat = jax.tree_util.tree_flatten_with_path(JaxModel(JAX_ARCHS[arch]).init_abstract())[0]
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape) for path, leaf in flat}


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", UNTIED)
def test_config_fields_match_reference(arch, variant):
    jcfg, tcfg = JAX_ARCHS[arch], get_config(arch)
    if variant == "smoke":
        jcfg, tcfg = jax_smoke_variant(jcfg), smoke_variant(tcfg)
    assert tcfg.tie_embeddings is False
    for f in dataclasses.fields(ModelConfig):
        if f.name == "pattern":
            assert [(s.mixer, s.ffn) for s in tcfg.pattern] == [(s.mixer, s.ffn) for s in jcfg.pattern]
        else:
            got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(want):  # the spec classes are each package's own
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, f.name


@pytest.mark.parametrize("arch", UNTIED)
def test_full_width_param_layout_and_count_match_reference(arch):
    """Leaf paths and shapes equal JAX eval_shape's, ``lm_head/table`` among them; the counts are
    PARAM_COUNTS; the served weights take 2 bytes per parameter cast at use and 4 for the rest."""
    jshapes = _jax_paths(arch)
    tparams = TT.init_lm(get_config(arch), None, "meta")
    tshapes = {p: tuple(t.shape) for p, t in convert.flatten(tparams).items()}
    assert list(tshapes.items()) == list(jshapes.items())  # JAX's leaf order: lm_head between final_norm and units
    cfg = get_config(arch)
    assert jshapes["lm_head/table"] == jshapes["embed/table"] == (cfg.vocab_size, cfg.d_model)
    n = TT.count_params(tparams)
    assert n == sum(int(np.prod(s)) for s in jshapes.values()) == PARAM_COUNTS[arch]
    cast = sum(int(np.prod(s)) for p, s in jshapes.items()
               if p.split("/")[-1] in ("w", "b", "table") and "router" not in p.split("/"))
    assert launch_serve.weight_bytes(cfg) == 2 * cast + 4 * (n - cast)


def test_launcher_counts_the_draws_f32_leaf():
    """The launcher refuses by the draw's peak, not by what it holds after: nemotron-4-15b's largest leaf
    ([32, 6144, 24576], relu2's wi_up and wo) is drawn in f32 on top of the bf16 weights.  With room for
    the weights alone it refuses; with room for the peak it goes on."""
    cfg = get_config("nemotron-4-15b")
    held = launch_serve.weight_bytes(cfg)
    n_leaves = len(convert.flatten(TT.init_lm(cfg, None, "meta")))
    slack = launch_serve.draw_peak_bytes(cfg) - (held + 4 * 32 * 6144 * 24576)
    assert 0 < slack <= (n_leaves + 1) * (2 << 20)  # the allocator's rounding, at most 512 B + 1 MiB a tensor
    with pytest.raises(RuntimeError, match=r"needs 50\.6 GB to draw its weights \(31\.3 GB held in bfloat16\)"):
        launch_serve.check_fits(cfg, held + 1)
    launch_serve.check_fits(cfg, launch_serve.draw_peak_bytes(cfg))


@pytest.mark.parametrize("arch", UNTIED)
def test_smoke_prefill_and_decode_match_jax(arch):
    """A 12-token prefill's logits and 4 teacher-forced decode steps within 2e-3."""
    jmodel, jparams, tmodel, tparams = _pair(arch)
    P, steps = 12, 4
    seq = _tokens(P + steps, seed=1)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(seq[:, :P], jnp.int32)}, max_len=MAX_LEN)
    tcache, tlogits = tmodel.prefill(tparams, {"tokens": seq[:, :P]}, max_len=MAX_LEN)
    assert tlogits.shape == (1, 1, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **LOGIT_TOL)
    for t in range(steps):
        tok = seq[:, P + t:P + t + 1]
        jcache, jlogits = jmodel.decode_step(jparams, jcache, jnp.asarray(tok, jnp.int32), jnp.int32(P + t))
        tcache, tlogits = tmodel.decode_step(tparams, tcache, tok, P + t)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **LOGIT_TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", UNTIED)
def test_serve_engine_greedy_tokens_match_jax(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, size=n) for n in (5, 9, 12)]
    max_new = 5
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=MAX_LEN, slots=2, eos_token=-1))
    jreqs = [jeng.submit(p, max_new) for p in prompts]
    jeng.run_until_drained(jreqs)
    teng = ServeEngine(tmodel, tparams, ServeConfig(max_len=MAX_LEN, slots=2, eos_token=-1), device="cpu")
    treqs = [teng.submit(p, max_new) for p in prompts]
    teng.run_until_drained(treqs)
    assert all(r.done for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]


@pytest.mark.parametrize("arch", UNTIED)
def test_launcher_runs_on_cpu(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4", "--slots", "2"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["tokens"] == 12 and stats["device"] == "cpu"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_compute_weights_are_the_masters_cast_at_use(arch):
    """``init(..., compute_weights=True)`` stores each leaf as ``cast_for_compute`` casts the f32 master:
    bitwise, leaf by leaf, with bf16 compute (the smoke variant, and the full width's dtypes on meta)."""
    cfg = smoke_variant(get_config(arch)).replace(dtype="bfloat16")
    model = Model(cfg, device="cpu")
    want = convert.flatten(cast_for_compute(model.init(torch.Generator().manual_seed(3)), torch.bfloat16))
    got = convert.flatten(model.init(torch.Generator().manual_seed(3), compute_weights=True))
    assert list(got) == list(want)
    for path, leaf in got.items():
        assert leaf.dtype == want[path].dtype and torch.equal(leaf, want[path]), path
    full = get_config(arch)
    meta = convert.flatten(cast_for_compute(TT.init_lm(full, None, "meta"), torch.bfloat16))
    lean = convert.flatten(TT.init_lm(full, None, "meta", compute_weights=True))
    assert {p: (t.dtype, t.shape) for p, t in lean.items()} == {p: (t.dtype, t.shape) for p, t in meta.items()}


@pytest.mark.parametrize("arch", UNTIED)
def test_compute_weights_give_bitwise_the_logits_of_cast_masters(arch):
    """bf16 on the CPU: prefill and a decode step served from the launcher's compute-dtype weights equal,
    bit for bit, those of f32 master weights that every use casts."""
    cfg = smoke_variant(get_config(arch)).replace(dtype="bfloat16")
    model = Model(cfg, device="cpu")
    masters = model.init(torch.Generator().manual_seed(4))
    lean = model.init(torch.Generator().manual_seed(4), compute_weights=True)
    seq = _tokens(10, seed=5)
    out = {}
    for name, params in (("masters", masters), ("lean", lean)):
        cache, first = model.prefill(params, {"tokens": seq[:, :9]}, max_len=MAX_LEN)
        _, second = model.decode_step(params, cache, seq[:, 9:], 9)
        out[name] = (first, second)
    for a, b in zip(out["masters"], out["lean"]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# training: the three dense archs
# ---------------------------------------------------------------------------


def _batch(vocab, seq_len=S, global_batch=B):
    pipe = ShardedPipeline(SyntheticLM(vocab_size=vocab, seq_len=seq_len, period=16, vocab_eff=256),
                           global_batch=global_batch)
    return pipe.batch_at(0)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch):
    """Model.train_loss and jax.grad: the loss at rtol 1e-5 and every gradient leaf, ``lm_head`` and
    ``embed`` apart, at atol 1e-5 / rtol 1e-4."""
    jmodel, jparams, tmodel, _ = _pair(arch)
    batch = _batch(jmodel.cfg.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), jgrads = jax.value_and_grad(lambda p: jmodel.train_loss(p, jbatch, loss_chunk=CHUNK),
                                                has_aux=True)(jparams)
    want = convert.flatten(jax.tree.map(np.asarray, jgrads))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tmodel.cfg, "cpu")
    flat = convert.flatten(params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    loss, _ = tmodel.train_loss(params, batch, loss_chunk=CHUNK)
    got = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    assert sorted(got) == sorted(want) and "lm_head/table" in got
    assert not np.allclose(got["lm_head/table"].numpy(), got["embed/table"].numpy())
    for path, g in got.items():
        assert g.dtype == torch.float32, path
        np.testing.assert_allclose(g.numpy(), want[path], **GRAD_TOL, err_msg=path)


def test_microbatch_equivalence_on_codeqwen():
    """tests/test_train.py:28-43 in torch on the reference's own arch: 1 microbatch == 4."""
    cfg = smoke_variant(get_config("codeqwen1.5-7b"))
    model, opt = Model(cfg, device="cpu"), AdamW(AdamWConfig(**OPT))
    state1 = init_state(model, opt, torch.Generator().manual_seed(0))
    state4 = init_state(model, opt, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, global_batch=4).items()}
    state1, m1 = build_train_step(model, opt, microbatches=1, loss_chunk=16)(state1, batch)
    state4, m4 = build_train_step(model, opt, microbatches=4, loss_chunk=16)(state4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    assert "lm_head" in state1["params"] and "lm_head" in state1["opt_state"]["mu"]
    for a, b in zip(tree_leaves(state1["params"]), tree_leaves(state4["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_train_launcher_trains_the_smoke_model_on_the_cpu(arch, capsys):
    """Through the training launcher, with a SCISPACE checkpoint of the state that holds ``lm_head``."""
    assert launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "6", "--seq-len", "32",
                              "--global-batch", "4", "--ckpt-every", "3"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert result["final_step"] == 6 and result["ckpt_steps_discovered_via_sds"] == [3, 6]
    assert np.isfinite(result["last_loss"]) and result["last_loss"] < result["first_loss"]


def _state_from_host(host, cfg):
    """The port's train state holding a JAX host state's values."""
    params = convert.params_from_jax(host["params"], cfg, "cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    moments = lambda tree: {k: moments(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
                            for k, v in tree.items()}
    opt = host["opt_state"]
    return {"params": params, "opt_state": {"mu": moments(opt["mu"]), "nu": moments(opt["nu"]),
                                            "count": torch.from_numpy(np.array(opt["count"]))},
            "step": torch.from_numpy(np.array(host["step"]))}


@pytest.mark.parametrize("n_shards", [1, 2])
def test_codeqwen_checkpoint_is_the_references_bytes(n_shards):
    """The same state (``lm_head`` and its AdamW moments included) gives shard files byte-identical to
    the reference CheckpointManager's."""
    cfg = jax_smoke_variant(JAX_ARCHS["codeqwen1.5-7b"])
    host = jax.tree.map(np.asarray, jax_init_state(JaxModel(cfg), JaxAdamW(JaxAdamWConfig(**OPT)),
                                                   jax.random.PRNGKey(1)))
    path = lambda s: f"/ckpt/cq{n_shards}/step{1:08d}/shard{s}.sci"
    files = {}
    for name, collab_cls, mgr_cls, state in (
            ("jax", JaxCollaboration, JaxCheckpointManager, host),
            ("port", Collaboration, CheckpointManager,
             _state_from_host(host, smoke_variant(get_config("codeqwen1.5-7b"))))):
        collab = collab_cls()
        try:
            collab.add_datacenter("dc0", n_dtns=2)
            mgr_cls(collab, run=f"cq{n_shards}", home_dc="dc0", n_shards=n_shards).save(state, 1)
            files[name] = [collab.dc("dc0").backend.read(path(s)) for s in range(n_shards)]
        finally:
            collab.close()
    assert any(b"lm_head" in f for f in files["jax"])
    for s, (a, b) in enumerate(zip(files["port"], files["jax"])):
        assert a == b, f"shard {s} of {n_shards} differs from the reference's"

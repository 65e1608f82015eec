"""The port's serving slice (gemma2-2b smoke variant) against the JAX reference on the CPU.

JAX parameters move across through ``repro_torch.convert.params_from_jax``;
logits are held at the reference's own tolerance, 2e-3
(``tests/test_models_smoke.py``), and greedy tokens must be equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import transformer as JT
from repro.models.model import Model as JaxModel
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import ModelConfig, get_config, smoke_variant
from repro_torch.configs.base import LayerSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeConfig, ServeEngine

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_LEN = 64  # > window 16: the local layers get ring caches


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) of the gemma2-2b smoke variant."""
    jcfg = jax_smoke_variant(JAX_ARCHS["gemma2-2b"])
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = smoke_variant(get_config("gemma2-2b"))
    tmodel = Model(tcfg, device="cpu")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jmodel, jparams, tmodel, tparams


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, n))


def _jax_forward_logits(jmodel, jparams, tokens):
    """The reference's full-sequence forward (no cache) at the last position."""
    hidden, _ = JT.lm_hidden(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, jmodel.cfg)
    return JT._logits(jparams, hidden[:, -1:, :], jmodel.cfg)


@pytest.mark.parametrize("arch_fn", [lambda c: c, jax_smoke_variant], ids=["full", "smoke"])
def test_config_fields_match_reference(arch_fn):
    jcfg = arch_fn(JAX_ARCHS["gemma2-2b"])
    tcfg = get_config("gemma2-2b") if arch_fn is not jax_smoke_variant else smoke_variant(get_config("gemma2-2b"))
    for f in dataclasses.fields(ModelConfig):
        if f.name == "pattern":
            assert [(s.mixer, s.ffn) for s in tcfg.pattern] == [(s.mixer, s.ffn) for s in jcfg.pattern]
        else:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_full_width_param_layout_matches_reference():
    """Same leaf paths and shapes as the JAX init at full width (no allocation)."""
    tcfg = get_config("gemma2-2b")
    jshapes = {
        "/".join(str(k.key) for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(JaxModel(JAX_ARCHS["gemma2-2b"]).init_abstract())[0]
    }
    tparams = TT.init_lm(tcfg, None, "meta")
    tshapes = {p: tuple(t.shape) for p, t in convert.flatten(tparams).items()}
    assert tshapes == jshapes
    n = TT.count_params(tparams)
    assert n == sum(int(np.prod(s)) for s in jshapes.values())
    assert 2.05e9 < n < 2.07e9


def test_init_distributions():
    cfg = smoke_variant(get_config("gemma2-2b")).replace(d_model=256, d_ff=512, vocab_size=4096)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    units = params["units"]["pos0"]
    assert units["mixer"]["wq"]["w"].shape == (cfg.n_units, cfg.d_model, H, hd)
    np.testing.assert_allclose(units["mixer"]["wq"]["w"].std().item(), cfg.d_model ** -0.5, rtol=0.05)
    np.testing.assert_allclose(units["ffn"]["wo"]["w"].std().item(), cfg.d_ff ** -0.5, rtol=0.05)
    np.testing.assert_allclose(units["mixer"]["wo"]["w"].std().item(), (H * hd) ** -0.5, rtol=0.05)
    np.testing.assert_allclose(params["embed"]["table"].std().item(), 0.02, rtol=0.05)
    assert torch.equal(units["norm1"]["scale"], torch.ones_like(units["norm1"]["scale"]))
    assert all(t.dtype == torch.float32 for t in convert.flatten(params).values())


def test_params_from_jax_rejects_a_foreign_tree(pair):
    _, jparams, tmodel, _ = pair
    tree = jax.tree.map(np.asarray, jparams)
    del tree["units"]["pos1"]["norm2_post"]
    with pytest.raises(KeyError, match="norm2_post"):
        convert.params_from_jax(tree, tmodel.cfg, "cpu")


@pytest.mark.parametrize("S", [12, 20])
def test_prefill_matches_jax(pair, S):
    jmodel, jparams, tmodel, tparams = pair
    tokens = _tokens(S)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, max_len=MAX_LEN)
    tcache, tlogits = tmodel.prefill(tparams, {"tokens": tokens}, max_len=MAX_LEN)
    assert tlogits.shape == (1, 1, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
    for path, jleaf in convert.flatten(jax.tree.map(np.asarray, jcache)).items():
        tleaf = _np(convert.flatten(tcache)[path])
        T = jleaf.shape[2]
        if T < S:
            # ring cache shorter than the prompt: the port keeps position p at
            # slot p % T; the reference keeps the same tail at slots 0..T-1
            jleaf = np.roll(jleaf, S % T, axis=2)
        np.testing.assert_allclose(tleaf, jleaf, **TOL, err_msg=path)


def test_decode_steps_match_jax(pair):
    """20 teacher-forced decode steps from an 8-token prompt cross the 16-token window."""
    jmodel, jparams, tmodel, tparams = pair
    S, steps = 8, 20
    seq = _tokens(S + steps, seed=1)
    jcache, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(seq[:, :S], jnp.int32)}, max_len=MAX_LEN)
    tcache, _ = tmodel.prefill(tparams, {"tokens": seq[:, :S]}, max_len=MAX_LEN)
    for t in range(steps):
        tok = seq[:, S + t : S + t + 1]
        jcache, jlogits = jmodel.decode_step(jparams, jcache, jnp.asarray(tok, jnp.int32), jnp.int32(S + t))
        tcache, tlogits = tmodel.decode_step(tparams, tcache, tok, S + t)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("S", [16, 20, 23, 32])
def test_decode_after_prompt_longer_than_window_matches_full_forward(pair, S):
    """Prefill + one decode step equals the full-sequence forward, also when the
    prompt overflows the 16-slot ring cache of the local layers."""
    jmodel, jparams, tmodel, tparams = pair
    seq = _tokens(S + 1, seed=2)
    tcache, _ = tmodel.prefill(tparams, {"tokens": seq[:, :S]}, max_len=MAX_LEN)
    _, tlogits = tmodel.decode_step(tparams, tcache, seq[:, S:], S)
    np.testing.assert_allclose(_np(tlogits), _np(_jax_forward_logits(jmodel, jparams, seq)), **TOL)


def test_reference_ring_prefill_fault_is_recorded(pair):
    """The reference's prefill keeps a 20-token prompt's ring tail at slots
    0..15 while its decode writes slot pos % 16: its decode logits then miss
    its own full forward by far more than the tolerance (ROADMAP.md queue 3)."""
    jmodel, jparams, _, _ = pair
    S = 20
    seq = _tokens(S + 1, seed=2)
    jcache, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(seq[:, :S], jnp.int32)}, max_len=MAX_LEN)
    _, jlogits = jmodel.decode_step(jparams, jcache, jnp.asarray(seq[:, S:], jnp.int32), jnp.int32(S))
    gap = np.abs(_np(jlogits) - _np(_jax_forward_logits(jmodel, jparams, seq))).max()
    assert gap > 10 * TOL["atol"], gap


def test_serve_engine_greedy_tokens_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, size=n) for n in (5, 9, 12)]
    max_new = 6
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=MAX_LEN, slots=2, eos_token=-1))
    jreqs = [jeng.submit(p, max_new) for p in prompts]
    jeng.run_until_drained(jreqs)
    teng = ServeEngine(tmodel, tparams, ServeConfig(max_len=MAX_LEN, slots=2, eos_token=-1), device="cpu")
    treqs = [teng.submit(p, max_new) for p in prompts]
    stats = teng.run_until_drained(treqs)
    assert all(r.done for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert stats["tokens"] == 3 * max_new and stats["prefills"] == 3


def test_launcher_runs_on_cpu(capsys):
    assert launch_serve.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4", "--slots", "2"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["tokens"] == 12 and stats["device"] == "cpu"


def test_entry_points_refuse_to_fall_back_to_cpu(pair, monkeypatch):
    _, _, tmodel, tparams = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tmodel, tparams, ServeConfig(max_len=MAX_LEN, slots=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(tmodel.cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "gemma2-2b", "--smoke"])


def test_unported_layers_raise():
    """Every mixer and FFN kind of the decoder-only family serves now, with a tied or an untied head,
    and trains, a MoE (olmoe) and a Mamba mixer (jamba) included; what is left refuses and names its
    ROADMAP.md item instead of running half a model: a MoE with a shared expert (llama4, item 5), and
    remat="dots" in training (item 3h)."""
    olmoe = smoke_variant(get_config("olmoe-1b-7b"))
    model = Model(olmoe, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert "lm_head" in params  # the untied head is drawn and served
    batch = {"tokens": np.zeros((1, 16), np.int32), "targets": np.zeros((1, 16), np.int32)}
    loss, metrics = model.train_loss(params, batch)
    assert torch.isfinite(loss) and float(metrics["moe_aux"]) > 0
    jamba = smoke_variant(get_config("jamba-v0.1-52b"))
    jamba_model = Model(jamba, device="cpu")
    jamba_params = jamba_model.init(torch.Generator().manual_seed(0))
    loss, metrics = jamba_model.train_loss(jamba_params, batch)
    assert torch.isfinite(loss) and float(metrics["moe_aux"]) > 0
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 3h"):
        Model(jamba.replace(remat="dots"), device="cpu").train_loss(jamba_params, batch)
    shared = olmoe.replace(moe=dataclasses.replace(olmoe.moe, shared_expert=True))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
        Model(shared, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="MambaSpec"):  # a mamba layer without its spec is refused up front
        smoke_variant(get_config("gemma2-2b")).replace(
            pattern=(LayerSpec(mixer="mamba", ffn="dense"), LayerSpec(mixer="attn", ffn="dense"))
        )


def test_request_ids_stay_unique_when_submit_interleaves_with_step(pair):
    """The port counts request ids (src/repro_torch/serve/engine.py).  The reference sets
    ``rid=len(self.queue)`` (src/repro/serve/engine.py:79) and admission pops the queue, so a
    request submitted after an admission reuses a live id: that reference fault is recorded
    here (ROADMAP.md queue 3), not copied."""
    jmodel, jparams, tmodel, tparams = pair
    prompts = [_tokens(n, seed=n)[0] for n in (5, 6, 7, 8, 9)]

    def drive(eng):
        reqs = [eng.submit(prompts[0], 3), eng.submit(prompts[1], 3)]
        eng.step()                                  # admits both into the two slots
        reqs.append(eng.submit(prompts[2], 3))
        eng.step()
        reqs += [eng.submit(prompts[3], 3), eng.submit(prompts[4], 3)]
        eng.run_until_drained(reqs)
        return reqs

    treqs = drive(ServeEngine(tmodel, tparams, ServeConfig(max_len=MAX_LEN, slots=2, eos_token=-1), device="cpu"))
    assert [r.rid for r in treqs] == [0, 1, 2, 3, 4]
    assert all(r.done and len(r.out_tokens) == 3 for r in treqs)
    jreqs = drive(JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=MAX_LEN, slots=2, eos_token=-1)))
    jids = [r.rid for r in jreqs]
    assert len(set(jids)) < len(jids), jids  # the reference's duplicate
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]

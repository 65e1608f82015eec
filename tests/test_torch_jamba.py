"""The port's jamba slice against the JAX reference on the CPU (f32 compute, TF32 off).

The jamba-v0.1-52b smoke model (one 8-layer unit: seven Mamba layers and one
attention layer, MoE on the odd layers; d_model 64, 4 experts top-2,
d_state 8, ``ssm_chunk`` 16) gets its weights from the JAX init through
``params_from_jax``, in f32 and with the reference's
``param_dtype="bfloat16"``.  Logits and caches are held at the reference's
2e-3 (``tests/test_models_smoke.py``) and greedy tokens must be equal.  The
full-width layout is checked on the ``meta`` device against JAX
``eval_shape`` at 8, 16 and 32 layers, and the launcher's refusal of the full
depth is checked from the same ``meta`` arithmetic.
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
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeConfig, ServeEngine

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_LEN = 64
ARCH = "jamba-v0.1-52b"
PARAM_COUNTS = {8: 13_026_856_960, 16: 25_785_274_368, 32: 51_302_109_184}  # JAX eval_shape


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pair(param_dtype="float32", capacity_factor=None):
    """(JAX model, JAX params, port model, port params) of the jamba smoke variant."""
    jcfg = jax_smoke_variant(JAX_ARCHS[ARCH]).replace(param_dtype=param_dtype)
    tcfg = smoke_variant(get_config(ARCH)).replace(param_dtype=param_dtype)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor))
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = Model(tcfg, device="cpu")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, n))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_match_reference(smoke):
    jcfg, tcfg = JAX_ARCHS[ARCH], get_config(ARCH)
    if smoke:
        jcfg, tcfg = jax_smoke_variant(jcfg), smoke_variant(tcfg)
    for f in dataclasses.fields(ModelConfig):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "pattern":
            assert [(s.mixer, s.ffn) for s in got] == [(s.mixer, s.ffn) for s in want]
        elif f.name in ("moe", "mamba", "rwkv"):
            assert (got is None) == (want is None), f.name
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert [s.mixer for s in tcfg.pattern].count("attn") == 1 and tcfg.pattern[4].mixer == "attn"


@pytest.mark.parametrize("n_layers", sorted(PARAM_COUNTS))
def test_full_width_param_layout_matches_reference(n_layers):
    """Same leaf paths and shapes as the JAX ``eval_shape`` init at full width (no allocation)."""
    jcfg = JAX_ARCHS[ARCH].replace(n_layers=n_layers, param_dtype="bfloat16")
    jtree = jax.tree_util.tree_flatten_with_path(JaxModel(jcfg).init_abstract())[0]
    jshapes = {"/".join(str(k.key) for k in path): tuple(leaf.shape) for path, leaf in jtree}
    tparams = TT.init_lm(get_config(ARCH).replace(n_layers=n_layers, param_dtype="bfloat16"), None, "meta")
    tflat = convert.flatten(tparams)
    assert {p: tuple(t.shape) for p, t in tflat.items()} == jshapes
    assert {str(t.dtype) for t in tflat.values()} == {"torch.bfloat16"} == {f"torch.{l.dtype}" for _, l in jtree}
    assert TT.count_params(tparams) == PARAM_COUNTS[n_layers]
    assert "units/pos1/ffn/w_gate/w" in tflat and "units/pos0/mixer/A_log" in tflat
    assert tflat["units/pos1/ffn/w_gate/w"].shape == (n_layers // 8, 16, 4096, 14336)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_prefill_and_20_decode_steps_match_jax(param_dtype):
    """Logits and every cache leaf after a 20-token prompt (the scan's 16-chunks end in a
    ragged tail; MoE capacity 13 per expert), then 20 teacher-forced decode steps."""
    jmodel, jparams, tmodel, tparams = _pair(param_dtype)
    if param_dtype == "bfloat16":
        assert {str(t.dtype) for t in convert.flatten(tparams).values()} == {"torch.bfloat16"}
    S, steps = 20, 20
    seq = _tokens(S + steps, seed=1)
    jdecode = jax.jit(jmodel.decode_step)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(seq[:, :S], jnp.int32)}, max_len=MAX_LEN)
    tcache, tlogits = tmodel.prefill(tparams, {"tokens": seq[:, :S]}, max_len=MAX_LEN)
    assert tlogits.shape == (1, 1, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
    jflat, tflat = convert.flatten(jax.tree.map(np.asarray, jcache)), convert.flatten(tcache)
    assert set(tflat) == set(jflat)
    assert {p.split("/")[1] for p in tflat} == {"conv", "ssm", "k", "v"}
    for path, jleaf in jflat.items():
        assert tuple(tflat[path].shape) == jleaf.shape, path
        assert str(tflat[path].dtype) == f"torch.{jleaf.dtype}", path
        np.testing.assert_allclose(_np(tflat[path]), jleaf, **TOL, err_msg=path)
    for t in range(steps):
        tok = seq[:, S + t: S + t + 1]
        jcache, jlogits = jdecode(jparams, jcache, jnp.asarray(tok, jnp.int32), jnp.int32(S + t))
        tcache, tlogits = tmodel.decode_step(tparams, tcache, tok, S + t)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL, err_msg=f"step {t}")
    for path, jleaf in convert.flatten(jax.tree.map(np.asarray, jcache)).items():
        np.testing.assert_allclose(_np(convert.flatten(tcache)[path]), jleaf, **TOL, err_msg=path)


@pytest.mark.parametrize("S", [1, 16, 17])
def test_decode_after_prompt_matches_full_forward(S):
    """Prefill + one decode step equals the reference's full-sequence forward, with drop-free
    capacity (capacity factor 8, as tests/test_models_smoke.py::test_decode_matches_forward sets it:
    an S-token forward and a 1-token decode drop different tokens otherwise)."""
    jmodel, jparams, tmodel, tparams = _pair(capacity_factor=8.0)
    seq = _tokens(S + 1, seed=2)
    tcache, _ = tmodel.prefill(tparams, {"tokens": seq[:, :S]}, max_len=MAX_LEN)
    _, tlogits = tmodel.decode_step(tparams, tcache, seq[:, S:], S)
    hidden, _ = JT.lm_hidden(jparams, {"tokens": jnp.asarray(seq, jnp.int32)}, jmodel.cfg)
    want = JT._logits(jparams, hidden[:, -1:, :], jmodel.cfg)
    np.testing.assert_allclose(_np(tlogits), _np(want), **TOL)


def test_serve_engine_greedy_tokens_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, size=n) for n in (5, 9, 20)]
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


def test_engine_splice_keeps_each_cache_leaf_dtype(pair):
    """With bf16 compute the SSM state stays f32 and the conv carry bf16 through the row splice, bit for bit."""
    _, _, tmodel, tparams = pair
    model = Model(tmodel.cfg.replace(dtype="bfloat16"), device="cpu")
    eng = ServeEngine(model, tparams, ServeConfig(max_len=MAX_LEN, slots=3, eos_token=-1), device="cpu")
    prompt = _tokens(11, seed=3)[0]
    eng.submit(prompt, max_new=4)
    eng._admit()
    slot = next(i for i, r in enumerate(eng.slot_req) if r is not None)
    cache1, _ = model.prefill(eng.params, {"tokens": prompt[None]}, max_len=MAX_LEN)
    for pos, name, want_dtype in (("pos0", "ssm", torch.float32), ("pos0", "conv", torch.bfloat16),
                                  ("pos4", "k", torch.bfloat16)):
        full = eng.cache[pos][name]
        assert full.dtype == want_dtype, name
        assert torch.equal(full[:, slot], cache1[pos][name][:, 0]), name
    assert eng.cache["pos0"]["ssm"][:, slot].abs().sum() > 0


def test_bf16_masters_are_not_copied_for_compute():
    """With param_dtype == dtype == bfloat16 the engine's compute weights are the master tensors themselves."""
    cfg = smoke_variant(get_config(ARCH)).replace(dtype="bfloat16", param_dtype="bfloat16")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    master, cast = convert.flatten(params), convert.flatten(model.cast_for_compute(params))
    assert all(cast[p] is t for p, t in master.items())


def test_kernels_are_not_counted_on_cpu(pair):
    _, _, tmodel, tparams = pair
    before = (mamba_scan.launches, flash_attention.launches)
    cache, _ = tmodel.prefill(tparams, {"tokens": _tokens(5)}, max_len=MAX_LEN)
    tmodel.decode_step(tparams, cache, _tokens(1), 5)
    assert (mamba_scan.launches, flash_attention.launches) == before


def test_launcher_runs_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4", "--slots", "2"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["tokens"] == 12 and stats["device"] == "cpu"


def test_weight_bytes_from_meta_init():
    """4 bytes per f32 master parameter, plus 2 per parameter that the engine casts to bf16
    (every dense ``w``/``b`` and the embedding table, but not the f32 router); 2 per parameter
    with bf16 masters, which the engine does not copy.  Counted here from the JAX tree."""
    jtree = jax.tree_util.tree_flatten_with_path(JaxModel(JAX_ARCHS[ARCH]).init_abstract())[0]
    paths = [[str(k.key) for k in path] for path, _ in jtree]
    sizes = [int(np.prod(leaf.shape)) for _, leaf in jtree]
    cast = sum(n for path, n in zip(paths, sizes) if path[-1] in ("w", "b", "table") and "router" not in path)
    n = sum(sizes)
    assert n == PARAM_COUNTS[32]
    assert launch_serve.weight_bytes(get_config(ARCH)) == 4 * n + 2 * cast
    assert launch_serve.weight_bytes(get_config(ARCH).replace(param_dtype="bfloat16")) == 2 * n == 102_604_218_368


def test_launcher_refuses_full_depth_before_drawing(monkeypatch):
    """On a card with 80 GB free, the full 32-layer model is refused from the meta arithmetic
    alone: no kernel is built and no weight is drawn."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (80_000_000_000, 85_000_000_000))

    def untouched(*args, **kw):
        raise AssertionError("the launcher went past its memory check")

    monkeypatch.setattr(launch_serve, "build_all", untouched)
    monkeypatch.setattr(Model, "init", untouched)
    with pytest.raises(RuntimeError, match=r"51302109184 parameters.*307\.8 GB.*102\.6 GB with bfloat16.*80\.0 GB free"):
        launch_serve.main(["--arch", ARCH])
    launch_serve.check_fits(get_config(ARCH).replace(n_layers=16, param_dtype="bfloat16"), 80_000_000_000)

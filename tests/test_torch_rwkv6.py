"""The port's rwkv6 slice against the JAX reference on the CPU (f32, TF32 off).

Blocks (``rwkv_tmix``, ``rwkv_cmix``) and the rwkv6-7b smoke model (one
layer, d_model 64, head_dim 16, ``ssm_chunk`` 16) get their inputs from numpy
and their weights from the JAX init through ``params_from_jax``.  Logits are
held at the reference's 2e-3 (``tests/test_models_smoke.py``), greedy tokens
must be equal, and the full-width layout is checked on the ``meta`` device.
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
from repro.models import rwkv6 as JR
from repro.models import transformer as JT
from repro.models.model import Model as JaxModel
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import ModelConfig, get_config, smoke_variant
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeConfig, ServeEngine

TOL = dict(atol=2e-3, rtol=2e-3)     # the reference's prefill/decode tolerance
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)  # one block, f32: the scan tolerance
MAX_LEN = 64
ARCH = "rwkv6-7b"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) of the rwkv6-7b smoke variant."""
    jcfg = jax_smoke_variant(JAX_ARCHS[ARCH])
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = smoke_variant(get_config(ARCH))
    tmodel = Model(tcfg, device="cpu")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jmodel, jparams, tmodel, tparams


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, n))


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax_forward_logits(jmodel, jparams, tokens):
    """The reference's full-sequence forward (no cache) at the last position."""
    hidden, _ = JT.lm_hidden(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, jmodel.cfg)
    return JT._logits(jparams, hidden[:, -1:, :], jmodel.cfg)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_match_reference(smoke):
    jcfg, tcfg = JAX_ARCHS[ARCH], get_config(ARCH)
    if smoke:
        jcfg, tcfg = jax_smoke_variant(jcfg), smoke_variant(tcfg)
    for f in dataclasses.fields(ModelConfig):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "pattern":
            assert [(s.mixer, s.ffn) for s in got] == [(s.mixer, s.ffn) for s in want]
        elif f.name == "rwkv":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert tcfg.rwkv.head_dim == (16 if smoke else 64) and tcfg.ssm_chunk == (16 if smoke else 256)


def test_full_width_param_layout_matches_reference():
    """Same leaf paths and shapes as the JAX ``eval_shape`` init at full width (no allocation)."""
    jshapes = {
        "/".join(str(k.key) for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(JaxModel(JAX_ARCHS[ARCH]).init_abstract())[0]
    }
    tparams = TT.init_lm(get_config(ARCH), None, "meta")
    assert {p: tuple(t.shape) for p, t in convert.flatten(tparams).items()} == jshapes
    assert TT.count_params(tparams) == 7_266_508_800


def test_init_distributions():
    cfg = smoke_variant(get_config(ARCH)).replace(d_model=512, d_ff=1024)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tmix, cmix = params["units"]["pos0"]["mixer"], params["units"]["pos0"]["ffn"]
    D, (H, C) = cfg.d_model, TR._heads(cfg)
    jtmix = JR.init_rwkv_tmix(jax.random.PRNGKey(0), jax_smoke_variant(JAX_ARCHS[ARCH]).replace(d_model=D),
                              param_dtype=jnp.float32)
    np.testing.assert_allclose(_np(tmix["decay_base"][0]), np.asarray(jtmix["decay_base"]), atol=1e-6)
    assert torch.equal(tmix["mu"], torch.full((1, 5, D), 0.5))
    assert torch.equal(cmix["mu"], torch.full((1, 2, D), 0.5))
    assert tmix["bonus"].shape == (1, H, C)
    np.testing.assert_allclose(tmix["bonus"].std().item(), 0.1, rtol=0.1)
    np.testing.assert_allclose(tmix["w_r"]["w"].std().item(), D ** -0.5, rtol=0.05)
    np.testing.assert_allclose(tmix["decay_lora_b"]["w"].std().item(), 0.01, rtol=0.05)
    np.testing.assert_allclose(cmix["w_v"]["w"].std().item(), cfg.d_ff ** -0.5, rtol=0.05)
    assert tmix["decay_lora_a"]["w"].shape == (1, D, 64)
    assert torch.equal(tmix["gn_scale"], torch.ones(1, D)) and torch.equal(tmix["gn_bias"], torch.zeros(1, D))


def test_cast_for_compute_keeps_rwkv_leaves_in_f32(pair):
    _, _, tmodel, tparams = pair
    model = Model(tmodel.cfg.replace(dtype="bfloat16"), device="cpu")
    cast = convert.flatten(model.cast_for_compute(tparams))
    for path, leaf in cast.items():
        name = path.split("/")[-1]
        want = torch.bfloat16 if name in ("w", "b", "table") else torch.float32
        assert leaf.dtype == want, path


@pytest.mark.parametrize("with_state", [False, True], ids=["stateless", "state"])
def test_tmix_matches_jax(with_state):
    jcfg, tcfg = jax_smoke_variant(JAX_ARCHS[ARCH]), smoke_variant(get_config(ARCH))
    jp = JR.init_rwkv_tmix(jax.random.PRNGKey(1), jcfg, param_dtype=jnp.float32)
    tp = _to_torch(jax.tree.map(np.asarray, jp))
    H, C = TR._heads(tcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"wkv": rng.standard_normal((2, H, C, C)).astype(np.float32),
                 "shift": rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)}
    jout, jst = JR.rwkv_tmix(jp, jnp.asarray(x), jcfg, dtype=jnp.float32,
                             state=None if state is None else jax.tree.map(jnp.asarray, state))
    tout, tst = TR.rwkv_tmix(tp, torch.from_numpy(x), tcfg, dtype=torch.float32,
                             state=None if state is None else _to_torch(state))
    np.testing.assert_allclose(_np(tout), _np(jout), **BLOCK_TOL)
    if with_state:
        assert tst["wkv"].dtype == torch.float32
        for key in ("wkv", "shift"):
            np.testing.assert_allclose(_np(tst[key]), _np(jst[key]), **BLOCK_TOL, err_msg=key)
    else:
        assert tst is None and jst is None


@pytest.mark.parametrize("with_state", [False, True], ids=["stateless", "state"])
def test_cmix_matches_jax(with_state):
    jcfg, tcfg = jax_smoke_variant(JAX_ARCHS[ARCH]), smoke_variant(get_config(ARCH))
    jp = JR.init_rwkv_cmix(jax.random.PRNGKey(2), jcfg, param_dtype=jnp.float32)
    tp = _to_torch(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    state = {"shift": rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)} if with_state else None
    jout, jst = JR.rwkv_cmix(jp, jnp.asarray(x), jcfg, dtype=jnp.float32,
                             state=None if state is None else jax.tree.map(jnp.asarray, state))
    tout, tst = TR.rwkv_cmix(tp, torch.from_numpy(x), tcfg, dtype=torch.float32,
                             state=None if state is None else _to_torch(state))
    np.testing.assert_allclose(_np(tout), _np(jout), **BLOCK_TOL)
    if with_state:
        np.testing.assert_allclose(_np(tst["shift"]), _np(jst["shift"]), **BLOCK_TOL)


@pytest.mark.parametrize("S", [12, 20, 33])
def test_prefill_matches_jax(pair, S):
    """Logits and all three cache leaves; S > 16 crosses a chunk boundary into a padded tail."""
    jmodel, jparams, tmodel, tparams = pair
    tokens = _tokens(S)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, max_len=MAX_LEN)
    tcache, tlogits = tmodel.prefill(tparams, {"tokens": tokens}, max_len=MAX_LEN)
    assert tlogits.shape == (1, 1, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
    jflat, tflat = convert.flatten(jax.tree.map(np.asarray, jcache)), convert.flatten(tcache)
    assert set(tflat) == set(jflat) == {"pos0/wkv", "pos0/tshift", "pos0/cshift"}
    assert tflat["pos0/wkv"].dtype == torch.float32
    for path, jleaf in jflat.items():
        assert tuple(tflat[path].shape) == jleaf.shape, path
        np.testing.assert_allclose(_np(tflat[path]), jleaf, **TOL, err_msg=path)


def test_decode_steps_match_jax(pair):
    """20 teacher-forced decode steps from an 8-token prompt, each from the carried state."""
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
    np.testing.assert_allclose(_np(tcache["pos0"]["wkv"]), _np(jcache["pos0"]["wkv"]), **TOL)


@pytest.mark.parametrize("S", [1, 16, 17, 31])
def test_decode_after_prompt_matches_full_forward(pair, S):
    """Prefill + one decode step equals the reference's full-sequence forward
    (the property of tests/test_models_smoke.py::test_decode_matches_forward)."""
    jmodel, jparams, tmodel, tparams = pair
    seq = _tokens(S + 1, seed=2)
    tcache, _ = tmodel.prefill(tparams, {"tokens": seq[:, :S]}, max_len=MAX_LEN)
    _, tlogits = tmodel.decode_step(tparams, tcache, seq[:, S:], S)
    np.testing.assert_allclose(_np(tlogits), _np(_jax_forward_logits(jmodel, jparams, seq)), **TOL)


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


def test_engine_splice_keeps_the_f32_state_under_bf16_compute(pair):
    """With bf16 compute the WKV state stays f32 through the row splice, bit for bit."""
    _, _, tmodel, tparams = pair
    model = Model(tmodel.cfg.replace(dtype="bfloat16"), device="cpu")
    eng = ServeEngine(model, tparams, ServeConfig(max_len=MAX_LEN, slots=3, eos_token=-1), device="cpu")
    prompt = _tokens(11, seed=3)[0]
    eng.submit(prompt, max_new=4)
    eng._admit()
    slot = next(i for i, r in enumerate(eng.slot_req) if r is not None)
    cache1, _ = model.prefill(eng.params, {"tokens": prompt[None]}, max_len=MAX_LEN)
    for name, want_dtype in (("wkv", torch.float32), ("tshift", torch.bfloat16), ("cshift", torch.bfloat16)):
        full = eng.cache["pos0"][name]
        assert full.dtype == want_dtype, name
        assert torch.equal(full[:, slot], cache1["pos0"][name][:, 0]), name
    assert eng.cache["pos0"]["wkv"][:, slot].abs().sum() > 0


def test_wkv_kernel_is_not_counted_on_cpu(pair):
    _, _, tmodel, tparams = pair
    before = wkv6.launches
    cache, _ = tmodel.prefill(tparams, {"tokens": _tokens(5)}, max_len=MAX_LEN)
    tmodel.decode_step(tparams, cache, _tokens(1), 5)
    assert wkv6.launches == before


def test_launcher_runs_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4", "--slots", "2"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["tokens"] == 12 and stats["device"] == "cpu"

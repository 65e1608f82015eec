"""The port's Mamba-1 block against the JAX reference on the CPU (f32, TF32 off).

The conv with its tail carry, the prefill layer (``mamba_layer_with_state``:
output, conv tail, final SSM state) and the elementwise decode step run on
the jamba-v0.1-52b smoke config (d_model 64, d_inner 128, d_state 8,
``ssm_chunk`` 16) with JAX-initialised weights and numpy inputs, at the
reference's prefill/decode tolerance 2e-3 (``tests/test_models_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import mamba as JM
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models import mamba as TM
from repro_torch.models.layers import Init

TOL = dict(atol=2e-3, rtol=2e-3)
ARCH = "jamba-v0.1-52b"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def block():
    """(JAX smoke config, port smoke config, JAX params, the same params in torch)."""
    jcfg, tcfg = jax_smoke_variant(JAX_ARCHS[ARCH]), smoke_variant(get_config(ARCH))
    jp = JM.init_mamba(jax.random.PRNGKey(1), jcfg, param_dtype=jnp.float32)
    return jcfg, tcfg, jp, _to_torch(jax.tree.map(np.asarray, jp))


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("with_carry", [False, True], ids=["zero-start", "carried"])
@pytest.mark.parametrize("S", [1, 2, 7])
def test_conv_output_and_tail_match_jax(S, with_carry):
    """S < K-1 included: the tail then still holds part of the zero pad or the carry."""
    rng = np.random.default_rng(S)
    K, di = 4, 12
    x = rng.standard_normal((2, S, di)).astype(np.float32)
    w = rng.standard_normal((K, di)).astype(np.float32)
    b = rng.standard_normal((di,)).astype(np.float32)
    carry = rng.standard_normal((2, K - 1, di)).astype(np.float32) if with_carry else None
    jy, jtail = JM._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                          init_state=None if carry is None else jnp.asarray(carry))
    ty, ttail = TM._causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                          init_state=None if carry is None else torch.from_numpy(carry))
    assert ttail.shape == (2, K - 1, di)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(ttail), _np(jtail), atol=0, rtol=0)


@pytest.mark.parametrize("S", [5, 16, 20])
def test_layer_with_state_matches_jax(block, S):
    """Output, conv tail and final SSM state; S = 20 ends the 16-chunks in a ragged tail."""
    jcfg, tcfg, jp, tp = block
    x = np.random.default_rng(0).standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    jout, jtail, jh = JM.mamba_layer_with_state(jp, jnp.asarray(x), jcfg, dtype=jnp.float32)
    before = mamba_scan.launches
    tout, ttail, th = TM.mamba_layer_with_state(tp, torch.from_numpy(x), tcfg, dtype=torch.float32)
    assert mamba_scan.launches == before  # the CPU runs the plain version
    assert th.dtype == torch.float32 and th.shape == (2, 2 * tcfg.d_model, tcfg.mamba.d_state)
    for name, t, j in (("out", tout, jout), ("tail", ttail, jtail), ("h_final", th, jh)):
        np.testing.assert_allclose(_np(t), _np(j), **TOL, err_msg=name)


def test_decode_step_matches_jax(block):
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(1)
    di, ds, K = 2 * tcfg.d_model, tcfg.mamba.d_state, tcfg.mamba.d_conv
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, K - 1, di)).astype(np.float32)
    ssm = rng.standard_normal((3, di, ds)).astype(np.float32)
    jout, jconv, jssm = JM.mamba_decode_step(jp, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(ssm), jcfg,
                                             dtype=jnp.float32)
    tout, tconv, tssm = TM.mamba_decode_step(tp, torch.from_numpy(x), torch.from_numpy(conv),
                                             torch.from_numpy(ssm), tcfg, dtype=torch.float32)
    for name, t, j in (("out", tout, jout), ("conv", tconv, jconv), ("ssm", tssm, jssm)):
        np.testing.assert_allclose(_np(t), _np(j), **TOL, err_msg=name)


def test_prefill_then_decode_steps_equal_a_longer_prefill(block):
    """Decoding token by token from the prefill's carries gives what prefilling the whole sequence gives."""
    _, tcfg, _, tp = block
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 24, tcfg.d_model)).astype(np.float32))
    full, tail_full, h_full = TM.mamba_layer_with_state(tp, x, tcfg, dtype=torch.float32)
    out, conv, h = TM.mamba_layer_with_state(tp, x[:, :18], tcfg, dtype=torch.float32)
    outs = [out]
    for t in range(18, 24):
        o, conv, h = TM.mamba_decode_step(tp, x[:, t:t + 1], conv, h, tcfg, dtype=torch.float32)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, **TOL)
    torch.testing.assert_close(conv, tail_full, **TOL)
    torch.testing.assert_close(h, h_full, **TOL)


def test_init_distributions_and_layout():
    cfg = smoke_variant(get_config(ARCH)).replace(d_model=256)
    di, ds, dr = 2 * cfg.d_model, cfg.mamba.d_state, 16
    p = TM.init_mamba(Init(torch.Generator().manual_seed(0), "cpu", torch.float32, (2,)), cfg)
    jp = JM.init_mamba(jax.random.PRNGKey(0), jax_smoke_variant(JAX_ARCHS[ARCH]).replace(d_model=cfg.d_model),
                       param_dtype=jnp.float32)
    jshapes = {k: (2,) + v.shape for k, v in convert.flatten(jax.tree.map(np.asarray, jp)).items()}
    assert {k: tuple(v.shape) for k, v in convert.flatten(p).items()} == jshapes
    # S4D-real A_log = log n (torch's and XLA's log may differ in the last bit) and D as the reference makes them
    np.testing.assert_allclose(_np(p["A_log"][1]), np.asarray(jp["A_log"]), rtol=0, atol=2.4e-7)
    assert torch.equal(p["D"], torch.ones(2, di)) and torch.equal(p["conv_b"], torch.zeros(2, di))
    assert torch.equal(p["dt_proj"]["b"], torch.zeros(2, di))
    # the step Δ = softplus(dt_bias) is log-uniform in [1e-3, 1e-1]
    dt = F.softplus(p["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    np.testing.assert_allclose(torch.log(dt).mean().item(), np.log(1e-2), atol=0.15)
    np.testing.assert_allclose(p["conv_w"].std().item(), 0.5, rtol=0.05)
    np.testing.assert_allclose(p["in_proj"]["w"].std().item(), cfg.d_model ** -0.5, rtol=0.05)
    np.testing.assert_allclose(p["x_proj"]["w"].std().item(), di ** -0.5, rtol=0.05)
    np.testing.assert_allclose(p["dt_proj"]["w"].std().item(), dr ** -0.5, rtol=0.05)
    assert p["x_proj"]["w"].shape == (2, di, dr + 2 * ds)
    assert not torch.equal(p["dt_bias"][0], p["dt_bias"][1])  # each unit draws its own


def test_init_in_bfloat16_keeps_every_leaf_bfloat16():
    cfg = smoke_variant(get_config(ARCH))
    p = TM.init_mamba(Init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16), cfg)
    assert {str(t.dtype) for t in convert.flatten(p).values()} == {"torch.bfloat16"}
    meta = TM.init_mamba(Init(None, "meta", torch.bfloat16, (3,)), cfg)
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in convert.flatten(meta).values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_layout_matches_jax(dtype):
    jcfg, tcfg = jax_smoke_variant(JAX_ARCHS[ARCH]), smoke_variant(get_config(ARCH))
    jc = JM.init_mamba_cache(jcfg, 3, n_layers_of_kind=2, dtype=jnp.dtype(dtype))
    tc = TM.init_mamba_cache(tcfg, 3, n_layers_of_kind=2, dtype=getattr(torch, dtype), device="cpu")
    for name in ("conv", "ssm"):
        assert tuple(tc[name].shape) == jc[name].shape and str(tc[name].dtype) == f"torch.{jc[name].dtype}", name
        assert not tc[name].any()

"""jamba's smoke model over 1 and 4 microbatches, against the reference's ``_microbatched_grads``.

The step's mean loss, its metrics (``moe_aux`` only for one microbatch, as the
reference's) and every gradient leaf over 1 or 4 row slices of a B4 S40 batch,
f32 with TF32 off, parameters moved from JAX through ``convert.params_from_jax``;
loss rtol 1e-5, leaves atol 1e-5 and rtol 1e-4, as
``tests/test_torch_ssm_moe_train.py`` holds rwkv6 and olmoe.  A file of its own,
beside ``tests/test_torch_mamba_train.py``, so that the test workers split the
JAX compile time.
"""

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
from repro_torch.models import Model
from repro_torch.train.step import _microbatched_grads

ARCH = "jamba-v0.1-52b"
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
B, S, CHUNK = 4, 40, 20


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_side():
    jcfg = jax_smoke_variant(JAX_ARCHS[ARCH])
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    batch = ShardedPipeline(SyntheticLM(vocab_size=jcfg.vocab_size, seq_len=S, period=16, vocab_eff=256),
                            global_batch=B).batch_at(0)
    return jcfg, jparams, batch


@pytest.mark.parametrize("microbatches", [1, 4])
def test_microbatches_match_jax(jax_side, microbatches):
    jcfg, jparams, batch = jax_side
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, jmetrics, jgrads = jax_microbatched_grads(JaxModel(jcfg), jparams, jbatch, microbatches, CHUNK)
    want = convert.flatten(jax.tree.map(np.asarray, jgrads))

    tcfg = smoke_variant(get_config(ARCH))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for leaf in convert.flatten(params).values():
        leaf.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = _microbatched_grads(Model(tcfg, device="cpu"), params, tbatch, microbatches, CHUNK)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmetrics)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL, atol=1e-12)
    got = convert.flatten(grads)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[path], **GRAD_TOL, err_msg=path)

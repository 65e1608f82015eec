"""The port's flash-attention backward against JAX's gradients of the reference.

The reference trains through JAX's autodiff of its blocked jnp attention
(``repro.models.attention.flash_attention``); the naive oracle is
``repro.kernels.ref.attention_ref``.  On the CPU the port's backward is
``flash_attention_bwd_plain``, reached directly or through the autograd
Function behind ``flash_attention``; both are held to ``jax.vjp`` of the two
at the reference's f32 kernel tolerance, 2e-5 (``tests/test_kernels.py``).
The cases cover G = 2, the softcap with q scaled by 4 (so that 1 - t² is far
from 1), a window, ragged S and T, B = 2 and gemma2's head dim.  The CUDA
kernels run only on a card (``gpu`` marker), held to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models.attention import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import (
    backward_geometry,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

F32 = dict(atol=2e-5, rtol=2e-5)
SMEM_PER_BLOCK = 232_448  # H100: the most dynamic shared memory one block may use

# B, S, T, H, Kv, hd, causal, window, cap, q scale
CASES = {
    "mha-causal": (2, 64, 64, 4, 4, 16, True, 0, 0.0, 1.0),
    "gqa2-cap50-q4": (1, 48, 48, 4, 2, 16, True, 0, 50.0, 4.0),
    "window16-cap50-q4": (1, 64, 64, 4, 2, 16, True, 16, 50.0, 4.0),
    "ragged-B2-S37": (2, 37, 37, 4, 2, 16, True, 8, 50.0, 4.0),
    "bidirectional-T-ne-S": (1, 24, 40, 4, 2, 16, False, 0, 0.0, 1.0),
    "gemma2-hd256": (1, 32, 32, 8, 4, 256, True, 16, 50.0, 4.0),
}
CHUNK = 16  # small chunks, so that ragged S and T pad both sides' blocks


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _arrays(case, seed=0):
    B, S, T, H, Kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    q = case[9] * rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Kv, hd)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, do


def _kw(case):
    causal, window, cap = case[6:9]
    return dict(causal=causal, window=window, logit_softcap=cap)


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad_of_blocked_attention(name):
    case = CASES[name]
    q, k, v, do = _arrays(case)
    kw = _kw(case)
    want = _jax_grads(lambda a, b, c: jax_flash_attention(a, b, c, chunk_q=CHUNK, chunk_kv=CHUNK, **kw), q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, chunk_q=CHUNK, chunk_kv=CHUNK, return_lse=True, **kw)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, chunk_q=CHUNK, chunk_kv=CHUNK, **kw)
    for name_g, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name_g
        np.testing.assert_allclose(g.numpy(), w, **F32, err_msg=name_g)


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_function_matches_jax_grad_of_oracle(name):
    """flash_attention with grad on the CPU runs the Function: plain forward, plain backward."""
    case = CASES[name]
    q, k, v, do = _arrays(case, seed=1)
    kw = _kw(case)
    want = _jax_grads(lambda a, b, c: jax_attention_ref(a, b, c, **kw), q, k, v, do)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, **kw)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    for name_g, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), w, **F32, err_msg=name_g)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_lse_matches_logsumexp_of_reference_scores(name):
    case = CASES[name]
    B, S, T, H, Kv, hd = case[:6]
    causal, window, cap = case[6:9]
    q, k, v, _ = _arrays(case, seed=2)
    G = H // Kv
    s = jnp.einsum("bskgd,btkd->bkgst", jnp.asarray(q).reshape(B, S, Kv, G, hd), jnp.asarray(k)) / np.sqrt(hd)
    if cap:
        s = cap * jnp.tanh(s / cap)
    q_pos, k_pos = jnp.arange(S)[:, None], jnp.arange(T)[None, :]
    ok = jnp.ones((S, T), bool)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    want = np.asarray(jax.nn.logsumexp(jnp.where(ok, s, -1e30), axis=-1)).reshape(B, H, S)
    _, lse = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), chunk_q=CHUNK, chunk_kv=CHUNK,
                                   return_lse=True, **_kw(case))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, S)
    np.testing.assert_allclose(lse.numpy(), want, **F32)


def test_serving_call_stays_the_forward_alone():
    """No grad wanted, no Function: the result has no grad_fn (serving's call)."""
    q, k, v, _ = _arrays(CASES["mha-causal"])
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        assert flash_attention(tq, tk, tv).grad_fn is None
    assert flash_attention(*(torch.from_numpy(x) for x in (q, k, v))).grad_fn is None


def test_backward_takes_q_offset_zero_only():
    q, k, v, _ = _arrays(CASES["mha-causal"])
    tq = torch.from_numpy(q).requires_grad_()
    with pytest.raises(NotImplementedError, match="q_offset"):
        flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v), q_offset=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_geometry(dtype):
    """Every head dim fits one block's shared memory; bf16 pads hd to whole 64-column groups."""
    for hd in range(1, 257):
        g = backward_geometry(dtype, hd)
        assert max(g.smem_dkdv, g.smem_dq) <= SMEM_PER_BLOCK
        assert g.threads == 256
        if dtype == torch.bfloat16:
            assert g.variant == "mma" and g.hd % 64 == 0 and g.hd - 64 < hd <= g.hd
        else:
            assert g.variant == "scalar" and g.hd == hd
    with pytest.raises(ValueError):
        backward_geometry(torch.float16, 64)


def test_zero_padding_the_head_dim_leaves_the_backward_unchanged():
    """What the wrapper does for a bf16 head dim that is not a multiple of 64, held on the plain version."""
    case = CASES["gqa2-cap50-q4"]
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(case, seed=3))
    kw = dict(_kw(case), scale=1 / 16 ** 0.5)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    pad = [torch.nn.functional.pad(x, (0, 48)) for x in (q, k, v, o, do)]
    got = flash_attention_bwd_plain(*pad[:4], lse, pad[4], **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :16], w, rtol=0, atol=0)
        assert g[..., 16:].abs().max() == 0


GPU_CASES = {
    **CASES,
    "gemma2-train-B2-S300": (2, 300, 300, 8, 4, 256, True, 0, 50.0, 4.0),
    "jamba-hd128": (1, 200, 200, 32, 8, 128, True, 0, 0.0, 1.0),
    "hd80-padded": (1, 100, 100, 4, 4, 80, True, 0, 0.0, 1.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(GPU_CASES))
def test_cuda_backward_kernels_match_plain(name, dtype):
    """Each of the three kernels launches once; dq, dk, dv within 2e-5 (f32) or 2e-2 x rms (bf16) of plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    case = GPU_CASES[name]
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(dt).cuda() for x in _arrays(case, seed=4))
    kw = _kw(case)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    counts = ("launches_rowdot", "launches_dkdv", "launches_dq")
    before = [getattr(flash_attention_bwd, c) for c in counts]
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert [getattr(flash_attention_bwd, c) for c in counts] == [n + 1 for n in before]
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name_g, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape
        tol = F32 if dtype == "float32" else dict(atol=2e-2 * w.float().pow(2).mean().sqrt().item(), rtol=2e-2)
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(), **tol, err_msg=name_g)

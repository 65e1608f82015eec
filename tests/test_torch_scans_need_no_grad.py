"""Both scans train on the card: a CUDA input that needs grad goes through the scan's autograd Function.

The scan kernels write their results through ``ctypes``, which autograd cannot
see; a result with no ``grad_fn`` would silently give the inputs no gradient.
So with grad enabled WKV-6 and the selective scan go through their autograd
Functions: on the card the forward's training form (which also saves the
state every 16 tokens) and the backward kernel, whose gradients equal the
plain backward's (``wkv6_bwd_plain``, ``mamba_scan_bwd_plain``) at the scan
tolerance.  On the CPU both plain versions stay differentiable, and a card
call under ``torch.no_grad()`` (serving) is unchanged.
"""

import pytest
import torch

from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd, mamba_scan_bwd_plain
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd, wkv6_bwd_plain


def _wkv_inputs(device, grad):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))   # C = 16: a head dim the kernel takes
    w = torch.rand(1, 8, 2, 16, generator=g) * 0.5 + 0.4
    u = 0.1 * torch.randn(2, 16, generator=g)
    out = [x.to(device) for x in (r, k, v, w, u)]
    out[0].requires_grad_(grad)
    return out


def _scan_inputs(device, grad):
    g = torch.Generator().manual_seed(0)
    u = torch.randn(1, 8, 16, generator=g)
    delta = torch.nn.functional.softplus(torch.randn(1, 8, 16, generator=g))
    A = -torch.exp(torch.randn(16, 4, generator=g))
    Bm, Cm = (torch.randn(1, 8, 4, generator=g) for _ in range(2))
    out = [x.to(device) for x in (u, delta, A, Bm, Cm)]
    out[1].requires_grad_(grad)
    return out


def test_plain_wkv6_stays_differentiable_on_the_cpu():
    r, k, v, w, u = _wkv_inputs("cpu", True)
    out, _ = wkv6(r, k, v, w, u, chunk=4)
    out.sum().backward()
    assert r.grad is not None and torch.isfinite(r.grad).all()


def test_plain_mamba_scan_stays_differentiable_on_the_cpu():
    u, delta, A, Bm, Cm = _scan_inputs("cpu", True)
    y, _ = mamba_scan(u, delta, A, Bm, Cm, chunk=4)
    y.sum().backward()
    assert delta.grad is not None and torch.isfinite(delta.grad).all()


@pytest.mark.gpu
def test_cuda_wkv6_refuses_inputs_that_need_grad():
    """No longer refused: the CUDA WKV's gradients (training form, backward kernel) equal wkv6_bwd_plain's at
    the scan tolerance (atol 1e-4 x rms, rtol 1e-4), each kernel launched once; under torch.no_grad() the
    serving form runs as before, with no graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    r, k, v, w, u = _wkv_inputs("cuda", True)
    for x in (k, v, w, u):
        x.requires_grad_(True)
    g = torch.Generator(device="cuda").manual_seed(1)
    s0 = torch.randn((1, 2, 16, 16), generator=g, device="cuda").requires_grad_()
    dout = torch.randn((1, 8, 2, 16), generator=g, device="cuda")
    ds_fin = torch.randn((1, 2, 16, 16), generator=g, device="cuda")
    before = (wkv6.launches, wkv6.launches_train, wkv6_bwd.launches)
    out, state = wkv6(r, k, v, w, u, chunk=4, s0=s0)
    grads = torch.autograd.grad((out * dout).sum() + (state * ds_fin).sum(), (r, k, v, w, u, s0))
    torch.cuda.synchronize()
    assert (wkv6.launches, wkv6.launches_train, wkv6_bwd.launches) == tuple(n + 1 for n in before)
    want = wkv6_bwd_plain(*(x.detach() for x in (r, k, v, w, u, s0)), dout, ds_fin)
    for got, plain in zip(grads, want):
        rms = plain.pow(2).mean().sqrt().item()
        torch.testing.assert_close(got, plain, atol=1e-4 * rms, rtol=1e-4)
    with torch.no_grad():
        out, _ = wkv6(r, k, v, w, u, chunk=4)
    torch.cuda.synchronize()
    assert wkv6.launches == before[0] + 2 and wkv6.launches_train == before[1] + 1 and out.grad_fn is None


@pytest.mark.gpu
def test_cuda_wkv6_backward_is_bitwise_repeatable():
    """The backward kernel adds no atomics: two calls on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.wkv6 import _launch, wkv6_bwd as bwd

    g = torch.Generator(device="cuda").manual_seed(2)
    r, k, v = (torch.randn((2, 300, 4, 64), generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    w = torch.rand((2, 300, 4, 64), generator=g, device="cuda") * 0.5 + 0.45
    u = 0.1 * torch.randn((4, 64), generator=g, device="cuda")
    dout = torch.randn((2, 300, 4, 64), generator=g, device="cuda")
    _, _, s_chk = _launch(r, k, v, w, u, None, train=True)
    first, second = bwd(r, k, v, w, u, s_chk, dout), bwd(r, k, v, w, u, s_chk, dout)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 16, 32, 64])
def test_cuda_wkv6_backward_matches_plain_at_every_head_dim(C, dtype):
    """Every instantiation of the backward kernel (its tiling depends on C) against wkv6_bwd_plain, with s0
    and ds_fin and a ragged S of 300 (a last chunk of 12 tokens): dr, dk, dv in bf16 at the backward's bf16
    gate (2e-2 x rms, rtol 2e-2: both round an f32 result to bf16 once), every other gradient at the scan
    tolerance (1e-4 x rms, rtol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.wkv6 import _launch

    B, S, H = 2, 300, 4
    g = torch.Generator(device="cuda").manual_seed(3)
    r, k, v = (torch.randn((B, S, H, C), generator=g, device="cuda").to(getattr(torch, dtype)) for _ in range(3))
    w = torch.rand((B, S, H, C), generator=g, device="cuda") * 0.5 + 0.45
    u = 0.1 * torch.randn((H, C), generator=g, device="cuda")
    s0, ds_fin = (torch.randn((B, H, C, C), generator=g, device="cuda") for _ in range(2))
    dout = torch.randn((B, S, H, C), generator=g, device="cuda")
    _, _, s_chk = _launch(r, k, v, w, u, s0, train=True)
    before = wkv6_bwd.launches
    grads = wkv6_bwd(r, k, v, w, u, s_chk, dout, ds_fin)
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == before + 1
    want = wkv6_bwd_plain(r, k, v, w, u, s0, dout, ds_fin)
    for name, got, plain in zip(("dr", "dk", "dv", "dw", "du", "ds0"), grads, want):
        rel = 2e-2 if dtype == "bfloat16" and name in ("dr", "dk", "dv") else 1e-4
        rms = plain.float().pow(2).mean().sqrt().item()
        torch.testing.assert_close(got, plain, atol=rel * rms, rtol=rel, msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
def test_cuda_mamba_scan_refuses_inputs_that_need_grad():
    """No longer refused: the CUDA scan's gradients (training form, backward kernel) equal
    mamba_scan_bwd_plain's at the scan tolerance (atol 1e-4 x rms, rtol 1e-4), each kernel launched once;
    under torch.no_grad() the serving form runs as before, with no graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    inputs = _scan_inputs("cuda", True)
    for x in inputs:
        x.requires_grad_(True)
    g = torch.Generator(device="cuda").manual_seed(1)
    h0 = torch.randn((1, 16, 4), generator=g, device="cuda").requires_grad_()
    dy = torch.randn((1, 8, 16), generator=g, device="cuda")
    dh_fin = torch.randn((1, 16, 4), generator=g, device="cuda")
    before = (mamba_scan.launches, mamba_scan.launches_train, mamba_scan_bwd.launches)
    y, h = mamba_scan(*inputs, chunk=4, h0=h0)
    grads = torch.autograd.grad((y * dy).sum() + (h * dh_fin).sum(), (*inputs, h0))
    torch.cuda.synchronize()
    assert (mamba_scan.launches, mamba_scan.launches_train, mamba_scan_bwd.launches) == tuple(n + 1 for n in before)
    want = mamba_scan_bwd_plain(*(x.detach() for x in inputs), h0.detach(), dy, dh_fin)
    for got, plain in zip(grads, want):
        rms = plain.pow(2).mean().sqrt().item()
        torch.testing.assert_close(got, plain, atol=1e-4 * rms, rtol=1e-4)
    with torch.no_grad():
        y, _ = mamba_scan(*inputs, chunk=4)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before[0] + 2 and mamba_scan.launches_train == before[1] + 1
    assert y.grad_fn is None


@pytest.mark.gpu
def test_cuda_mamba_scan_backward_is_bitwise_repeatable():
    """The backward kernel adds no atomics: dB and dC come as per-block partials that torch.sum adds,
    so two calls on the same inputs give the same bits (a ragged S and a ragged di)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.mamba_scan import _launch

    g = torch.Generator(device="cuda").manual_seed(2)
    u, dy = (torch.randn((2, 300, 200), generator=g, device="cuda") for _ in range(2))
    delta = torch.nn.functional.softplus(torch.randn((2, 300, 200), generator=g, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((200, 16), generator=g, device="cuda"))
    Bm, Cm = (torch.randn((2, 300, 16), generator=g, device="cuda") for _ in range(2))
    _, _, h_chk = _launch(u, delta, A, Bm, Cm, None, train=True)
    first = mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy)
    second = mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))

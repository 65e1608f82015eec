"""WKV-6 and the selective scan have no CUDA backward yet: a CUDA input that needs grad raises.

Their kernels write results through ``ctypes``, which autograd cannot see; a
result with no ``grad_fn`` would silently give the inputs no gradient.  Until
the backwards are ported (ROADMAP.md queue 2, items 2 and 3), the wrappers
refuse such a call on the card.  On the CPU the plain versions stay ordinary
differentiable PyTorch, and a card call under ``torch.no_grad()`` (serving)
is unchanged.
"""

import pytest
import torch

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.wkv6 import wkv6


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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    inputs = _wkv_inputs("cuda", True)
    before = wkv6.launches
    with pytest.raises(NotImplementedError, match="queue 2, item 3"):
        wkv6(*inputs, chunk=4)
    assert wkv6.launches == before
    with torch.no_grad():
        out, _ = wkv6(*inputs, chunk=4)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1 and out.grad_fn is None


@pytest.mark.gpu
def test_cuda_mamba_scan_refuses_inputs_that_need_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    inputs = _scan_inputs("cuda", True)
    before = mamba_scan.launches
    with pytest.raises(NotImplementedError, match="queue 2, item 2"):
        mamba_scan(*inputs, chunk=4)
    assert mamba_scan.launches == before
    with torch.no_grad():
        y, _ = mamba_scan(*inputs, chunk=4)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1 and y.grad_fn is None

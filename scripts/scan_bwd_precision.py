#!/usr/bin/env python3
"""How close the selective scan's backward comes to exact, against f64, on one card.

    python3 scripts/scan_bwd_precision.py

At jamba's training shape (f32 B4 S2048 di8192 ds16, the model's init for A and
Δ, no h0 or dh_fin, as training calls it) it computes the gradients three ways:
the committed kernel (``csrc/mamba_scan_bwd.cu``, whose decays take
``ex2.approx`` as the forward's do), a variant of it whose decays take the
accurate ``expf`` (a text edit, written and built under
``build/repro_torch/variants/`` as ``chip_smoke.py`` builds its planted faults),
and the f32 plain version ``mamba_scan_bwd_plain``.  Each is held against the
exact gradients, ``mamba_scan_bwd_plain`` on the same inputs in f64, at
``chip_smoke.py``'s gate (``mamba_bwd_tols``: the f32 plain version's own max
|error| plus 1e-4 x rms, rtol 1e-4; the elements outside it are counted).  It
prints one JSON line per build with each gradient's max |error| over the exact
result's rms, and over the f32 plain version's rms, the CUDA-event ms of a
backward call, then the card's ``nvidia-smi`` line.  Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, S, DI, DS = 4, 2048, 8192, 16

# the accurate exponential, as a text edit of the committed backward
EXPF = ("mamba_scan_bwd", [
    ("h[s] = fmaf(ex2(dt * a2[s]), h[s], x * bq[s]);", "h[s] = fmaf(expf(dt * (a2[s] * LN2)), h[s], x * bq[s]);"),
    ("const float a = ex2(dt * a2[s]);", "const float a = expf(dt * (a2[s] * LN2));"),  # the sweep's
])


def inputs(torch):
    """u, B, C, dy ~ N(0, 1); A = -(1 .. ds) and Δ = softplus(0.5 N + dt_bias), as the model's init gives them."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    u = torch.randn((B, S, DI), generator=gen, device="cuda")
    Bm, Cm = (torch.randn((B, S, DS), generator=gen, device="cuda") for _ in range(2))
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand((DI,), generator=gen, device="cuda"))
    delta = F.softplus(0.5 * torch.randn((B, S, DI), generator=gen, device="cuda") + torch.log(torch.expm1(dt)))
    A = -torch.arange(1, DS + 1, dtype=torch.float32, device="cuda").expand(DI, DS).contiguous()
    dy = torch.randn((B, S, DI), generator=gen, device="cuda")
    return u, delta, A, Bm, Cm, dy


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan_bwd_precision: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    import repro_torch.kernels.mamba_scan as ms
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.smi_line()
    _build.build(["mamba_scan", "mamba_scan_bwd"])
    src, lib_path = chip_smoke.planted_sources({"bwd_expf": EXPF}, folder="variants")["bwd_expf"]
    _build.compile_source(src, lib_path)
    variant = ms._bind_bwd(ctypes.CDLL(str(lib_path)))

    u, delta, A, Bm, Cm, dy = inputs(torch)
    _, _, h_chk = ms._launch(u, delta, A, Bm, Cm, None, train=True)
    plain = ms.mamba_scan_bwd_plain(u, delta, A, Bm, Cm, None, dy, None)
    exact = chip_smoke.mamba_bwd_exact(ms, u, delta, A, Bm, Cm, None, dy, None)
    tols = chip_smoke.mamba_bwd_tols(exact, plain)
    committed_lib = ms._bwd_lib
    builds = {"plain f32": None, "kernel, ex2.approx (committed)": committed_lib, "kernel, expf": lambda: variant}
    for name, lib in builds.items():
        if lib is None:
            grads, ms_call = plain, None
        else:
            ms._bwd_lib = lib
            try:
                grads = ms.mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy)
                ms_call = chip_smoke.cuda_ms(torch, lambda: ms.mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy))
            finally:
                ms._bwd_lib = committed_lib
        row = dict(build=name, shape=f"float32 B{B} S{S} di{DI} ds{DS}", backward_ms=ms_call, card=card)
        for gname, got, want, p in zip(chip_smoke.SCAN_GRADS, grads, exact, plain):
            row[gname] = dict(vs_exact=chip_smoke.over_rms(got, want), vs_plain=chip_smoke.over_rms(got, p),
                              outside_gate=chip_smoke.n_outside(got, want, tols[gname]))
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

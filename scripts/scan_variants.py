#!/usr/bin/env python3
"""Hold variants of the WKV-6 and selective-scan sources against the committed kernels on one card.

    python3 scripts/scan_variants.py [--baseline CHECKOUT] [VARIANT ...]

A variant is ``src/repro_torch/kernels/csrc/wkv6.cu`` or ``mamba_scan.cu`` with
a few text replacements (``VARIANTS`` below), written by
``chip_smoke.planted_sources`` into ``build/repro_torch/variants/`` and built as
``chip_smoke.py`` builds its planted faults; naming variants times only those.  Variants named probes compute wrong values
on purpose: each takes one piece of work out to show what it costs.  At the
main path's long shapes and the decode shape each build is checked against the
plain version at ``chip_smoke.py``'s scan gate (the elements outside it are
counted, not asserted) and timed in turns: committed, each variant, committed.
Each row gives the CUDA-event time of a whole call (``ms``; at the decode
shape mostly the host's launch) and the kernel's own device time from
``torch.profiler`` (``device_us``, the mean over the profiled launches).
``--baseline CHECKOUT`` adds the two sources of another checkout (for example
the parent commit, unpacked with ``git archive``) as the build ``baseline``,
timed in the same turns: the kernels' C interfaces are the same.  It prints one
JSON line per shape and build, then the card's ``nvidia-smi`` line.  Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: (kernel source, [(text of the committed source, its replacement), ...]), the form that
# chip_smoke.planted_sources takes; each text must appear in the source exactly once
_WKV_PATCH = "template <> struct Patch<64, false> { static constexpr int RI = 4, JC = 2, JB = 32; };"
_WKV_STEP = """    for (int tt = 0; tt < n; tt += 2 * TK) {
      float pa[G], pb[G];
      wkv_group<T, C, SHORT>(rs, ks, ws, vs, tt, n, row0, jl0, st, pa);
      finish(tt, pa);
      wkv_group<T, C, SHORT>(rs, ks, ws, vs, tt + TK, n, row0, jl0, st, pb);
      finish(tt + TK, pb);
    }
"""
_WKV_ONE_GROUP = """    for (int tt = 0; tt < n; tt += TK) {
      float pa[G];
      wkv_group<T, C, SHORT>(rs, ks, ws, vs, tt, n, row0, jl0, st, pa);
      finish(tt, pa);
    }
"""
_SCAN_TILE = ("constexpr int DC = 1;      // channels per thread\n"
              "constexpr int CB = 64;     // channels per block\nconstexpr int U = 8; ")
# probes: each takes one piece of work out, so the values are wrong on purpose
_NO_REDUCE = ("      reduce_scatter<G / 2>(p, lane);\n", "")                        # partial sums stored as they are
_WKV_FEW_LOADS = ("    const int t = t_first + tk;\n", "    const int t = t_first;\n")  # one load set per group
_NO_MUFU = ("const float decay = ex2(dt[c] * a2[c][s]);", "const float decay = fmaf(dt[c], a2[c][s], 1.f);")
_SCAN_FEW_LOADS = ("    const int t = t_first + k;\n", "    const int t = t_first;\n")


def _wkv(ri: int, jc: int, *more):
    return ("wkv6", [(_WKV_PATCH, _WKV_PATCH.replace("RI = 4, JC = 2", f"RI = {ri}, JC = {jc}")), *more])


def _scan(dc: int, u: int, *more):
    return ("mamba_scan", [(_SCAN_TILE, _SCAN_TILE.replace("DC = 1;", f"DC = {dc};").replace("U = 8;", f"U = {u};")),
                           *more])


VARIANTS = {
    "wkv_patch_4x4": _wkv(4, 4),
    "wkv_patch_8x2": _wkv(8, 2),
    "wkv_patch_2x4": _wkv(2, 4),
    "wkv_stages3": _wkv(4, 2, ("NSTAGE = 2;", "NSTAGE = 3;")),
    "wkv_one_group_per_step": _wkv(4, 2, (_WKV_STEP, _WKV_ONE_GROUP)),
    "wkv_no_reduce": _wkv(4, 2, _NO_REDUCE),
    "wkv_few_loads": _wkv(4, 2, _WKV_FEW_LOADS),
    "wkv_few_loads_no_reduce": _wkv(4, 2, _WKV_FEW_LOADS, _NO_REDUCE),
    "wkv_long_at_decode": _wkv(4, 2, ("constexpr int SHORT_SEQ = 8;", "constexpr int SHORT_SEQ = 0;")),
    "wkv_short_whole_head": _wkv(4, 2, ("JC = 1, JB = C < 32 ? C : 32; };", "JC = 1, JB = C; };")),
    "wkv_short_identities": _wkv(4, 2, ("    if (SHORT && t >= n) {\n", "    if (false) {\n")),
    "scan_dc2_u4": _scan(2, 4),
    "scan_dc2_u8": _scan(2, 8),
    "scan_expf": _scan(1, 8, ("const float decay = ex2(dt[c] * a2[c][s]);",
                              "const float decay = expf(dt[c] * (a2[c][s] * 0.6931471805599453f));")),
    "scan_no_mufu": _scan(1, 8, _NO_MUFU),
    "scan_few_loads": _scan(1, 8, _SCAN_FEW_LOADS),
    "scan_few_loads_no_mufu": _scan(1, 8, _SCAN_FEW_LOADS, _NO_MUFU),
    "scan_long_at_decode": _scan(1, 8, ("return seq <= U ? launch_as", "return false ? launch_as")),
    "scan_short_two_groups": _scan(1, 8, ("    if (SHORT || n <= U) {\n", "    if (n <= U) {\n")),
    "scan_default_launch_bounds": _scan(1, 8, ("__launch_bounds__(Geometry<DS, SHORT>::NT, SHORT ? 512 / Geometry<DS, SHORT>::NT : 1)",
                                               "__launch_bounds__(Geometry<DS, SHORT>::NT)")),
    "scan_scalar_state_stores": _scan(1, 8, (
        "*reinterpret_cast<float4*>(row + (q * L + sg) * 4) = float4{o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]};",
        "for (int s = 0; s < 4; ++s) row[(q * L + sg) * 4 + s] = o[4 * q + s];")),
}
CHANGES = {
    "wkv_patch_4x4": "C = 64: 4 x 4 state patch per thread (16 elements, 16 lanes per column, 4 warps per SM)",
    "wkv_patch_8x2": "C = 64: 8 x 2 state patch per thread (16 elements, 8 lanes per column, 4 warps per SM)",
    "wkv_patch_2x4": "C = 64: 2 x 4 state patch per thread (8 elements, 32 lanes per column, 8 warps per SM)",
    "wkv_stages3": "3 tiles in the cp.async ring instead of 2 (55 KB of shared memory in bf16, over the default 48 KB)",
    "wkv_one_group_per_step": "one group of tokens per loop step instead of two",
    "wkv_no_reduce": "probe, wrong values: no reduce-scatter (each lane stores its partial sum)",
    "wkv_few_loads": "probe, wrong values: one load of r, k, w, v per group of tokens instead of per token",
    "wkv_few_loads_no_reduce": "probe, wrong values: one load set per group and no reduce-scatter",
    "wkv_long_at_decode": "the long geometry (4 x 2 patches, 32-token tiles) for calls of at most 8 tokens too",
    "wkv_short_whole_head": "short calls: one block of 256 threads per head (all C columns) instead of 32 columns",
    "wkv_short_identities": "short calls run a group's tokens past the end as identities instead of skipping them",
    "scan_dc2_u4": "2 channels x 4 states per thread (8 states, 4 warps per SM), 4 tokens per group",
    "scan_dc2_u8": "2 channels x 4 states per thread (8 states, 4 warps per SM), 8 tokens per group",
    "scan_expf": "the accurate expf of delta A instead of ex2.approx of delta A log2 e",
    "scan_no_mufu": "probe, wrong values: the decay as an FMA instead of ex2 (no MUFU)",
    "scan_few_loads": "probe, wrong values: one load of u, delta, B, C per group of tokens instead of per token",
    "scan_few_loads_no_mufu": "probe, wrong values: one load set per group and no MUFU",
    "scan_long_at_decode": "the long geometry (4 states per thread, 32-token tiles) for calls of at most 8 tokens too",
    "scan_short_two_groups": "short calls compile the two-group loop too, as long ones do",
    "scan_default_launch_bounds": "__launch_bounds__ with the block size alone (no blocks per SM asked)",
    "scan_scalar_state_stores": "h_fin stored one float at a time instead of one 16-byte chunk",
}


# (kernel, label, dtype, B, S, width, geometry), width = (H, C) for WKV and (di, ds) for the scan
SHAPES = [("wkv6", "rwkv6-long", "bfloat16", 1, 4096, (64, 64)),
          ("wkv6", "rwkv6-long", "float32", 1, 4096, (64, 64)),
          ("wkv6", "rwkv6-decode", "bfloat16", 4, 1, (64, 64)),
          ("mamba_scan", "jamba-long", "float32", 1, 4096, (8192, 16)),
          ("mamba_scan", "jamba-B4", "float32", 4, 1, (8192, 16))]


def device_us(torch, fn, kernel: str, reps: int = 20) -> float | None:
    """Mean device time of the launches of ``kernel`` in ``reps`` calls of fn, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events() if f"{kernel}_kernel" in e.name]
    return sum(times) / len(times) if times else None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, help="a checkout whose wkv6.cu and mamba_scan.cu are timed too")
    parser.add_argument("variants", nargs="*", metavar="VARIANT", help="time only these (default: all)")
    opts = parser.parse_args()
    if set(opts.variants) - set(VARIANTS):
        parser.error(f"unknown variants {sorted(set(opts.variants) - set(VARIANTS))}; known: {sorted(VARIANTS)}")
    import torch

    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    import repro_torch.kernels.mamba_scan as ms
    import repro_torch.kernels.wkv6 as wk
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    copies = cs.planted_sources({name: VARIANTS[name] for name in opts.variants or VARIANTS}, "variants")
    if opts.baseline:
        for kernel in ("wkv6", "mamba_scan"):
            lib = _build.BUILD_DIR / "variants" / f"baseline_{kernel}.so"
            copies[f"baseline_{kernel}"] = (opts.baseline / "src/repro_torch/kernels/csrc" / f"{kernel}.cu", lib)
    with ThreadPoolExecutor(max_workers=len(copies)) as pool:
        logs = dict(zip(copies, pool.map(lambda copy: _build.compile_source(*copy), copies.values())))
    for name, text in logs.items():  # each build's registers and spills, kernel by kernel
        kernels = [line.split("kernel", 1)[-1].split("EEEv")[0] for line in text.splitlines() if "Compiling entry" in line]
        usage = [line.split(":", 1)[-1].strip() for line in text.splitlines() if "registers" in line]
        spills = [line.strip() for line in text.splitlines() if "spill stores" in line]
        for kernel, regs, spill in zip(kernels, usage, spills):
            print(f"# ptxas {name} {kernel}: {regs}; {spill}", flush=True)
    modules = {"wkv6": wk, "mamba_scan": ms}
    committed = {kernel: mod._lib() for kernel, mod in modules.items()}
    card = cs.smi_line()
    for seed, (kernel, label, dtype, B, S, (width, depth)) in enumerate(SHAPES, start=300):
        mod = modules[kernel]
        paths = {name: lib for name, (_, lib) in copies.items() if VARIANTS.get(name, ("",))[0] == kernel}
        if opts.baseline:
            paths = {"baseline": copies[f"baseline_{kernel}"][1], **paths}
        names = list(paths)
        libs = {"committed": committed[kernel], **{name: mod._bind(ctypes.CDLL(str(lib))) for name, lib in paths.items()}}
        if kernel == "wkv6":
            chunk = cs.WKV_GEOMETRY["rwkv6"][2]
            r, k, v, w, u, s0 = cs.wkv6_case_inputs(torch, dtype, B, S, width, depth, "carried" if S == 1 else "zero",
                                                    seed)
            call = lambda: wk.wkv6(r, k, v, w, u, chunk=chunk, s0=s0)  # noqa: E731
            plain = wk.wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0)
            shape = f"{label} {dtype} B{B} S{S} H{width} C{depth}"
        else:
            chunk = cs.SCAN_GEOMETRY["jamba"][2]
            args = cs.mamba_case_inputs(torch, "jamba", B, S, width, depth, "carried" if S == 1 else "zero", seed)
            call = lambda: ms.mamba_scan(*args[:5], chunk=chunk, h0=args[5])  # noqa: E731
            plain = ms.mamba_scan_plain(*args[:5], chunk=chunk, h0=args[5])
            shape = f"{label} float32 B{B} S{S} di{width} ds{depth}"
        tols = [cs.scan_tol(p) for p in plain]
        rows = {}
        try:
            for name in ["committed", *names, "committed"]:
                mod._lib = lambda lib=libs[name]: lib
                got = call()
                torch.cuda.synchronize()
                row = rows.setdefault(name, dict(
                    outside_tol=sum(cs.n_outside(g, p, t) for g, p, t in zip(got, plain, tols)),
                    max_abs_err=max((g - p).abs().max().item() for g, p in zip(got, plain)), ms=[], device_us=[]))
                row["ms"].append(cs.cuda_ms(torch, call))
                row["device_us"].append(device_us(torch, call, kernel))
        finally:
            mod._lib = lambda lib=committed[kernel]: lib
        for name, row in rows.items():
            change = "the baseline checkout's source" if name == "baseline" else CHANGES.get(name, "none")
            print(json.dumps(dict(kernel=kernel, shape=shape, build=name, change=change,
                                  elements=sum(p.numel() for p in plain), tol=tols[0], card=card, **row)), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Hold variants of the WKV-6 and selective-scan sources against the committed kernels on one card.

    python3 scripts/scan_variants.py [--baseline CHECKOUT] [--kernels KERNEL ...] [VARIANT ...]

A variant is ``src/repro_torch/kernels/csrc/wkv6.cu``, ``wkv6_bwd.cu``,
``mamba_scan.cu`` or ``mamba_scan_bwd.cu`` with a few text replacements
(``VARIANTS`` below), written by ``chip_smoke.planted_sources`` into
``build/repro_torch/variants/`` and built as ``chip_smoke.py`` builds its
planted faults; naming variants times only those.  Variants named probes
compute wrong values on purpose: each takes one piece of work out to show what
it costs.  At the main path's long shapes, the decode shape and the training
shapes (rwkv6's bf16 B4 S2048 H64 C64 and jamba's f32 B4 S2048 di8192 ds16:
the serving form, the training form and the backward of each) each build is
checked at ``chip_smoke.py``'s gates (the elements outside them are counted,
not asserted; the scan backward against the exact gradients, its plain
version in f64) and timed in turns: committed, each variant, committed.
``--kernels`` keeps the shapes of the kernels named (``wkv6``, ``wkv6_train``,
``wkv6_bwd``, ``mamba_scan``, ``mamba_scan_train``, ``mamba_scan_bwd``).  Each
row gives the CUDA-event time of a whole call (``ms``; at the decode shape
mostly the host's launch), the kernel's own device time from
``torch.profiler`` (``device_us``, the mean over the profiled launches), and
the build's ptxas registers and spills for that shape's instantiations.
``--baseline CHECKOUT`` adds the four sources of another checkout (for example
the parent commit, unpacked with ``git archive`` into ``build/``) as the build
``baseline``, timed in the same turns: the kernels' C interfaces are the same.
It prints one JSON line per shape and build, then the card's ``nvidia-smi``
line.  Needs a CUDA card; imports nothing of JAX.
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
_WKV_STEP = """      float pa[G], pb[G];
      wkv_group<T, C, SHORT>(rs, ks, ws, vs, tt, n, row0, jl0, st, pa);
      finish(tt, pa);
      wkv_group<T, C, SHORT>(rs, ks, ws, vs, tt + TK, n, row0, jl0, st, pb);
      finish(tt + TK, pb);
    }
"""
_WKV_ONE_GROUP = """      float pa[G];
      wkv_group<T, C, SHORT>(rs, ks, ws, vs, tt, n, row0, jl0, st, pa);
      finish(tt, pa);
    }
"""
_WKV_LOOP = ("    for (int tt = 0; tt < n; tt += 2 * TK) {\n", "    for (int tt = 0; tt < n; tt += TK) {\n")
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
    "wkv_one_group_per_step": _wkv(4, 2, _WKV_LOOP, (_WKV_STEP, _WKV_ONE_GROUP)),
    "wkv_no_reduce": _wkv(4, 2, _NO_REDUCE),
    "wkv_few_loads": _wkv(4, 2, _WKV_FEW_LOADS),
    "wkv_few_loads_no_reduce": _wkv(4, 2, _WKV_FEW_LOADS, _NO_REDUCE),
    "wkv_long_at_decode": _wkv(4, 2, ("constexpr int SHORT_SEQ = 8;", "constexpr int SHORT_SEQ = 0;")),
    "wkv_short_whole_head": _wkv(4, 2, ("JC = 1, JB = C < 32 ? C : 32; };", "JC = 1, JB = C; };")),
    "wkv_short_identities": _wkv(4, 2, ("    if (SHORT && t >= n) {\n", "    if (false) {\n")),
    "wkv_bwd_launch1": ("wkv6_bwd", [("MIN_BLOCKS = C == 64 ? 2 : 1;", "MIN_BLOCKS = 1;")]),
    "wkv_bwd_unroll1": ("wkv6_bwd", [("#pragma unroll 2\n      for (int j = 0; j < C; j += 4) {", "#pragma unroll 1\n      for (int j = 0; j < C; j += 4) {"),
                                     ("#pragma unroll 2\n      for (int i = 0; i < C; i += 4) {", "#pragma unroll 1\n      for (int i = 0; i < C; i += 4) {")]),
    "wkv_bwd_no_recurrences": ("wkv6_bwd", [("    if (tid < 4 * C) {\n      float tp[TP];", "    if (false) {\n      float tp[TP];"),
                                            ("    if (tid < 4 * C) {\n      float nn[4]", "    if (false) {\n      float nn[4]")]),
    "wkv_bwd_no_products": ("wkv6_bwd", [("#pragma unroll 2\n      for (int j = 0; j < C; j += 4) {", "#pragma unroll 2\n      for (int j = 0; j < 0; j += 4) {"),
                                         ("#pragma unroll 2\n      for (int i = 0; i < C; i += 4) {", "#pragma unroll 2\n      for (int i = 0; i < 0; i += 4) {")]),
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
    # the scan backward: probes, then the designs its committed one was measured against
    "scan_bwd_no_mufu": ("mamba_scan_bwd", [("h[s] = fmaf(ex2(dt * a2[s]), h[s], x * bq[s]);",
                                             "h[s] = fmaf(fmaf(dt, a2[s], 1.f), h[s], x * bq[s]);"),
                                            ("const float a = ex2(dt * a2[s]);", "const float a = fmaf(dt, a2[s], 1.f);")]),
    "scan_bwd_no_bc_reduce": ("mamba_scan_bwd", [(
        "#pragma unroll\n      for (int j = 0; j < NS; ++j) pbc[j] += __shfl_xor_sync(0xffffffffu, pbc[j + NS], 16);\n"
        "      reduce_scatter<8, 4, 2>(pbc, lane);\n", "")]),
    "scan_bwd_no_du_reduce": ("mamba_scan_bwd", [("        reduce_scatter<L / 2, 1, UD>(pdu, lane);\n", "")]),
    "scan_bwd_no_recompute": ("mamba_scan_bwd", [("          h[s] = fmaf(ex2(dt * a2[s]), h[s], x * bq[s]);\n", "")]),
    "scan_bwd_state_plain_load": ("mamba_scan_bwd", [
        ("      cp_async16(hsh + tid * NS, h_chk", "      if (false) cp_async16(hsh + tid * NS, h_chk"),
        ("      load4(hsh + tid * NS, h);",
         "      load4(h_chk + (live ? (((size_t)b * nchunk + c) * di + ch) * DS + sg * NS : 0), h);"),
        ("        load4(hsh + tid * NS, ho);",
         "        load4(h_chk + (live ? (((size_t)b * nchunk + c) * di + ch) * DS + sg * NS : 0), ho);")]),
    "scan_bwd_one_block": ("mamba_scan_bwd", [("constexpr int MIN_BLOCKS = 2; ", "constexpr int MIN_BLOCKS = 1; ")]),
    "scan_bwd_cb128": ("mamba_scan_bwd", [("constexpr int CB = 64; ", "constexpr int CB = 128;"),
                                          ("constexpr int MIN_BLOCKS = 2; ", "constexpr int MIN_BLOCKS = 1; ")]),
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
    "wkv_bwd_launch1": "backward: __launch_bounds__ asking one block an SM (up to 255 registers)",
    "wkv_bwd_unroll1": "backward: the products' loops over C not unrolled (instead of twice)",
    "wkv_bwd_no_recurrences": "probe, wrong values: backward without the per-row token recurrences (dr, dk, dw)",
    "wkv_bwd_no_products": "probe, wrong values: backward without the products X, Y and Z",
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
    "scan_bwd_no_mufu": "probe, wrong values: backward with every decay as an FMA instead of ex2 (no MUFU)",
    "scan_bwd_no_bc_reduce": "probe, wrong values: backward without the dB / dC reduce-scatter across the warp's channels",
    "scan_bwd_no_du_reduce": "probe, wrong values: backward without the du / ddelta reduce-scatter across a channel's lanes",
    "scan_bwd_no_recompute": "probe, wrong values: backward without the recompute (every old state the saved one)",
    "scan_bwd_state_plain_load": "backward: the span's saved state loaded from device memory in front of the recompute "
                                 "instead of staged by cp.async with the tile",
    "scan_bwd_one_block": "backward: __launch_bounds__ asking one block an SM (up to 255 registers)",
    "scan_bwd_cb128": "backward: 128 channels a block (512 threads, one block an SM): half the dB / dC partials",
}


# (kernel, label, dtype, B, S, width), width = (H, C) for WKV and (di, ds) for the scan; the kernels
# "wkv6" and "mamba_scan" are the serving forms, "wkv6_train" and "mamba_scan_train" the training forms
# (the same sources), "wkv6_bwd" and "mamba_scan_bwd" the backwards
SHAPES = [("wkv6", "rwkv6-long", "bfloat16", 1, 4096, (64, 64)),
          ("wkv6", "rwkv6-long", "float32", 1, 4096, (64, 64)),
          ("wkv6", "rwkv6-decode", "bfloat16", 4, 1, (64, 64)),
          ("wkv6", "rwkv6-train", "bfloat16", 4, 2048, (64, 64)),
          ("wkv6_train", "rwkv6-train", "bfloat16", 4, 2048, (64, 64)),
          ("wkv6_bwd", "rwkv6-train", "bfloat16", 4, 2048, (64, 64)),
          ("mamba_scan", "jamba-long", "float32", 1, 4096, (8192, 16)),
          ("mamba_scan", "jamba-B4", "float32", 4, 1, (8192, 16)),
          ("mamba_scan_train", "jamba-train", "float32", 4, 2048, (8192, 16)),
          ("mamba_scan_bwd", "jamba-train", "float32", 4, 2048, (8192, 16))]


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


def ptxas_entries(text: str) -> dict:
    """{instantiation: "registers ...; spills ..."} from one build's nvcc -Xptxas -v log."""
    kernels = [line.split("kernel", 1)[-1].split("EEEv")[0] for line in text.splitlines() if "Compiling entry" in line]
    usage = [line.split(":", 1)[-1].strip() for line in text.splitlines() if "registers" in line]
    spills = [line.strip() for line in text.splitlines() if "spill stores" in line]
    return {kernel: f"{regs}; {spill}" for kernel, regs, spill in zip(kernels, usage, spills)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, help="a checkout whose wkv6.cu, wkv6_bwd.cu, mamba_scan.cu and "
                                                      "mamba_scan_bwd.cu are timed too")
    parser.add_argument("--kernels", nargs="+", choices=sorted({shape[0] for shape in SHAPES}),
                        help="time only the shapes of these kernels (default: all)")
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
    sources = ("wkv6", "wkv6_bwd", "mamba_scan", "mamba_scan_bwd")
    copies = cs.planted_sources({name: VARIANTS[name] for name in opts.variants or VARIANTS}, "variants")
    if opts.baseline:
        for source in sources:
            lib = _build.BUILD_DIR / "variants" / f"baseline_{source}.so"
            copies[f"baseline_{source}"] = (opts.baseline / "src/repro_torch/kernels/csrc" / f"{source}.cu", lib)
    with ThreadPoolExecutor(max_workers=len(copies) + 1) as pool:
        committed_builds = pool.submit(_build.build, sources)
        logs = dict(zip(copies, pool.map(lambda copy: _build.compile_source(*copy), copies.values())))
        logs.update({f"committed_{name}": res.log for name, res in committed_builds.result().items()})
    ptxas = {name: ptxas_entries(text) for name, text in logs.items()}
    for name, entries in ptxas.items():  # each build's registers and spills, kernel by kernel
        for kernel, usage in entries.items():
            print(f"# ptxas {name} {kernel}: {usage}", flush=True)
    # kernel: (source, module, the module's library getter, its binder)
    kinds = {"wkv6": ("wkv6", wk, "_lib", wk._bind), "wkv6_train": ("wkv6", wk, "_lib", wk._bind),
             "wkv6_bwd": ("wkv6_bwd", wk, "_bwd_lib", wk._bind_bwd), "mamba_scan": ("mamba_scan", ms, "_lib", ms._bind),
             "mamba_scan_train": ("mamba_scan", ms, "_lib", ms._bind),
             "mamba_scan_bwd": ("mamba_scan_bwd", ms, "_bwd_lib", ms._bind_bwd)}
    card = cs.smi_line()
    for seed, (kernel, label, dtype, B, S, (width, depth)) in enumerate(SHAPES, start=300):
        if opts.kernels and kernel not in opts.kernels:
            continue
        source, mod, getter, bind = kinds[kernel]
        committed = getattr(mod, getter)()
        paths = {name: lib for name, (_, lib) in copies.items() if VARIANTS.get(name, ("",))[0] == source}
        if opts.baseline:
            paths = {"baseline": copies[f"baseline_{source}"][1], **paths}
        names = list(paths)
        libs = {"committed": committed, **{name: bind(ctypes.CDLL(str(lib))) for name, lib in paths.items()}}
        if kernel == "wkv6_bwd":
            r, k, v, w, u, s0, dout, ds_fin = cs.wkv6_bwd_inputs(torch, dtype, B, S, width, depth, False, seed)
            _, _, s_chk = wk._launch(r, k, v, w, u, s0, train=True)
            call = lambda: wk.wkv6_bwd(r, k, v, w, u, s_chk, dout, ds_fin)  # noqa: E731
            plain = wk.wkv6_bwd_plain(r, k, v, w, u, s0, dout, ds_fin)
            tols = list(cs.wkv6_bwd_tols(dtype, plain).values())
            shape = f"{label} {dtype} B{B} S{S} H{width} C{depth}"
        elif kernel.startswith("wkv6"):
            chunk = cs.WKV_GEOMETRY["rwkv6"][2]
            r, k, v, w, u, s0 = cs.wkv6_case_inputs(torch, dtype, B, S, width, depth, "carried" if S == 1 else "zero",
                                                    seed)
            if kernel == "wkv6_train":
                call = lambda: wk._launch(r, k, v, w, u, s0, train=True)[:2]  # noqa: E731
            else:
                call = lambda: wk.wkv6(r, k, v, w, u, chunk=chunk, s0=s0)  # noqa: E731
            plain = wk.wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0)
            tols = [cs.scan_tol(p) for p in plain]
            shape = f"{label} {dtype} B{B} S{S} H{width} C{depth}"
        elif kernel == "mamba_scan_bwd":  # held against the exact gradients at chip_smoke.py's gate
            u, delta, A, Bm, Cm, h0, dy, dh_fin = cs.mamba_bwd_inputs(torch, "jamba", B, S, width, depth, False, seed)
            _, _, h_chk = ms._launch(u, delta, A, Bm, Cm, h0, train=True)
            call = lambda: ms.mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy, dh_fin)  # noqa: E731
            f32 = ms.mamba_scan_bwd_plain(u, delta, A, Bm, Cm, h0, dy, dh_fin)
            plain = cs.mamba_bwd_exact(ms, u, delta, A, Bm, Cm, h0, dy, dh_fin)
            tols = list(cs.mamba_bwd_tols(plain, f32).values())
            del f32
            shape = f"{label} float32 B{B} S{S} di{width} ds{depth}"
        else:
            chunk = cs.SCAN_GEOMETRY["jamba"][2]
            args = cs.mamba_case_inputs(torch, "jamba", B, S, width, depth, "carried" if S == 1 else "zero", seed)
            if kernel == "mamba_scan_train":
                call = lambda: ms._launch(*args, train=True)[:2]  # noqa: E731
            else:
                call = lambda: ms.mamba_scan(*args[:5], chunk=chunk, h0=args[5])  # noqa: E731
            plain = ms.mamba_scan_plain(*args[:5], chunk=chunk, h0=args[5])
            tols = [cs.scan_tol(p) for p in plain]
            shape = f"{label} float32 B{B} S{S} di{width} ds{depth}"
        tag = (f"Li{depth}",) + (("bfloat16" if dtype == "bfloat16" else "If",) if source.startswith("wkv6") else ())
        rows = {}
        try:
            for name in ["committed", *names, "committed"]:
                setattr(mod, getter, lambda lib=libs[name]: lib)
                got = call()
                torch.cuda.synchronize()
                row = rows.setdefault(name, dict(
                    outside_tol=sum(cs.n_outside(g, p, t) for g, p, t in zip(got, plain, tols)),
                    max_abs_err=max((g.float() - p.float()).abs().max().item() for g, p in zip(got, plain)),
                    ms=[], device_us=[]))
                row["ms"].append(cs.cuda_ms(torch, call))
                row["device_us"].append(device_us(torch, call, source))
        finally:
            setattr(mod, getter, lambda lib=committed: lib)
        for name, row in rows.items():
            change = "the baseline checkout's source" if name == "baseline" else CHANGES.get(name, "none")
            build = {"committed": f"committed_{source}", "baseline": f"baseline_{source}"}.get(name, name)
            regs = {kern: use for kern, use in ptxas.get(build, {}).items() if all(x in kern for x in tag)}
            print(json.dumps(dict(kernel=kernel, shape=shape, build=name, change=change,
                                  elements=sum(p.numel() for p in plain), tol=tols[0], ptxas=regs, card=card, **row)),
                  flush=True)
        del plain, call
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

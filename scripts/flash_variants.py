#!/usr/bin/env python3
"""Hold variants of the flash-attention sources against the committed kernels on one card.

    python3 scripts/flash_variants.py

A variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` (forward,
``VARIANTS``) or ``flash_attention_bwd.cu`` (backward, ``BWD_VARIANTS``) with
one or more text replacements, written and built as ``chip_smoke.py`` writes and builds
its planted faults, into ``build/repro_torch/variants/``.  At the main path's
long bf16 shapes (the forward's serve prompts, the backward's training shape)
each build is checked against the plain version at ``chip_smoke.py``'s gate
(the elements outside it are counted, not asserted: a variant may be wrong on
purpose; the backward counts dq, dk and dv apart) and timed with CUDA events
(the backward whole, all three kernels), in turns: committed, each variant,
committed.  It prints one JSON line per build with ptxas' registers and spills
of each tensor-core kernel, then one JSON line per shape and build, then the
card's ``nvidia-smi`` line.  Needs a CUDA card; imports nothing of JAX.

    python3 scripts/flash_variants.py --padding

prices the backward's head-dim padding alone (no variant is built): bf16 pads
hd to whole 64-column boxes, so stablelm-3b's hd 80 runs 128 columns.  At its
training shape (B4 S=T=2048 H32 Kv32, causal, softcap 0) and at hd 64, 80 and
128 it prints one JSON line each: the committed kernels' CUDA-event times, the
whole call's, the elements outside ``chip_smoke.py``'s gate, and SDPA's
backward through autograd (``is_causal``) on the same inputs.
"""

from __future__ import annotations

import ctypes
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: (kernel source, text of the committed source, its replacement), as chip_smoke.PLANTED
VARIANTS = {"p_hi_only": ("flash_attention", "      wgmma_rs<DV>(acc, p_lo[kb], vd);\n", "")}
_BWD = "flash_attention_bwd"
_DQ_PROB = "prob<CAP>(x[e], lse2[(e / 2) % 2], pre, post, p, pd);"
_DKDV_PROB = "prob<CAP>(x[e], lse_t[i] * LOG2E, pre, post, p, pd[e]);"
_DQ_DISPATCH = """\
        with_flags(use_cap, !inner, [&](auto cap_f, auto mask_f) {
          probs_by_query(cap_f, mask_f, x, lse2, pre, post, q0, k0, r0, c0, S, T_len, causal, window);
        });
"""
# dq's score loop as it stood before the softcap and the mask became compile-time choices
_DQ_PER_ELEMENT = """\
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = r0 + 8 * ((e / 2) % 2), j = 8 * (e / 4) + c0 + e % 2;
          float p, pd;
          if (use_cap) prob<true>(x[e], lse2[(e / 2) % 2], pre, post, p, pd);
          else prob<false>(x[e], lse2[(e / 2) % 2], pre, post, p, pd);
          x[e] = inner || live(q0 + i, k0 + j, S, T_len, causal, window) ? pd : 0.f;
        }
"""


def _dkdv_producer(setmaxnreg: bool) -> list:
    """dkdv in FlashAttention-3's form: a third warpgroup whose first warp loads every item into the
    ring (waiting on the empty barriers) while the two warpgroups of the committed kernel only
    compute; with setmaxnreg the producer gives its registers to them (24 against 240 a thread)."""
    dec, inc = (('    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n" ::: "memory");\n',
                 '  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n" ::: "memory");\n')
                if setmaxnreg else ("", ""))
    return [
        ("__global__ void __launch_bounds__(NTHREADS, 1)\nfa_bwd_dkdv_tc(",
         "__global__ void __launch_bounds__(NTHREADS + 128, 1)\nfa_bwd_dkdv_tc("),
        ("""  if (threadIdx.x < 32 && n_items > 0) {
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * TILE);
      tma_tile<NC>(k_s, &k_map, kv_full, kvh, k0, b);
      tma_tile<NC>(v_s, &v_map, kv_full, kvh, k0, b);
    }
    for (int it = 0; it < STAGES && it < n_items; ++it) load_item(it);
  }
""", """  if (threadIdx.x >= NTHREADS) {
""" + dec + """    if (threadIdx.x < NTHREADS + 32 && n_items > 0) {
      if (lane == 0) {
        mbar_arrive_tx(kv_full, 2 * TILE);
        tma_tile<NC>(k_s, &k_map, kv_full, kvh, k0, b);
        tma_tile<NC>(v_s, &v_map, kv_full, kvh, k0, b);
      }
      for (int it = 0; it < n_items; ++it) {
        if (it >= STAGES) mbar_wait(empty + 8 * (it % STAGES), (it / STAGES - 1) & 1);
        load_item(it);
      }
      asm volatile("cp.async.wait_all;\\n" ::: "memory");
    }
    return;
  }
""" + inc),
        ("      if (leave_stage(empty, released, st, (it / STAGES) & 1, lane) && it + STAGES < n_items) "
         "load_item(it + STAGES);\n",
         "      __syncwarp();\n      if (lane == 0) mbar_arrive(empty + 8 * st);\n"),
        ("kern<<<(unsigned)blocks, tc::NTHREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, lse, D, static_cast<bf*>(dk)",
         "kern<<<(unsigned)blocks, tc::NTHREADS + 128, smem, stream>>>(m.q, m.k, m.v, m.dout, lse, D, "
         "static_cast<bf*>(dk)"),
    ]


# the backward's variants; the probes ("bwd_probe_*") are wrong on purpose and only say where the time goes
BWD_VARIANTS = {
    "bwd_p_hi_only": (_BWD, "constexpr bool P_LO = true;", "constexpr bool P_LO = false;"),
    "bwd_ds_hi_only": (_BWD, "constexpr bool DS_LO = true;", "constexpr bool DS_LO = false;"),
    "bwd_dkdv_producer_setmaxnreg": (_BWD, _dkdv_producer(setmaxnreg=True)),
    "bwd_dkdv_producer": (_BWD, _dkdv_producer(setmaxnreg=False)),
    "bwd_probe_dq_tests_per_element": (_BWD, _DQ_DISPATCH, _DQ_PER_ELEMENT),
    "bwd_probe_no_transcendentals": (_BWD, [(_DQ_PROB, "p = pd = x[e] * 1e-3f;"),
                                            (_DKDV_PROB, "p = pd[e] = x[e] * 1e-3f;")]),
    "bwd_probe_no_second_products": (_BWD, [("accumulate<NC, P_LO>(acc, hi, lo, dot_s);", ""),
                                            ("accumulate<NC, DS_LO>(acc, hi, lo, qt_s);", ""),
                                            ("accumulate<NC, DS_LO>(acc, hi, lo, kt_s);", "")]),
}
CHANGES = {"p_hi_only": "P·V with P rounded to bf16 alone, without the lo part",
           "bwd_p_hi_only": "dv = pᵀ·do with p rounded to bf16 alone, without the lo part",
           "bwd_ds_hi_only": "dk = dsᵀ·q and dq = ds·k with ds rounded to bf16 alone, without the lo part",
           "bwd_dkdv_producer_setmaxnreg": "dkdv with a producer warpgroup (384 threads) that loads the ring, "
                                           "setmaxnreg 24 / 240 (FlashAttention-3's form)",
           "bwd_dkdv_producer": "dkdv with the same producer warpgroup, without setmaxnreg (168 registers a thread)",
           "bwd_probe_dq_tests_per_element": "probe: dq's softcap and mask tested at run time in each element's "
                                             "chain, as before they became compile-time choices (the same function)",
           "bwd_probe_no_transcendentals": "probe: p and p(1 - t²) replaced by a scaled score in both kernels "
                                           "(wrong on purpose)",
           "bwd_probe_no_second_products": "probe: dv, dk and dq never accumulated (wrong on purpose)"}

# label, B, S, H, Kv, hd, window, softcap: chip_smoke.py's long serve shapes and its ragged one
SHAPES = [("gemma2-serve-long", 1, 4608, 8, 4, 256, 4096, 50.0),
          ("gemma2-serve-long", 1, 4608, 8, 4, 256, 0, 50.0),
          ("jamba-serve-long", 1, 4096, 32, 8, 128, 0, 0.0),
          ("gemma2-ragged", 1, 4600, 8, 4, 256, 4096, 50.0)]
# B, S, H, Kv: stablelm-3b's training shape, priced at the head dims around its 80
PADDING_SHAPE, PADDING_HDS = (4, 2048, 32, 32), (64, 80, 128)
# label, B, S, H, Kv, hd, window, softcap: chip_smoke.py's backward cases at the training shape and its long one
BWD_SHAPES = [("gemma2-train", 4, 2048, 8, 4, 256, 4096, 50.0),
              ("gemma2-train-causal", 4, 2048, 8, 4, 256, 0, 0.0),
              ("gemma2-window-binds", 1, 4608, 8, 4, 256, 4096, 50.0)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.kernels import _build

    if "--padding" in sys.argv[1:]:
        card = cs.smi_line()
        padding_prices(torch, cs, fa, card)
        print(card)
        return 0
    copies = cs.planted_sources({**VARIANTS, **BWD_VARIANTS}, "variants")
    with ThreadPoolExecutor(max_workers=len(copies)) as pool:
        logs = dict(zip(copies, pool.map(lambda copy: _build.compile_source(*copy), copies.values())))
    card = cs.smi_line()
    committed_logs = {name: res.log for name, res in _build.build(["flash_attention", _BWD]).items()}
    for name, text in [*committed_logs.items(), *logs.items()]:
        print(json.dumps(dict(build=name, ptxas=ptxas_report(text), card=card)), flush=True)
    committed = fa._lib()
    libs = {"committed": committed, **{name: fa._bind(ctypes.CDLL(str(copies[name][1]))) for name in VARIANTS}}
    order = ["committed", *VARIANTS, "committed"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, S, H, Kv, hd, window, cap in SHAPES:
        q, k, v = cs.attention_inputs(torch, gen, "bfloat16", B, S, S, H, Kv, hd)
        kw = dict(causal=True, window=window, logit_softcap=cap, q_offset=0)
        plain = fa.flash_attention_plain(q, k, v, **kw)
        tol = cs.kernel_tol("bfloat16", plain)
        rows = {}
        try:
            for name in order:
                fa._lib = lambda lib=libs[name]: lib
                out = fa.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                row = rows.setdefault(name, dict(outside_tol=cs.n_outside(out, plain, tol),
                                                 max_abs_err=(out.float() - plain.float()).abs().max().item(),
                                                 ms=[]))
                row["ms"].append(cs.cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw)))
        finally:
            fa._lib = lambda: committed
        for name, row in rows.items():
            print(json.dumps(dict(shape=f"{label} bf16 B{B} S=T={S} H{H} Kv{Kv} hd{hd} window{window} cap{cap}",
                                  build=name, change=CHANGES.get(name, "none"),
                                  elements=plain.numel(), tol=tol, card=card, **row)), flush=True)
    backward_variants(torch, cs, fa, copies, card)
    print(card)
    return 0


def padding_prices(torch, cs, fa, card):
    """The committed backward at PADDING_SHAPE for each of PADDING_HDS, beside SDPA's backward."""
    import math

    import torch.nn.functional as F

    B, S, H, Kv = PADDING_SHAPE
    kw = dict(causal=True, window=0, logit_softcap=0.0)
    for seed, hd in enumerate(PADDING_HDS, start=700):
        q, k, v, do = cs.backward_inputs(torch, "bfloat16", B, S, H, Kv, hd, 1.0, seed)
        o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        outside = {g: cs.n_outside(got, want, cs.grad_tol("bfloat16", want))
                   for g, got, want in zip(("dq", "dk", "dv"), grads, plain)}
        del grads, plain
        launches, _ = fa.backward_launches(q, k, v, o, lse, do, **kw)
        row = dict(shape=f"backward bf16 B{B} S=T={S} H{H} Kv{Kv} hd{hd} causal cap0",
                   padded_hd=fa.backward_geometry(q.dtype, hd).hd, outside_tol=outside,
                   kernel_ms={kname: cs.cuda_ms(torch, launch) for kname, launch in launches},
                   backward_ms=cs.cuda_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)))
        row["kernels_ms"] = sum(row["kernel_ms"].values())
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=1.0 / math.sqrt(hd))
        doh = do.transpose(1, 2)
        row["library_ms"] = cs.cuda_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                                       max_reps=10)
        row.update(library="sdpa backward (autograd), is_causal", card=card)
        print(json.dumps(row), flush=True)
        del qh, kh, vh, out


def ptxas_report(log: str) -> dict:
    """{kernel (tc ones, as name<NC>): "N registers, its stack / spill line"} from nvcc's -Xptxas -v log."""
    report, current = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '[^']*?(fa_\w+?_tc)ILi(\d)E", line)
        if "Compiling entry function" in line:
            current = f"{found.group(1)}<{found.group(2)}>" if found else None
        elif current and "spill stores" in line:
            report[current] = line.strip()
        elif current and "Used " in line and " registers" in line:
            registers = line.split("Used ", 1)[1].split(" registers", 1)[0]
            report[current] = f"{registers} registers, {report.get(current, '')}"
    return report


def backward_variants(torch, cs, fa, copies, card):
    """The backward's variants at BWD_SHAPES, each against the committed kernels."""
    committed = fa._bwd_lib()
    libs = {"committed": committed, **{name: fa._bind_bwd(ctypes.CDLL(str(copies[name][1]))) for name in BWD_VARIANTS}}
    order = ["committed", *BWD_VARIANTS, "committed"]
    for seed, (label, B, S, H, Kv, hd, window, cap) in enumerate(BWD_SHAPES, start=500):
        q, k, v, do = cs.backward_inputs(torch, "bfloat16", B, S, H, Kv, hd, 1.0, seed)
        kw = dict(causal=True, window=window, logit_softcap=cap)
        o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        tols = [cs.grad_tol("bfloat16", w) for w in plain]
        rows = {}
        try:
            for name in order:
                fa._bwd_lib = lambda lib=libs[name]: lib
                grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                torch.cuda.synchronize()
                row = rows.setdefault(name, dict(
                    outside_tol={g: cs.n_outside(got, want, tol)
                                 for g, got, want, tol in zip(("dq", "dk", "dv"), grads, plain, tols)},
                    max_abs_err={g: (got.float() - want.float()).abs().max().item()
                                 for g, got, want in zip(("dq", "dk", "dv"), grads, plain)},
                    ms=[]))
                row["ms"].append(cs.cuda_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)))
                launches, _ = fa.backward_launches(q, k, v, o, lse, do, **kw)
                for kname, launch in launches:
                    row.setdefault(f"{kname}_ms", []).append(cs.cuda_ms(torch, launch))
        finally:
            fa._bwd_lib = lambda: committed
        for name, row in rows.items():
            print(json.dumps(dict(shape=f"backward {label} bf16 B{B} S=T={S} H{H} Kv{Kv} hd{hd} window{window} cap{cap}",
                                  build=name, change=CHANGES.get(name, "none"),
                                  elements=[w.numel() for w in plain], tol=tols, card=card, **row)), flush=True)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build    — nvcc builds every kernel source under src/repro_torch/kernels/csrc and
              the planted-fault copies below, one nvcc per source, all at once,
              printing the build time and ptxas' register / shared-memory report;
3. kernels  — each kernel's wrapper against its plain PyTorch version on the card,
              at the smoke shape, the full model's geometry and the serve paths' own
              shapes, with the stated tolerance; one JSON line per case with
              kernel, plain, library (one PyTorch call, where there is one) and
              bound times; flash rows also give the kernel variant that the
              launch counters show ran (bf16 must run the tensor-core kernel, f32
              the scalar one), TFLOP/s of the bound's work, and for a plain causal
              mask SDPA with is_causal=True; WKV-6 and the selective scan at the
              scan tolerance, their tiles' tails included (S = 4095, the smoke
              C = 16, a ragged di of 200 and 202);
   backward — the flash-attention backward's three kernels (D = rowsum(do o), dk / dv, dq)
              against flash_attention_bwd_plain, with the forward's log-sum-exp against the plain
              one: the smoke shape, gemma2's training shape (bf16 B4 S=T=2048 H8 Kv4 hd256,
              softcap 50) with window 4096 and 0, B1 S=T=4608 where the window binds, B2 with a
              ragged S=300, and f32 at S=320; gates per gradient, atol 2e-2 x rms(plain) with rtol
              2e-2 in bf16 and 2e-5 scaled the same way in f32; CUDA-event times of each kernel and
              of the whole backward against its bound and the plain version, which the backward
              must beat at gemma2's training shape;
   planted  — copies of the kernels with a fault built in must fail the same gates:
              flash attention that (a) skips the last live KV tile of every block or
              (b) treats the diagonal tiles as interior and skips their causal mask,
              WKV-6 that (a) drops the bonus u, (b) ignores s0 or (c) resets its
              state halfway through the sequence, and the selective scan that
              (a) drops the drive, (b) ignores h0 or (c) resets its state halfway, and the flash
              backward that (a) drops the softcap's derivative, (b) takes dk and dv from the first
              query head of each group only or (c) leaves D out of ds (q scaled by 4, so that the
              softcap's derivative matters);
4. serve    — gemma2-2b at full width (26 layers, bf16 compute, f32 weights from a
              seeded torch.Generator) through ServeEngine: 8 prompts of 4-24 tokens,
              4 slots, 16 new tokens, greedy; flash attention must launch exactly 26
              times per prefill, every launch on the tensor-core kernel, and WKV-6
              never;
5. long     — one 4608-token prompt (max_len 8192): the local layers' 4096 window
              binds inside the kernel and their ring cache is used;
6. check    — the card's logits against the CPU's (plain attention) on the same
              weights: the full-width model in f32 and the smoke model, at the
              reference's 2e-3;
7. rwkv6    — rwkv6-7b at full width (32 layers, 7.27 B parameters, bf16 compute):
              rwkv6-serve as in phase 4, with WKV-6 launched exactly 32 times per
              prefill and per decode step and flash attention never; rwkv6-long, one
              4096-token prompt (16 chunks of the plain version's 256); rwkv6-check,
              card against CPU at 2e-3 on a 2-layer cut of the full width in f32 over
              a 300-token prompt (the CPU's plain scan crosses a chunk boundary into a
              padded tail) plus 2 decode steps, and on the smoke model over 20 steps;
8. jamba    — jamba-v0.1-52b cut to 2 of its 4 units (16 layers, 25.8 B parameters),
              every width full, the reference's param_dtype="bfloat16" weights drawn
              leaf by leaf: jamba-serve as in phase 4, with the selective scan launched
              exactly 14 times and flash attention 2 times per prefill and neither per
              decode step (decode is the reference's elementwise step), every flash
              launch on the tensor-core kernel; jamba-long, one
              4096-token prompt (MoE capacity 640); jamba-check, card against CPU at
              2e-3 on a full-width 2-layer cut that keeps pattern positions 3 and 4
              (mamba + moe, attention + dense) in f32 over a 300-token prompt plus 2
              decode steps, and on the smoke model over 20 steps;
9. train    — gemma2-2b training at full width and depth (26 layers, f32 master weights, bf16
              compute, remat="unit") through the training launcher's Trainer: 8 steps at global
              batch 4 x seq 2048 of SyntheticLM(period=16, vocab_eff=256); every loss and grad
              norm finite, the last loss below the first, and per step (one microbatch) flash
              attention's forward launched exactly 52 times (26 + 26 recomputed) and each
              backward kernel exactly 26 times; step ms, tok/s and the peak device memory;
10. train-check — card against CPU in f32 on a full-width cut to one unit (2 layers, local and
              global), B1 S320, loss chunk 64: the loss within rtol 1e-5 and every gradient leaf
              within ||card - cpu|| / ||cpu|| <= 1e-4; then 3 Trainer steps of the smoke model on
              both, losses within rtol 1e-4;
11. library — SDPA's backward through autograd at each backward case (softcap 0, the same
              mask; is_causal for a plain causal one), the backward's library yardstick.  It runs
              last: autograd leaves a cuBLAS workspace on its own thread, which would raise every
              later phase's peak.

It ends with the kernels' JSON line, the nvidia-smi line, and the line
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repository's src/ next to it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
F32_TOL = dict(atol=2e-5, rtol=2e-5)     # the reference's kernel tolerance (tests/test_kernels.py)
BF16_REL = 2e-2                          # the reference's bf16 tolerance, taken relative to the output
SCAN_REL = 1e-4                          # the reference's scan tolerance, taken relative to the output
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)   # the reference's prefill/decode tolerance
HBM_BYTES_PER_S = 3.35e12                # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 outside them
GRAD_REL = {"bfloat16": 2e-2, "float32": 2e-5}  # the backward's gates, both taken relative to the rms of plain
LOSS_RTOL = 1e-5                         # the reference's loss tolerance (tests/test_train.py)
GRAD_LEAF_REL = 1e-4                     # card vs CPU, per gradient leaf: ||card - cpu|| / ||cpu||


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, budget_s: float = 0.3, max_reps: int = 20) -> float:
    """Mean device time of fn() from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = start.elapsed_time(end)
    reps = max(1, min(max_reps, int(budget_s * 1e3 / max(one, 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_tol(dtype: str, plain) -> dict:
    """The gate for kernel vs plain.

    Both compute in f32 and round the output to the input dtype once, so in
    bf16 they differ by at most one bf16 step of the output (<= 2**-7 |out|).
    At the long shapes |out| is about 0.03, so the reference's bf16 2e-2 taken
    as an absolute bound would be as large as the values it compares: it is
    scaled here by the rms of the plain output, which keeps it 2e-2 at the
    reference's small shapes (|out| of order 1) and tightens it at long ones.
    """
    if dtype == "float32":
        return dict(F32_TOL)
    rms = plain.float().pow(2).mean().sqrt().item()
    return dict(atol=BF16_REL * rms, rtol=BF16_REL)


def n_outside(got, want, tol) -> int:
    got, want = got.float(), want.float()
    bad = ((got - want).abs() > tol["atol"] + tol["rtol"] * want.abs()) | ~got.isfinite()
    return int(bad.sum())


def check_close(name: str, got, want, tol) -> float:
    err = (got.float() - want.float()).abs().max().item()
    if n_outside(got, want, tol):
        raise AssertionError(f"{name}: max |err| {err:.3e} beyond {tol} (or non-finite)")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------


def attention_cases():
    """(label, dtype, B, S, T, H, Kv, hd, window, cap, q_offset, causal)."""
    cases = [("smoke", "float32", 2, 64, 64, 4, 2, 16, 0, 0.0, 0),
             ("smoke", "bfloat16", 2, 64, 64, 4, 2, 16, 0, 0.0, 0)]
    for dtype in ("bfloat16", "float32"):
        for window in (4096, 0):
            for S in (23, 1024, 8192):
                cases.append(("gemma2", dtype, 1, S, S, 8, 4, 256, window, 50.0, 0))
        cases.append(("gemma2-q_offset", dtype, 1, 512, 1536, 8, 4, 256, 4096, 50.0, 1024))
    for window in (4096, 0):  # the long-prompt serve phase's own shapes
        cases.append(("gemma2-serve-long", "bfloat16", 1, 4608, 4608, 8, 4, 256, window, 50.0, 0))
    cases.append(("jamba-serve-long", "bfloat16", 1, 4096, 4096, 32, 8, 128, 0, 0.0, 0))  # jamba's attention layer
    for dtype in ("bfloat16", "float32"):  # jamba-serve's prompts (one partial tile) and jamba-check's 300 tokens
        for S in (4, 23, 300):
            cases.append(("jamba", dtype, 1, S, S, 32, 8, 128, 0, 0.0, 0))
    for dtype in ("bfloat16", "float32"):  # stablelm-3b's geometry: hd 80 ends in a partial 64-column box
        for S in (23, 1024):
            cases.append(("stablelm", dtype, 1, S, S, 32, 32, 80, 0, 0.0, 0))
    # a window that no tile size divides, and a ragged S that is not a multiple of the 128-row q tile
    cases.append(("gemma2-window100", "bfloat16", 1, 1024, 1024, 8, 4, 256, 100, 50.0, 0))
    cases.append(("gemma2-ragged", "bfloat16", 1, 4600, 4600, 8, 4, 256, 4096, 50.0, 0))
    cases = [case + (True,) for case in cases]
    # the tensor-core kernel's other paths: small head dims (8 pads the contraction to 16, the
    # wrapper pads 12 to 16), two batch rows with a ragged S, and a bidirectional mask with T != S
    for dtype in ("bfloat16", "float32"):
        for hd in (8, 12, 32):
            cases.append((f"hd{hd}", dtype, 1, 200, 200, 4, 2, hd, 0, 50.0, 0, True))
        cases.append(("B2-ragged", dtype, 2, 300, 300, 8, 4, 256, 0, 50.0, 0, True))
        cases.append(("bidirectional", dtype, 2, 130, 260, 4, 4, 128, 0, 0.0, 0, False))
    return cases


def live_pairs(torch, B, S, T, H, window, q_offset=0, causal=True):
    """(query, key) pairs the mask keeps, over all batch rows and heads."""
    q_pos = q_offset + torch.arange(S, dtype=torch.float64)
    lo = (q_pos - window + 1).clamp(min=0) if window else torch.zeros_like(q_pos)
    hi = q_pos.clamp(max=T - 1) if causal else torch.full_like(q_pos, T - 1)
    return float((hi - lo + 1).clamp(min=0).sum()) * B * H


def attention_bound(torch, dtype, B, S, T, H, Kv, hd, window, q_offset, causal=True):
    """Least time for the work this mask needs: max(bytes / HBM rate, FLOP / peak), and the FLOP."""
    pairs = live_pairs(torch, B, S, T, H, window, q_offset, causal)
    flops = 4.0 * hd * pairs                              # QK^T and PV, 2 FLOP per MAC
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (2 * B * S * H * hd + 2 * B * T * Kv * hd)  # q, out, k, v once each
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops


def attention_inputs(torch, gen, dtype, B, S, T, H, Kv, hd):
    dt = getattr(torch, dtype)
    return tuple(torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dt)
                 for shape in ((B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd)))


def run_kernel_cases(torch, card):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, dtype, B, S, T, H, Kv, hd, window, cap, q_offset, causal in attention_cases():
        q, k, v = attention_inputs(torch, gen, dtype, B, S, T, H, Kv, hd)
        kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=q_offset)
        name = (f"{label} {dtype} B{B} S{S} T{T} H{H} Kv{Kv} hd{hd} window{window} cap{cap} q_offset{q_offset}"
                + ("" if causal else " bidirectional"))
        flash_attention.launches_wgmma = flash_attention.launches_scalar = 0
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        moved = {"wgmma": flash_attention.launches_wgmma, "scalar": flash_attention.launches_scalar}
        expected = "wgmma" if dtype == "bfloat16" else "scalar"  # the wrapper's fixed rule, held to the counters
        if moved != {kind: int(kind == expected) for kind in moved}:
            raise AssertionError(f"{name}: launches by kernel {moved}; expected one launch of the {expected} kernel")
        plain = flash_attention_plain(q, k, v, **kw)
        tol = kernel_tol(dtype, plain)
        err = check_close(name, out, plain, tol)
        kernel_ms = cuda_ms(torch, lambda: flash_attention(q, k, v, **kw))
        plain_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, **kw), max_reps=5)
        # the library yardstick: SDPA with the same masks but softcap 0, since no
        # single PyTorch call computes softcapped attention
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        q_pos = q_offset + torch.arange(S, device="cuda")[:, None]
        k_pos = torch.arange(T, device="cuda")[None, :]
        mask = k_pos <= q_pos if causal else torch.ones((S, T), dtype=torch.bool, device="cuda")
        if window:
            mask &= k_pos > q_pos - window
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1.0 / math.sqrt(hd), enable_gqa=True), max_reps=5)
        # a plain causal mask also has SDPA's own causal path, with no mask tensor: a stronger yardstick
        library_causal_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, scale=1.0 / math.sqrt(hd), enable_gqa=True),
            max_reps=5) if causal and not window and not q_offset and S == T else None
        bound_ms, bound_by, flops = attention_bound(torch, dtype, B, S, T, H, Kv, hd, window, q_offset, causal)
        row = dict(case=name, dtype=dtype, S=S, T=T, window=window, q_offset=q_offset, causal=causal,
                   variant=next(kind for kind, n in moved.items() if n),
                   max_abs_err=err, tol=tol, kernel_ms=kernel_ms, tflops=flops / kernel_ms / 1e9,
                   plain_ms=plain_ms, library_ms=library_ms, library="sdpa, same mask, softcap 0",
                   library_causal_ms=library_causal_ms, bound_ms=bound_ms, bound_by=bound_by, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


# planted faults, by the copy's name: (kernel source, text of the source, its faulty replacement);
# planted_sources also takes (kernel source, [(text, replacement), ...]) for several edits
PLANTED = {
    "flash_skip_last_tile": ("flash_attention", "const int kt_end = k_hi > k_lo ? (k_hi - 1) / BK + 1 : kt_begin;",
                             "const int kt_end = k_hi > k_lo ? (k_hi - 1) / BK : kt_begin;"),
    "flash_diagonal_as_interior": ("flash_attention", "(!causal || k0 + BK - 1 <= wq_lo)", "true"),
    "wkv6_no_bonus": ("wkv6", "p[0] + bonus[t] * vj", "p[0]"),
    "wkv6_ignores_s0": ("wkv6", "const bool has_s0 = s0 != nullptr;", "const bool has_s0 = false;"),
    "wkv6_reset_halfway": ("wkv6", "    for (int tt = 0; tt < n; tt += 2 * TK) {\n",
                           "    for (int tt = 0; tt < n; tt += 2 * TK) {\n"
                           "      if (t0 + tt == seq / 2) {\n"
                           "#pragma unroll\n"
                           "        for (int a = 0; a < RI; ++a)\n"
                           "#pragma unroll\n"
                           "          for (int c = 0; c < JC; ++c) st[a][c] = 0.f;\n"
                           "      }\n"),
    "mamba_no_drive": ("mamba_scan", "h[c][s] = fmaf(decay, h[c][s], du * bq[s]);", "h[c][s] = decay * h[c][s];"),
    "mamba_ignores_h0": ("mamba_scan", "const bool has_h0 = h0 != nullptr;", "const bool has_h0 = false;"),
    "mamba_reset_halfway": ("mamba_scan", "    for (int tt = 0; tt < n; tt += 2 * U) {\n",
                            "    for (int tt = 0; tt < n; tt += 2 * U) {\n"
                            "      if (t0 + tt == seq / 2) {\n"
                            "#pragma unroll\n"
                            "        for (int c = 0; c < DC; ++c)\n"
                            "#pragma unroll\n"
                            "          for (int s = 0; s < NS; ++s) h[c][s] = 0.f;\n"
                            "      }\n"),
    "flash_bwd_no_softcap_derivative": ("flash_attention_bwd", "dcap = 1.f - t * t;", "dcap = 1.f;"),
    "flash_bwd_first_head_only": ("flash_attention_bwd", "const int n_items = group * nq;",
                                  "const int n_items = nq;"),
    "flash_bwd_no_D": ("flash_attention_bwd", "ds = p * (dp - d_i) * dcap;", "ds = p * dp * dcap;"),
}


def planted_sources(table=PLANTED, folder="planted"):
    """Write each edited copy of ``table`` under build/repro_torch/<folder>/ (never into
    the source tree); each text must appear in the source exactly once, before its edit.
    Returns {name: (src, lib)}."""
    from repro_torch.kernels import _build

    out = {}
    for name, (kernel, *edit) in table.items():
        src = (_build.CSRC / f"{kernel}.cu").read_text()
        for good, bad in (edit[0] if len(edit) == 1 else [edit]):
            if src.count(good) != 1:
                raise AssertionError(f"{folder} {name}: {good!r} is not in {kernel}.cu exactly once")
            src = src.replace(good, bad)
        path = _build.BUILD_DIR / folder / f"{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        out[name] = (path, path.with_suffix(".so"))
    return out


def build_everything(card):
    """The kernels of the port and the planted copies: one nvcc per source, all started together."""
    from repro_torch.kernels import _build

    planted = planted_sources()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1 + len(planted)) as pool:
        main = pool.submit(_build.build_all)
        logs = {name: pool.submit(_build.compile_source, src, lib) for name, (src, lib) in planted.items()}
        builds = main.result()
        for fut in logs.values():
            fut.result()
    log("build", f"{sorted(builds)} and {len(planted)} planted copies built in "
                 f"{time.perf_counter() - t0:.1f} s on {card} (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for res in builds.values():
        for line in res.log.splitlines():
            if any(key in line for key in ("Compiling entry", "registers", "spill")):
                log("build", f"{res.name}: {line.strip()}")
    return {name: lib for name, (_, lib) in planted.items()}


def planted_fault_check(torch, card, planted):
    """Each faulty build of the tensor-core flash kernel must fail the bf16 gate."""
    import ctypes

    import repro_torch.kernels.flash_attention as fa

    B, S, H, Kv, hd = 1, 4608, 8, 4, 256
    kw = dict(causal=True, window=4096, logit_softcap=50.0, q_offset=0)
    q, k, v = attention_inputs(torch, torch.Generator(device="cuda").manual_seed(1),
                               "bfloat16", B, S, S, H, Kv, hd)
    plain = fa.flash_attention_plain(q, k, v, **kw)
    tol = kernel_tol("bfloat16", plain)
    checks = (("flash_skip_last_tile", "the KV loop stops one tile early"),
              ("flash_diagonal_as_interior", "diagonal tiles are taken as interior: their causal mask is skipped"))
    for name, fault in checks:
        lib = fa._bind(ctypes.CDLL(str(planted[name])))
        good_lib, fa._lib = fa._lib, lambda: lib
        try:
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
        finally:
            fa._lib = good_lib
        err = (out.float() - plain.float()).abs().max().item()
        bad, bad_fixed = n_outside(out, plain, tol), n_outside(out, plain, dict(atol=2e-2, rtol=2e-2))
        log("planted", json.dumps(dict(
            fault=f"flash attention: {fault}", case=f"bfloat16 B{B} S=T={S} H{H} Kv{Kv} hd{hd} window4096 cap50",
            max_abs_err=err, tol=tol, outside_tol=bad, outside_fixed_tol=bad_fixed, elements=out.numel(),
            card=card)))
        if not bad:
            raise AssertionError(f"planted {name}: the bf16 gate passed a kernel where {fault}")


# ---------------------------------------------------------------------------
# phase 3, flash attention backward: kernels vs plain, and their planted faults
# ---------------------------------------------------------------------------


def backward_cases():
    """(label, dtype, B, S, H, Kv, hd, window, cap): the smoke shape; gemma2's training shape
    (B4 S=T=2048) with its local window (4096, wider than the sequence) and with none; one
    4608-token sequence, where the window binds; two rows of a ragged 300; f32 at 320."""
    return [("smoke", "bfloat16", 2, 64, 4, 2, 16, 0, 0.0),
            ("smoke", "float32", 2, 64, 4, 2, 16, 0, 0.0),
            ("gemma2-train", "bfloat16", 4, 2048, 8, 4, 256, 4096, 50.0),
            ("gemma2-train", "bfloat16", 4, 2048, 8, 4, 256, 0, 50.0),
            ("gemma2-window-binds", "bfloat16", 1, 4608, 8, 4, 256, 4096, 50.0),
            ("gemma2-B2-ragged", "bfloat16", 2, 300, 8, 4, 256, 0, 50.0),
            ("gemma2-f32", "float32", 1, 320, 8, 4, 256, 4096, 50.0)]


def backward_inputs(torch, dtype, B, S, H, Kv, hd, q_scale, seed):
    """q (times q_scale), k, v and the output's gradient do, N(0, 1) in dtype."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = (q_scale * torch.randn((B, S, H, hd), generator=gen, device="cuda")).to(dt)
    k, v = (torch.randn((B, S, Kv, hd), generator=gen, device="cuda").to(dt) for _ in range(2))
    do = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt)
    return q, k, v, do


def grad_tol(dtype: str, plain) -> dict:
    """The backward's gate for one gradient (or the LSE): atol GRAD_REL x rms(plain), rtol GRAD_REL."""
    rms = plain.float().pow(2).mean().sqrt().item()
    return dict(atol=GRAD_REL[dtype] * rms, rtol=GRAD_REL[dtype])


def backward_bounds(torch, dtype, B, S, H, Kv, hd, window):
    """{kernel: (least ms, "bytes" or "operations")} for each backward kernel and the whole.

    FLOP per live pair, 2 hd per product: the whole needs s, dp, dv, dk and dq (five);
    dk / dv alone s, dp, dv, dk (four), dq alone s, dp, dq (three).  Bytes, each once: the
    whole reads q, k, v, o, do and the f32 lse and writes dq, dk, dv; the row-dot kernel reads
    o and do and writes D; dk / dv read q, k, v, do, lse, D and write dk, dv; dq reads the
    same and writes dq.
    """
    pairs = live_pairs(torch, B, S, S, H, window)
    elt = 2 if dtype == "bfloat16" else 4
    nq, nkv, nrow = elt * B * S * H * hd, elt * B * S * Kv * hd, 4 * B * H * S
    work = {"rowdot": (2 * nq + nrow, 2.0 * B * S * H * hd),
            "dkdv": (2 * nq + 4 * nkv + 2 * nrow, 8.0 * hd * pairs),
            "dq": (3 * nq + 2 * nkv + 2 * nrow, 6.0 * hd * pairs),
            "backward": (4 * nq + 4 * nkv + nrow, 10.0 * hd * pairs)}
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        out[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def bwd_counts():
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    return {name: getattr(flash_attention_bwd, f"launches_{name}") for name in ("rowdot", "dkdv", "dq")}


def run_backward_cases(torch, card):
    import repro_torch.kernels.flash_attention as fa

    rows = []
    for seed, (label, dtype, B, S, H, Kv, hd, window, cap) in enumerate(backward_cases(), start=300):
        q, k, v, do = backward_inputs(torch, dtype, B, S, H, Kv, hd, 1.0, seed)
        kw = dict(causal=True, window=window, logit_softcap=cap)
        name = f"{label} {dtype} B{B} S=T={S} H{H} Kv{Kv} hd{hd} window{window} cap{cap}"
        o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        plain_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)[1]
        before = bwd_counts()
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        moved = {n: c - before[n] for n, c in bwd_counts().items()}
        if moved != {"rowdot": 1, "dkdv": 1, "dq": 1}:
            raise AssertionError(f"{name}: backward launches {moved}; expected one of each kernel")
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        errs, tols = {}, {}
        for gname, got, want in zip(("lse", "dq", "dk", "dv"), (lse, *grads), (plain_lse, *plain)):
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {gname}: {got.dtype} {tuple(got.shape)}, plain {want.dtype} "
                                     f"{tuple(want.shape)}")
            tols[gname] = grad_tol(dtype, want)
            errs[gname] = check_close(f"{name} {gname}", got, want, tols[gname])
        launches, _ = fa.backward_launches(q, k, v, o, lse, do, **kw)
        kernel_ms = {kname: cuda_ms(torch, launch) for kname, launch in launches}
        backward_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        forward_ms = cuda_ms(torch, lambda: fa.flash_attention_with_lse(q, k, v, **kw))
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw), max_reps=5)
        bounds = backward_bounds(torch, dtype, B, S, H, Kv, hd, window)
        row = dict(case=name, label=label, dtype=dtype, B=B, S=S, H=H, Kv=Kv, hd=hd, window=window, cap=cap,
                   seed=seed, max_abs_err=errs, tol=tols, kernel_ms=kernel_ms, backward_ms=backward_ms,
                   forward_with_lse_ms=forward_ms,
                   plain_ms=plain_ms, plain="flash_attention_bwd_plain (all three gradients)",
                   bound_ms={n: b[0] for n, b in bounds.items()}, bound_by={n: b[1] for n, b in bounds.items()},
                   card=card)
        print(json.dumps(row), flush=True)
        if label == "gemma2-train" and not backward_ms < plain_ms:
            raise AssertionError(f"{name}: the backward kernels take {backward_ms:.3f} ms, no faster than "
                                 f"their plain version's {plain_ms:.3f} ms")
        rows.append(row)
    return rows


def backward_planted_checks(torch, card, planted):
    """Each faulty build of the backward must put elements of dq, dk or dv outside the bf16 gate,
    where the committed build puts none: gemma2's geometry, q scaled by 4 so that 1 - t² is far from 1."""
    import ctypes

    import repro_torch.kernels.flash_attention as fa

    B, S, H, Kv, hd = 1, 2048, 8, 4, 256
    kw = dict(causal=True, window=0, logit_softcap=50.0)
    q, k, v, do = backward_inputs(torch, "bfloat16", B, S, H, Kv, hd, 4.0, seed=400)
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    tols = [grad_tol("bfloat16", w) for w in plain]

    def outside(grads):
        return {g: n_outside(got, want, tol) for g, got, want, tol in zip(("dq", "dk", "dv"), grads, plain, tols)}

    good = outside(fa.flash_attention_bwd(q, k, v, o, lse, do, **kw))
    if any(good.values()):
        raise AssertionError(f"planted: the committed backward fails its own gate at q x 4: {good}")
    case = f"bfloat16 B{B} S=T={S} H{H} Kv{Kv} hd{hd} window0 cap50, q x 4"
    checks = (("flash_bwd_no_softcap_derivative", "the softcap's derivative 1 - t^2 is dropped"),
              ("flash_bwd_first_head_only", "dk and dv come from the first query head of each group only"),
              ("flash_bwd_no_D", "D = rowsum(do o) is left out of ds"))
    for name, fault in checks:
        lib = fa._bind_bwd(ctypes.CDLL(str(planted[name])))
        good_lib, fa._bwd_lib = fa._bwd_lib, lambda: lib
        try:
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
        finally:
            fa._bwd_lib = good_lib
        bad = outside(grads)
        log("planted", json.dumps(dict(fault=f"flash backward: {fault}", case=case, outside_tol=bad,
                                       committed_outside_tol=good, elements=[g.numel() for g in grads],
                                       tol=tols, card=card)))
        if not any(bad.values()):
            raise AssertionError(f"planted {name}: the backward gate passed a kernel where {fault}")


# ---------------------------------------------------------------------------
# phase 3, WKV-6: kernel vs plain at the scan tolerance, and its planted faults
# ---------------------------------------------------------------------------

WKV_GEOMETRY = {"smoke": (4, 16, 16), "rwkv6": (64, 64, 256)}  # H, C, the plain version's chunk


def wkv6_cases():
    """(label, dtype, B, S, H, C, chunk, s0): the reference's smoke case, the full
    width at S in {1, 23, 256, 4096}, and decode at 4 slots; bf16 and f32 each.
    Then the tiling's tails, appended so that the earlier cases keep their seeds:
    S = 4095 (a last tile of 31 tokens, whose last step holds 15) at the full width and
    at the smoke C = 16; and a 7-token call at 2 slots, which takes the short geometry of
    calls of at most 8 tokens in two groups of 4."""
    cases = []
    for dtype in ("bfloat16", "float32"):
        for s0 in ("zero", "carried"):
            cases.append(("smoke", dtype, 2, 64, *WKV_GEOMETRY["smoke"], s0))
            for S in (1, 23, 256, 4096):
                cases.append(("rwkv6", dtype, 1, S, *WKV_GEOMETRY["rwkv6"], s0))
        cases.append(("rwkv6-decode", dtype, 4, 1, *WKV_GEOMETRY["rwkv6"], "carried"))
    for dtype in ("bfloat16", "float32"):
        for s0 in ("zero", "carried"):
            cases.append(("rwkv6", dtype, 1, 4095, *WKV_GEOMETRY["rwkv6"], s0))
            cases.append(("smoke", dtype, 1, 4095, *WKV_GEOMETRY["smoke"], s0))
    for dtype in ("bfloat16", "float32"):
        cases.append(("rwkv6-short", dtype, 2, 7, *WKV_GEOMETRY["rwkv6"], "carried"))
    return cases


def scan_tol(plain) -> dict:
    """The reference's 1e-4 scan tolerance, with atol relative to the rms of the plain result.

    Kernel and plain both compute in f32 from the same inputs and return f32 in
    every dtype, so they differ only by f32 rounding in another order.
    """
    rms = plain.float().pow(2).mean().sqrt().item()
    return dict(atol=SCAN_REL * rms, rtol=SCAN_REL)


def wkv6_bound(dtype, B, S, H, C, with_s0):
    """Least time: max(bytes / HBM rate, f32 operations / f32 peak).

    Bytes: r, k, v in their dtype, w, out (and s0, s_fin, u) in f32, each once.
    Operations: 5 C^2 per token and head, the recurrence's least count
    (out = r·S + v (r·(u∘k)): 2 C^2; S <- w∘S + k⊗v: 3 C^2), all in f32.
    """
    n = B * S * H * C
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 3 * elt * n + 4 * (2 * n + H * C + (2 if with_s0 else 1) * B * H * C * C)
    flops = 5.0 * B * S * H * C * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wkv6_inputs(torch, gen, dtype, B, S, H, C):
    """r, k, v ~ N(0, 1) in dtype; w = exp(-exp(w0 + 0.5 N)) from the model's own decay base; u = 0.1 N."""
    from repro_torch.models.rwkv6 import decay_base

    dt = getattr(torch, dtype)
    r, k, v = (torch.randn((B, S, H, C), generator=gen, device="cuda").to(dt) for _ in range(3))
    base = decay_base(H * C).to("cuda").reshape(H, C)
    w = torch.exp(-torch.exp(base + 0.5 * torch.randn((B, S, H, C), generator=gen, device="cuda")))
    u = 0.1 * torch.randn((H, C), generator=gen, device="cuda")
    return r, k, v, w, u


def carried_state(torch, gen, B, H, C):
    """A non-zero s0: the state the plain version leaves after a 256-token segment."""
    from repro_torch.kernels.wkv6 import wkv6_plain

    r, k, v, w, u = wkv6_inputs(torch, gen, "float32", B, 256, H, C)
    return wkv6_plain(r, k, v, w, u, chunk=256)[1]


def wkv6_case_inputs(torch, dtype, B, S, H, C, s0_kind, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v, w, u = wkv6_inputs(torch, gen, dtype, B, S, H, C)
    s0 = carried_state(torch, gen, B, H, C) if s0_kind == "carried" else None
    return r, k, v, w, u, s0


def run_wkv6_cases(torch, card):
    from repro_torch.kernels.wkv6 import wkv6, wkv6_plain

    rows = []
    for seed, (label, dtype, B, S, H, C, chunk, s0_kind) in enumerate(wkv6_cases()):
        r, k, v, w, u, s0 = wkv6_case_inputs(torch, dtype, B, S, H, C, s0_kind, seed)
        out, state = wkv6(r, k, v, w, u, chunk=chunk, s0=s0)
        torch.cuda.synchronize()
        plain_out, plain_state = wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0)
        name = f"{label} {dtype} B{B} S{S} H{H} C{C} s0 {s0_kind}"
        if out.dtype != torch.float32 or state.dtype != torch.float32:
            raise AssertionError(f"{name}: kernel returned {out.dtype} / {state.dtype}, not float32")
        tol, state_tol = scan_tol(plain_out), scan_tol(plain_state)
        err = check_close(name, out, plain_out, tol)
        state_err = check_close(f"{name} final state", state, plain_state, state_tol)
        kernel_ms = cuda_ms(torch, lambda: wkv6(r, k, v, w, u, chunk=chunk, s0=s0))
        plain_ms = cuda_ms(torch, lambda: wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0), max_reps=5)
        bound_ms, bound_by = wkv6_bound(dtype, B, S, H, C, s0 is not None)
        row = dict(case=name, dtype=dtype, S=S, s0=s0_kind, max_abs_err=err, tol=tol,
                   state_max_abs_err=state_err, state_tol=state_tol, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, library_ms=None, library="none", bound_ms=bound_ms,
                   bound_by=bound_by, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def wkv6_planted_checks(torch, card, planted):
    """Each faulty WKV-6 build must put elements of out or s_fin outside the scan gate."""
    import ctypes

    import repro_torch.kernels.wkv6 as wk

    H, C, chunk = WKV_GEOMETRY["rwkv6"]
    checks = (("wkv6_no_bonus", "the bonus term u is dropped", 1, 4096, "zero"),
              ("wkv6_ignores_s0", "s0 is ignored (starts from zero)", 4, 1, "carried"),
              ("wkv6_reset_halfway", "the state is reset once, halfway", 1, 4096, "zero"))
    for seed, (name, fault, B, S, s0_kind) in enumerate(checks, start=100):
        r, k, v, w, u, s0 = wkv6_case_inputs(torch, "bfloat16", B, S, H, C, s0_kind, seed)
        plain_out, plain_state = wk.wkv6_plain(r, k, v, w, u, chunk=chunk, s0=s0)
        lib = wk._bind(ctypes.CDLL(str(planted[name])))
        good_lib, wk._lib = wk._lib, lambda: lib
        try:
            out, state = wk.wkv6(r, k, v, w, u, chunk=chunk, s0=s0)
            torch.cuda.synchronize()
        finally:
            wk._lib = good_lib
        tol, state_tol = scan_tol(plain_out), scan_tol(plain_state)
        bad, bad_state = n_outside(out, plain_out, tol), n_outside(state, plain_state, state_tol)
        log("planted", json.dumps(dict(
            fault=f"WKV-6: {fault}", case=f"bfloat16 B{B} S{S} H{H} C{C} s0 {s0_kind}",
            max_abs_err=(out - plain_out).abs().max().item(), tol=tol, outside_tol=bad,
            state_outside_tol=bad_state, elements=out.numel() + state.numel(), card=card)))
        if not (bad or bad_state):
            raise AssertionError(f"planted {name}: the scan gate passed a kernel where {fault}")


# ---------------------------------------------------------------------------
# phase 3, selective scan: kernel vs plain at the scan tolerance, and its planted faults
# ---------------------------------------------------------------------------

SCAN_GEOMETRY = {"smoke": (128, 8, 16), "jamba": (8192, 16, 256)}  # di, ds, the plain version's chunk
EXP_PER_S = PEAK_FLOPS["float32"] / 16  # the SFUs' 16 exponentials per SM and clock, against 256 f32 FLOP


def mamba_cases():
    """(label, B, S, di, ds, chunk, h0): the smoke width, the full width at S in
    {1, 23, 300, 4096} (300 ends the plain version's 256-chunks in a ragged
    tail) with zero and carried h0, and 4 slots of one token; all f32, as the
    model passes them.  Then the tiling's tails, appended so that the earlier
    cases keep their seeds: S = 4095 (a last tile of 31 tokens, whose last step
    holds 15) at the full width, and a ragged di at jamba's ds: 200 (the last block of
    64 channels holds 8) and 202 (rows that are not whole 16-byte chunks); last, a
    7-token call at di 202, which takes the short geometry of calls of at most 8 tokens."""
    cases = [("smoke", 2, 64, *SCAN_GEOMETRY["smoke"], "zero")]
    for h0 in ("zero", "carried"):
        for S in (1, 23, 300, 4096):
            cases.append(("jamba", 1, S, *SCAN_GEOMETRY["jamba"], h0))
    cases.append(("jamba-B4", 4, 1, *SCAN_GEOMETRY["jamba"], "carried"))
    di, ds, chunk = SCAN_GEOMETRY["jamba"]
    for h0 in ("zero", "carried"):
        cases.append(("jamba", 1, 4095, di, ds, chunk, h0))
        for ragged in (200, 202):
            cases.append(("jamba-ragged-di", 2, 4095, ragged, ds, chunk, h0))
    cases.append(("jamba-short-ragged-di", 2, 7, 202, ds, chunk, "carried"))
    return cases


def mamba_bound(B, S, di, ds, with_h0):
    """Least time: max(bytes / HBM rate, f32 FLOP / f32 peak, exponentials / SFU rate).

    Bytes, all f32, each once: u, delta, y [B,S,di]; B, C [B,S,ds]; A; h0 (if
    carried) and h_fin [B,di,ds].  Per token, channel and state one exp(delta A)
    and 6 FLOP (delta A; decay h + drive, an FMA; (delta u) B; y += h C, an
    FMA); per token and channel one more (delta u).
    """
    nbytes = 4 * (3 * B * S * di + 2 * B * S * ds + di * ds + (2 if with_h0 else 1) * B * di * ds)
    flops = B * S * di * (6.0 * ds + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / PEAK_FLOPS["float32"], B * S * di * ds / EXP_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mamba_inputs(torch, gen, label, B, S, di, ds):
    """u ~ N(0, 1), B, C ~ N(0, 1).  At the smoke width delta and A as the
    reference's kernel tests draw them (softplus(N), -exp(0.5 N)); at jamba's
    width as the model's init gives them: A = -(1..ds), delta = softplus(0.5 N +
    dt_bias) with dt_bias the inverse softplus of a log-uniform step in [1e-3, 0.1]."""
    import torch.nn.functional as F

    u = torch.randn((B, S, di), generator=gen, device="cuda")
    Bm, Cm = (torch.randn((B, S, ds), generator=gen, device="cuda") for _ in range(2))
    if label == "smoke":
        delta = F.softplus(torch.randn((B, S, di), generator=gen, device="cuda"))
        A = -torch.exp(0.5 * torch.randn((di, ds), generator=gen, device="cuda"))
    else:
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * torch.rand((di,), generator=gen, device="cuda"))
        delta = F.softplus(0.5 * torch.randn((B, S, di), generator=gen, device="cuda") + torch.log(torch.expm1(dt)))
        A = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds).contiguous()
    return u, delta, A, Bm, Cm


def mamba_case_inputs(torch, label, B, S, di, ds, h0_kind, seed):
    from repro_torch.kernels.mamba_scan import mamba_scan_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    u, delta, A, Bm, Cm = mamba_inputs(torch, gen, label, B, S, di, ds)
    h0 = None
    if h0_kind == "carried":  # the state the plain version leaves after a 256-token segment
        pu, pd, _, pB, pC = mamba_inputs(torch, gen, label, B, 256, di, ds)
        h0 = mamba_scan_plain(pu, pd, A, pB, pC, chunk=256)[1]
    return u, delta, A, Bm, Cm, h0


def run_mamba_cases(torch, card):
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain

    rows = []
    for seed, (label, B, S, di, ds, chunk, h0_kind) in enumerate(mamba_cases()):
        u, delta, A, Bm, Cm, h0 = mamba_case_inputs(torch, label, B, S, di, ds, h0_kind, seed)
        y, state = mamba_scan(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        plain_y, plain_state = mamba_scan_plain(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
        name = f"{label} float32 B{B} S{S} di{di} ds{ds} h0 {h0_kind}"
        tol, state_tol = scan_tol(plain_y), scan_tol(plain_state)
        err = check_close(name, y, plain_y, tol)
        state_err = check_close(f"{name} final state", state, plain_state, state_tol)
        kernel_ms = cuda_ms(torch, lambda: mamba_scan(u, delta, A, Bm, Cm, chunk=chunk, h0=h0))
        plain_ms = cuda_ms(torch, lambda: mamba_scan_plain(u, delta, A, Bm, Cm, chunk=chunk, h0=h0), max_reps=5)
        bound_ms, bound_by = mamba_bound(B, S, di, ds, h0 is not None)
        row = dict(case=name, dtype="float32", S=S, h0=h0_kind, max_abs_err=err, tol=tol,
                   state_max_abs_err=state_err, state_tol=state_tol, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, library_ms=None, library="none", bound_ms=bound_ms,
                   bound_by=bound_by, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def mamba_planted_checks(torch, card, planted):
    """Each faulty selective-scan build must put elements of y or h_fin outside the scan gate."""
    import ctypes

    import repro_torch.kernels.mamba_scan as ms

    di, ds, chunk = SCAN_GEOMETRY["jamba"]
    checks = (("mamba_no_drive", "the drive (delta u) B is dropped", 1, 4096, "zero"),
              ("mamba_ignores_h0", "h0 is ignored (starts from zero)", 4, 1, "carried"),
              ("mamba_reset_halfway", "the state is reset once, halfway", 1, 4096, "zero"))
    for seed, (name, fault, B, S, h0_kind) in enumerate(checks, start=200):
        u, delta, A, Bm, Cm, h0 = mamba_case_inputs(torch, "jamba", B, S, di, ds, h0_kind, seed)
        plain_y, plain_state = ms.mamba_scan_plain(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
        lib = ms._bind(ctypes.CDLL(str(planted[name])))
        good_lib, ms._lib = ms._lib, lambda: lib
        try:
            y, state = ms.mamba_scan(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
            torch.cuda.synchronize()
        finally:
            ms._lib = good_lib
        tol, state_tol = scan_tol(plain_y), scan_tol(plain_state)
        bad, bad_state = n_outside(y, plain_y, tol), n_outside(state, plain_state, state_tol)
        log("planted", json.dumps(dict(
            fault=f"selective scan: {fault}", case=f"float32 B{B} S{S} di{di} ds{ds} h0 {h0_kind}",
            max_abs_err=(y - plain_y).abs().max().item(), tol=tol, outside_tol=bad,
            state_outside_tol=bad_state, elements=y.numel() + state.numel(), card=card)))
        if not (bad or bad_state):
            raise AssertionError(f"planted {name}: the scan gate passed a kernel where {fault}")


# ---------------------------------------------------------------------------
# phases 4-8: the serving paths
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def leaves(tree):
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else (v,))


def kernel_counters():
    """Each launch count, by name: (the wrapper that holds it, its attribute)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.wkv6 import wkv6

    return {"flash_attention": (flash_attention, "launches"),
            "flash_attention_wgmma": (flash_attention, "launches_wgmma"),
            "flash_attention_scalar": (flash_attention, "launches_scalar"),
            "flash_attention_bwd_rowdot": (flash_attention_bwd, "launches_rowdot"),
            "flash_attention_bwd_dkdv": (flash_attention_bwd, "launches_dkdv"),
            "flash_attention_bwd_dq": (flash_attention_bwd, "launches_dq"),
            "wkv6": (wkv6, "launches"), "mamba_scan": (mamba_scan, "launches")}


def launch_counts(n_flash: int = 0, n_wkv6: int = 0, n_scan: int = 0, n_bwd: int = 0) -> dict:
    """A pass's exact launch counts: every flash launch of the bf16 paths on the tensor-core kernel,
    and n_bwd launches of each backward kernel."""
    return {"flash_attention": n_flash, "flash_attention_wgmma": n_flash, "flash_attention_scalar": 0,
            "flash_attention_bwd_rowdot": n_bwd, "flash_attention_bwd_dkdv": n_bwd, "flash_attention_bwd_dq": n_bwd,
            "wkv6": n_wkv6, "mamba_scan": n_scan}


def serve(torch, model, params, card, *, prompts, max_len, slots, max_new, phase, per_pass):
    """Drive ServeEngine; ``per_pass[kind][kernel]`` is the exact launch count each
    prefill / decode step must add (read around every forward pass)."""
    from repro_torch.models import Model
    from repro_torch.serve import ServeConfig, ServeEngine

    counters = kernel_counters()
    passes = []

    def counted(kind, fn):
        def call(*args, **kw):
            before = {k: getattr(*c) for k, c in counters.items()}
            out = fn(*args, **kw)
            passes.append((kind, {k: getattr(*c) - before[k] for k, c in counters.items()}))
            return out
        return call

    run_model = Model(model.cfg, device=model.device)  # this run's own, so the wrappers end with it
    run_model.prefill = counted("prefill", run_model.prefill)
    run_model.decode_step = counted("decode", run_model.decode_step)
    eng = ServeEngine(run_model, params, ServeConfig(max_len=max_len, slots=slots, eos_token=-1, seed=0),
                      device="cuda")
    reqs = [eng.submit(p, max_new) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)             # count only this run of the main path
    stats = eng.run_until_drained(reqs)
    launches = {k: getattr(*c) for k, c in counters.items()}
    vocab = model.cfg.vocab_size
    if not all(r.done for r in reqs):
        raise AssertionError(f"{phase}: requests left pending")
    if not all(len(r.out_tokens) == max_new and all(0 <= t < vocab for t in r.out_tokens) for r in reqs):
        raise AssertionError(f"{phase}: a request has the wrong token count or an out-of-range token")
    if stats["prefills"] != len(prompts) or len(passes) != stats["prefills"] + stats["decode_steps"]:
        raise AssertionError(f"{phase}: {len(passes)} forward passes for {stats['prefills']} prefills "
                             f"and {stats['decode_steps']} decode steps of {len(prompts)} prompts")
    wrong = [(i, kind, got) for i, (kind, got) in enumerate(passes) if got != per_pass[kind]]
    if wrong:
        raise AssertionError(f"{phase}: kernel launches per pass differ from {per_pass}: {wrong[:4]}")
    stats.update(kernel_launches=launches, launches_per_pass=per_pass,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), card=card)
    log(phase, json.dumps(stats))
    return eng, stats


def compare_with_cpu(torch, cfg, params_gpu, tokens, decode_tokens, phase):
    """Prefill + teacher-forced decode on the card (kernel) and the CPU (plain) agree at 2e-3."""
    from repro_torch.models import Model

    gpu, cpu = Model(cfg, device="cuda"), Model(cfg, device="cpu")
    params_cpu = tree_map(lambda t: t.cpu(), params_gpu)
    S = tokens.shape[1]
    max_len = S + len(decode_tokens) + 1
    cache_g, lg = gpu.prefill(params_gpu, {"tokens": tokens}, max_len=max_len)
    cache_c, lc = cpu.prefill(params_cpu, {"tokens": tokens}, max_len=max_len)
    errs = [check_close(f"{phase} prefill", lg.cpu(), lc, LOGIT_TOL)]
    for t, tok in enumerate(decode_tokens):
        cache_g, lg = gpu.decode_step(params_gpu, cache_g, [[tok]], S + t)
        cache_c, lc = cpu.decode_step(params_cpu, cache_c, [[tok]], S + t)
        errs.append(check_close(f"{phase} decode {t}", lg.cpu(), lc, LOGIT_TOL))
    log(phase, f"{cfg.name} ({cfg.n_layers} layers) {cfg.dtype}: prompt {S}, {len(decode_tokens)} decode steps, "
               f"max |logit err| card vs CPU {max(errs):.3e} (tol {LOGIT_TOL})")


def rwkv6_phases(torch, card, rng):
    """rwkv6-7b at full width: serve, one long prompt, and card against CPU."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import Model

    cfg = get_config("rwkv6-7b")
    per_pass = {kind: launch_counts(n_wkv6=cfg.n_layers) for kind in ("prefill", "decode")}
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    log("rwkv6", f"{cfg.name}: {model.count_params(params)} parameters, f32 master weights, "
                 f"{cfg.dtype} compute")
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 25))) for _ in range(8)]
    eng, stats = serve(torch, model, params, card, prompts=prompts, max_len=256, slots=4,
                       max_new=16, phase="rwkv6-serve", per_pass=per_pass)
    del params  # the engine keeps the bf16 copy
    torch.cuda.empty_cache()
    long_prompt = [rng.integers(0, cfg.vocab_size, size=4096)]
    long_stats = serve(torch, model, eng.params, card, prompts=long_prompt, max_len=8192, slots=1,
                       max_new=8, phase="rwkv6-long", per_pass=per_pass)[1]
    del eng
    torch.cuda.empty_cache()

    # depth cut to 2 layers so that the CPU's plain path stays quick; widths are the full model's
    cut = cfg.replace(n_layers=2, dtype="float32")
    cut_params = Model(cut, device="cuda").init(torch.Generator(device="cuda").manual_seed(2))
    compare_with_cpu(torch, cut, cut_params, rng.integers(0, cut.vocab_size, size=(1, 300)),
                     [int(t) for t in rng.integers(0, cut.vocab_size, size=2)], "rwkv6-check")
    del cut_params
    torch.cuda.empty_cache()
    small = smoke_variant(cfg)
    small_params = Model(small, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
    compare_with_cpu(torch, small, small_params, rng.integers(0, small.vocab_size, size=(1, 20)),
                     [int(t) for t in rng.integers(0, small.vocab_size, size=20)], "rwkv6-check")
    return stats, long_stats


def jamba_phases(torch, card, rng):
    """jamba-v0.1-52b cut to two full-width units in bf16: serve, one long prompt, and card against CPU."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import Model

    # depth cut to 2 of the 4 units, as far as the card forces; widths and the
    # reference's own bf16 parameter dtype kept
    full = get_config("jamba-v0.1-52b")
    cfg = full.replace(n_layers=16, param_dtype="bfloat16")
    n_mamba = cfg.n_units * sum(s.mixer == "mamba" for s in cfg.pattern)
    n_attn = cfg.n_units * sum(s.mixer == "attn" for s in cfg.pattern)
    per_pass = {"prefill": launch_counts(n_flash=n_attn, n_scan=n_mamba), "decode": launch_counts()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    dtypes = sorted({str(t.dtype) for t in leaves(params)})
    if dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"jamba: parameter dtypes {dtypes}, expected every leaf in bfloat16")
    log("jamba", f"{cfg.name} ({cfg.n_layers} of {full.n_layers} layers): {model.count_params(params)} parameters, "
                 f"every leaf bfloat16, drawn in f32 leaf by leaf; {cfg.dtype} compute; peak of the draw "
                 f"{torch.cuda.max_memory_allocated()} bytes, {torch.cuda.memory_allocated()} resident")
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 25))) for _ in range(8)]
    eng, stats = serve(torch, model, params, card, prompts=prompts, max_len=256, slots=4,
                       max_new=16, phase="jamba-serve", per_pass=per_pass)
    del params  # the engine holds the same bf16 tensors (the cast makes no copy)
    S_long = 4096
    moe = cfg.moe
    log("jamba-long", f"prompt {S_long}: expert capacity C = ceil(S K cf / E) = "
                      f"{math.ceil(S_long * moe.top_k * moe.capacity_factor / moe.n_experts)}")
    long_stats = serve(torch, model, eng.params, card, prompts=[rng.integers(0, cfg.vocab_size, size=S_long)],
                       max_len=8192, slots=1, max_new=8, phase="jamba-long", per_pass=per_pass)[1]
    del eng
    torch.cuda.empty_cache()

    # every layer kind at full width: pattern positions 3 (mamba + moe) and 4 (attention + dense), f32
    cut = full.replace(n_layers=2, pattern=(full.pattern[3], full.pattern[4]), dtype="float32")
    cut_params = Model(cut, device="cuda").init(torch.Generator(device="cuda").manual_seed(2))
    log("jamba-check", f"cut: {[(s.mixer, s.ffn) for s in cut.pattern]}, "
                       f"{sum(t.numel() for t in leaves(cut_params))} parameters in f32")
    compare_with_cpu(torch, cut, cut_params, rng.integers(0, cut.vocab_size, size=(1, 300)),
                     [int(t) for t in rng.integers(0, cut.vocab_size, size=2)], "jamba-check")
    del cut_params
    torch.cuda.empty_cache()
    small = smoke_variant(full)
    small_params = Model(small, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
    compare_with_cpu(torch, small, small_params, rng.integers(0, small.vocab_size, size=(1, 20)),
                     [int(t) for t in rng.integers(0, small.vocab_size, size=20)], "jamba-check")
    return stats, long_stats


# ---------------------------------------------------------------------------
# phases 9-11: training, card against CPU, and the backward's library yardstick
# ---------------------------------------------------------------------------

TRAIN = dict(steps=8, seq_len=2048, global_batch=4, microbatches=1, lr=1e-3, seed=0)


def train_phase(torch, card):
    """gemma2-2b at full width and depth through the launcher's Trainer; exact launches per step."""
    from repro_torch.launch.train import build_trainer

    counters = kernel_counters()
    marks = []

    def mark(step):  # the Trainer calls this before each step: the counters then, read after
        marks.append({k: getattr(*c) for k, c in counters.items()})

    torch.cuda.empty_cache()
    trainer = build_trainer("gemma2-2b", device="cuda", fault_hook=mark, **TRAIN)
    cfg = trainer.model.cfg
    params = trainer.state["params"]
    dtypes = sorted({str(t.dtype) for t in leaves(params)})
    if cfg.n_layers != 26 or cfg.remat != "unit" or cfg.dtype != "bfloat16" or dtypes != ["torch.float32"]:
        raise AssertionError(f"train: {cfg.n_layers} layers, remat {cfg.remat}, compute {cfg.dtype}, params {dtypes}")
    n_attn = cfg.n_layers
    per_step = launch_counts(n_flash=2 * n_attn, n_bwd=n_attn)   # forward, recomputed forward, backward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)             # count only this run of the main path
    result = trainer.run(TRAIN["steps"])
    final = {k: getattr(*c) for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    ends = marks[1:] + [final]
    steps = [{k: end[k] - start[k] for k in final} for start, end in zip(marks, ends)]
    wrong = [(i, got) for i, got in enumerate(steps) if got != per_step]
    if len(steps) != TRAIN["steps"] or wrong:
        raise AssertionError(f"train: kernel launches per step differ from {per_step}: {wrong[:3]}")
    log_rows = trainer.metrics_log
    losses = [m["loss"] for m in log_rows]
    norms = [m["grad_norm"] for m in log_rows]
    if not all(math.isfinite(x) for x in losses + norms) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses}, grad norms {norms}: not all finite, or not falling")
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    step_ms = [1e3 * m["seconds"] for m in log_rows]
    stats = dict(model=cfg.name, layers=cfg.n_layers, params=sum(t.numel() for t in leaves(params)),
                 remat=cfg.remat, batch=TRAIN["global_batch"], seq=TRAIN["seq_len"], steps=len(log_rows),
                 losses=losses, grad_norms=norms, lrs=[m["lr"] for m in log_rows], step_ms=step_ms,
                 step_ms_after_first=sum(step_ms[1:]) / len(step_ms[1:]),
                 tok_per_s_after_first=tokens * len(step_ms[1:]) / (sum(step_ms[1:]) / 1e3),
                 wall_s=result["wall_s"], kernel_launches=final, launches_per_step=per_step,
                 max_memory_allocated_bytes=peak, card=card)
    log("train", json.dumps(stats))
    del trainer, params
    torch.cuda.empty_cache()
    return stats


def train_check(torch, card):
    """The card's loss and gradients against the CPU's (plain attention), f32, on the same weights and batch."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedPipeline, SyntheticLM
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import Model

    cut = get_config("gemma2-2b").replace(n_layers=2, dtype="float32")  # one unit: a local and a global layer
    batch = ShardedPipeline(SyntheticLM(vocab_size=cut.vocab_size, seq_len=320, period=16, vocab_eff=256),
                            global_batch=1).batch_at(0)
    params_gpu = Model(cut, device="cuda").init(torch.Generator(device="cuda").manual_seed(3))
    out = {}
    for device, params in (("cuda", params_gpu), ("cpu", tree_map(lambda t: t.detach().cpu(), params_gpu))):
        flat = convert.flatten(params)
        for leaf in flat.values():
            leaf.requires_grad_(True)
        loss, _ = Model(cut, device=device).train_loss(params, batch, loss_chunk=64)
        grads = torch.autograd.grad(loss, list(flat.values()))
        out[device] = (float(loss.detach()), {p: g.detach().cpu() for p, g in zip(flat, grads)})
        del params, flat, grads
    del params_gpu
    (loss_g, grads_g), (loss_c, grads_c) = out["cuda"], out["cpu"]
    rel = {p: ((grads_g[p] - g).norm() / g.norm().clamp_min(1e-30)).item() for p, g in grads_c.items()}
    worst = max(rel, key=rel.get)
    log("train-check", json.dumps(dict(
        cut=f"{cut.name} {cut.n_layers} layers f32, B1 S320, loss chunk 64", loss_card=loss_g, loss_cpu=loss_c,
        worst_leaf=worst, worst_rel_err=rel[worst], leaves=len(rel), loss_rtol=LOSS_RTOL,
        grad_leaf_rel=GRAD_LEAF_REL, card=card)))
    if not abs(loss_g - loss_c) <= LOSS_RTOL * abs(loss_c):
        raise AssertionError(f"train-check: loss on the card {loss_g} against {loss_c} on the CPU")
    if not all(math.isfinite(r) and r <= GRAD_LEAF_REL for r in rel.values()):
        raise AssertionError(f"train-check: gradient leaf {worst} differs by {rel[worst]:.3e} (relative)")
    del out, grads_g, grads_c
    torch.cuda.empty_cache()

    # the CPU trainer starts from the card trainer's weights: the two generators draw different numbers
    trainers = {device: build_trainer("gemma2-2b", smoke=True, steps=3, device=device) for device in ("cuda", "cpu")}
    with torch.no_grad():
        for a, b in zip(leaves(trainers["cpu"].state["params"]), leaves(trainers["cuda"].state["params"])):
            a.copy_(b.cpu())
    losses = {}
    for device, trainer in trainers.items():
        trainer.run(3)
        losses[device] = [m["loss"] for m in trainer.metrics_log]
    log("train-check", json.dumps(dict(smoke_losses_card=losses["cuda"], smoke_losses_cpu=losses["cpu"],
                                       rtol=1e-4, card=card)))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def library_backward(torch, card, rows):
    """SDPA's backward through autograd at each backward case: softcap 0, the same mask."""
    import torch.nn.functional as F

    for row in rows:
        q, k, v, do = backward_inputs(torch, row["dtype"], row["B"], row["S"], row["H"], row["Kv"], row["hd"], 1.0,
                                      row["seed"])
        S, window = row["S"], row["window"]
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa = dict(scale=1.0 / math.sqrt(row["hd"]), enable_gqa=True)
        if window and window < S:  # the window binds: a boolean mask
            pos = torch.arange(S, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, **sdpa)
            row["library"] = "sdpa backward (autograd), same boolean mask, softcap 0"
        else:
            out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, **sdpa)
            row["library"] = "sdpa backward (autograd), is_causal, softcap 0"
        doh = do.transpose(1, 2)
        row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                                    max_reps=10)
        log("library", json.dumps(dict(case=row["case"], library=row["library"], library_ms=row["library_ms"],
                                       backward_ms=row["backward_ms"], card=card)))
        del qh, kh, vh, out


def backward_entries(rows, train_stats, card):
    """The kernels line's entries of the backward kernels, at gemma2's training shape, window 4096."""
    row = next(r for r in rows if r["label"] == "gemma2-train" and r["window"] == 4096)
    max_err = max(row["max_abs_err"][g] for g in ("dq", "dk", "dv"))
    return [dict(
        name=f"flash_attention_bwd_{kname}", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:126",
        replaces_note="the gradient of that forward-only Pallas kernel: the reference differentiates its jnp "
                      "twin (src/repro/models/attention.py:80-163) with JAX",
        launches=train_stats["kernel_launches"][f"flash_attention_bwd_{kname}"], max_abs_err=max_err,
        ms=row["kernel_ms"][kname], plain_ms=row["plain_ms"], plain=row["plain"], bound_ms=row["bound_ms"][kname],
        bound_by=row["bound_by"][kname], library_ms=row["library_ms"], library=row["library"],
        backward_ms=row["backward_ms"], backward_bound_ms=row["bound_ms"]["backward"], tol=row["tol"],
        shape=row["case"], card=card) for kname in ("rowdot", "dkdv", "dq")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on a card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    card = smi_line()
    print(card, flush=True)
    log("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"{torch.cuda.device_count()} device(s)")

    # 2. build
    planted = build_everything(card)

    # 3. kernel vs plain, and the gates against planted faults
    rows = run_kernel_cases(torch, card)
    planted_fault_check(torch, card, planted)
    wkv_rows = run_wkv6_cases(torch, card)
    wkv6_planted_checks(torch, card, planted)
    scan_rows = run_mamba_cases(torch, card)
    mamba_planted_checks(torch, card, planted)
    bwd_rows = run_backward_cases(torch, card)
    backward_planted_checks(torch, card, planted)
    log("time", f"phases 1-3 done at {time.perf_counter() - t_start:.1f} s")

    # 4. serve at full width
    cfg = get_config("gemma2-2b")
    per_pass = {"prefill": launch_counts(n_flash=cfg.n_layers), "decode": launch_counts()}
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    log("serve", f"{cfg.name}: {model.count_params(params)} parameters, f32 master weights, "
                 f"{cfg.dtype} compute")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 25))) for _ in range(8)]
    eng, stats = serve(torch, model, params, card, prompts=prompts, max_len=256, slots=4,
                       max_new=16, phase="serve", per_pass=per_pass)

    # 5. a prompt longer than the local window
    long_prompt = [rng.integers(0, cfg.vocab_size, size=4608)]
    long_stats = serve(torch, model, eng.params, card, prompts=long_prompt, max_len=8192, slots=1,
                       max_new=8, phase="long", per_pass=per_pass)[1]
    del eng

    # 6. the card against the CPU on the same weights
    tokens = prompts[-1][None]
    compare_with_cpu(torch, cfg.replace(dtype="float32"), params, tokens,
                     [int(t) for t in rng.integers(0, cfg.vocab_size, size=2)], "check")
    del params
    torch.cuda.empty_cache()
    small = smoke_variant(cfg)
    small_params = Model(small, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
    compare_with_cpu(torch, small, small_params, rng.integers(0, small.vocab_size, size=(1, 20)),
                     [int(t) for t in rng.integers(0, small.vocab_size, size=20)], "check")
    del small_params
    torch.cuda.empty_cache()
    log("time", f"phases 4-6 done at {time.perf_counter() - t_start:.1f} s; "
                f"{torch.cuda.memory_allocated()} bytes still allocated")

    # 7. rwkv6-7b at full width
    rwkv_stats, rwkv_long_stats = rwkv6_phases(torch, card, rng)
    log("time", f"phase 7 done at {time.perf_counter() - t_start:.1f} s; "
                f"{torch.cuda.memory_allocated()} bytes still allocated")

    # 8. jamba-v0.1-52b, two full-width units in bf16
    jamba_stats, jamba_long_stats = jamba_phases(torch, card, rng)
    log("time", f"phase 8 done at {time.perf_counter() - t_start:.1f} s; "
                f"{torch.cuda.memory_allocated()} bytes still allocated")

    # 9. gemma2-2b training at full width and depth
    train_stats = train_phase(torch, card)
    log("time", f"phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # 10. training, card against CPU
    train_check(torch, card)
    log("time", f"phase 10 done at {time.perf_counter() - t_start:.1f} s")

    # 11. the backward's library yardstick, after every peak has been read
    library_backward(torch, card, bwd_rows)
    log("time", f"phase 11 done at {time.perf_counter() - t_start:.1f} s")

    main_row = next(r for r in rows if r["case"].startswith("gemma2-serve-long bfloat16")
                    and r["window"] == 4096)
    jamba_row = next(r for r in rows if r["case"].startswith("jamba-serve-long bfloat16"))
    wkv_row = next(r for r in wkv_rows if r["case"] == "rwkv6 bfloat16 B1 S4096 H64 C64 s0 zero")
    scan_row = next(r for r in scan_rows if r["case"] == "jamba float32 B1 S4096 di8192 ds16 h0 zero")
    kernels = [dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:126", launches=stats["kernel_launches"]["flash_attention"],
        max_abs_err=main_row["max_abs_err"], ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
        tol=main_row["tol"], shape=main_row["case"], library="sdpa, same mask, softcap 0",
        variant=main_row["variant"], tflops=main_row["tflops"],
        launches_wgmma=stats["kernel_launches"]["flash_attention_wgmma"],
        launches_long_prompt=long_stats["kernel_launches"]["flash_attention"],
        launches_jamba=jamba_stats["kernel_launches"]["flash_attention"],
        jamba_shape=jamba_row["case"], jamba_ms=jamba_row["kernel_ms"], jamba_library_ms=jamba_row["library_ms"],
        jamba_library_causal_ms=jamba_row["library_causal_ms"], jamba_plain_ms=jamba_row["plain_ms"],
        jamba_bound_ms=jamba_row["bound_ms"], jamba_tflops=jamba_row["tflops"],
        jamba_max_abs_err=jamba_row["max_abs_err"], launches_train=train_stats["kernel_launches"]["flash_attention"],
        card=card,
    ), *backward_entries(bwd_rows, train_stats, card), dict(
        name="wkv6", route="cuda", source="src/repro_torch/kernels/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:96", launches=rwkv_stats["kernel_launches"]["wkv6"],
        max_abs_err=wkv_row["max_abs_err"], ms=wkv_row["kernel_ms"], plain_ms=wkv_row["plain_ms"],
        bound_ms=wkv_row["bound_ms"], bound_by=wkv_row["bound_by"], library_ms=None,
        tol=wkv_row["tol"], shape=wkv_row["case"], library="none",
        launches_long_prompt=rwkv_long_stats["kernel_launches"]["wkv6"], card=card,
    ), dict(
        name="mamba_scan", route="cuda", source="src/repro_torch/kernels/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan.py:76", launches=jamba_stats["kernel_launches"]["mamba_scan"],
        max_abs_err=scan_row["max_abs_err"], ms=scan_row["kernel_ms"], plain_ms=scan_row["plain_ms"],
        bound_ms=scan_row["bound_ms"], bound_by=scan_row["bound_by"], library_ms=None,
        tol=scan_row["tol"], shape=scan_row["case"], library="none",
        launches_long_prompt=jamba_long_stats["kernel_launches"]["mamba_scan"], card=card,
    )]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

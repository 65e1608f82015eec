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
              mask SDPA with is_causal=True; the dense phase's geometries in bf16 at
              S = 4, 23, 300 and 4096 (codeqwen B1 H32 Kv32, nemotron H48 Kv8, i.e. six
              query heads per KV head, olmoe H16 Kv16; hd 128), and nemotron's G = 6
              in f32 at S = 300; WKV-6 and the selective scan at the
              scan tolerance, their tiles' tails included (S = 4095, the smoke
              C = 16, a ragged di of 200 and 202);
   backward — the flash-attention backward's three kernels (D = rowsum(do o), dk / dv, dq)
              against flash_attention_bwd_plain, with the forward's log-sum-exp against the plain
              one: the smoke shape, gemma2's training shape (bf16 B4 S=T=2048 H8 Kv4 hd256,
              softcap 50) with window 4096 and 0, and with softcap 0 and window 0 (plain causal:
              the function SDPA's causal backward computes), B1 S=T=4608 where the window binds,
              B2 with a ragged S=300, f32 at S=320, stablelm-3b's training shape (bf16 B4
              S=T=2048 H32 Kv32 hd80, which the kernels pad to 128 columns, softcap 0, window 0;
              scripts/flash_variants.py --padding prices the padding); where bf16 pads hd to whole
              64-column boxes (the smoke shape's 16, stablelm's 80) the padded gradient columns must
              come out zero and the rest bitwise the wrapper's; gates per gradient, atol 2e-2 x rms(plain) with rtol 2e-2
              in bf16 and 2e-5 scaled the same way in f32; CUDA-event times of each
              kernel and of the whole backward against its bound and the plain version, which the
              backward must beat at gemma2's, stablelm's, olmoe's and jamba's training shapes (olmoe-1b-7b:
              bf16 B4 S=T=2048 H16 Kv16 hd128, softcap 0, window 0; jamba-v0.1-52b's attention layer the
              same at H32 Kv8, four query heads per KV head); phase 2 must report no spill for the
              bf16 backward kernels (hd 80 runs their 2-box instantiations), for any of the WKV-6
              backward's 8 instantiations nor for any of the scan backward's 3 (ds 4, 8, 16);
   wkv6-bwd — WKV-6's training form (the forward that also saves the state before every 16 tokens)
              bitwise the serving form on out and final state, its first saved state s0; the
              backward kernel against wkv6_bwd_plain at the smoke C = 16 (bf16, and f32 with s0
              and ds_fin), rwkv6's training shape (bf16 B4 S2048 H64 C64), a ragged S = 300 with
              s0 and ds_fin and f32 at S = 320, and those last two again with decays near the
              clamp (shares of w at 1e-36, 1e-30, 1e-38 itself, 1e-40 and 0), where dw must be
              exactly 0 at and under 1e-38, and the kernel's other tilings, C = 8 and 32, in f32
              and bf16 at a ragged S = 300 with s0 and ds_fin: f32 gradients, and dw, du and ds0 in every dtype, at
              the scan gate, bf16 dr, dk, dv at the backward's bf16 gate (2e-2 x rms, rtol 2e-2);
              two calls bitwise equal; kernel, plain and bound ms of both kernels; the backward
              must beat its plain version at the training shape;
   scan-bwd — the selective scan's training form (the forward that also saves the state before every
              16 tokens) bitwise the serving form on y and final state, its first saved state h0; the
              backward kernel, all f32, against the exact gradients (mamba_scan_bwd_plain in f64) at the
              smoke width (di 128 ds 8, with h0 and dh_fin), jamba's training shape (B4 S2048 di8192 ds16),
              a ragged S = 300 at jamba's width with h0 and dh_fin, and a ragged di of 202: every gradient
              (dA, dB and dC, sums over tokens or channels, too) no further from exact than the f32 plain
              version plus the scan gate (1e-4 x rms, rtol 1e-4); two calls bitwise equal; kernel, plain
              and bound ms of both kernels; the backward must beat its plain version at the training shape;
   planted  — copies of the kernels with a fault built in must fail the same gates:
              flash attention that (a) skips the last live KV tile of every block or
              (b) treats the diagonal tiles as interior and skips their causal mask,
              WKV-6 that (a) drops the bonus u, (b) ignores s0 or (c) resets its
              state halfway through the sequence, and the selective scan that
              (a) drops the drive, (b) ignores h0 or (c) resets its state halfway, and the flash
              backward that (a) drops the softcap's derivative, (b) takes dk and dv from the first
              query head of each group only, (c) leaves D out of ds or (d) leaves the last stage
              of dk / dv's TMA ring without its dO (q scaled by 4, so that the softcap's
              derivative matters), at gemma2's geometry (B1 S=T=2048 H8 Kv4 hd256) and at
              stablelm's training shape with softcap 50; at stablelm's G = 1 the first-head-only
              fault changes nothing and must give the committed gradients bitwise, so it runs
              once more at H32 Kv8 hd80, where it must fail; and the WKV-6 backward that (a) drops
              the bonus from dk and dv, (b) ignores ds_fin, (c) carries dS without any decay or
              (d) takes dw against S_t instead of S_{t-1}, each of which must also pass the gate
              against the recurrence with the same fault written in (wkv6_bwd_plain_with_fault),
              and the committed backward fed by a training form whose staged store shifts the
              saved states' rows by one, at f32 B2 S320 H64 C64 with s0 and ds_fin; and the
              selective scan's backward that (a) carries g without the decay, (b) ignores dh_fin, (c) sums
              dA without its factor delta, (d) takes dC against h_{t-1} instead of h_t or (e) stages the
              next span's saved state for every span but the last, at f32 B2 S320 at jamba's width with h0
              and dh_fin;
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
              backward kernel exactly 26 times; step ms, tok/s, the peak device memory and
              Python's full garbage collections during the run (when, how long);
10. ckpt    — phase 9's run cut to 14 of gemma2-2b's 26 layers (every width kept: two saves of the
              full depth write more than the card's machine lets one command write to its disk),
              once clean (ckpt-clean) and once with checkpoints through SCISPACE (CheckpointManager,
              native writes published by one MEU export, 2 shards, a data center on disk under
              build/) every 4 steps and an injected node failure before step 7: exactly one restart,
              steps [4, 8] found by an SDS search, step 4 restored into the live tensors and steps
              5-8 replayed; launches per step as in the clean run, every loss within rtol 1e-5 of
              its and every parameter leaf within ||d|| / ||p|| <= 1e-5 of its final one, the
              card's peak within 1 % of its; each save's bytes and pack / write / publish
              seconds, the restore's seconds, the host's memory and the phase's wall time;
11. train-check — card against CPU in f32 on a full-width cut of gemma2-2b to one unit (2 layers,
              local and global) and of codeqwen1.5-7b (its untied head), rwkv6-7b (the WKV-6
              training form and backward) and olmoe-1b-7b (its MoE, whose top-8 expert ids must be
              equal first) to one layer each, B1 S320, loss chunk 64: the loss within rtol 1e-5 and
              every gradient leaf within ||card - cpu|| / ||cpu|| <= 1e-4; the same for jamba-v0.1-52b cut
              to pattern positions 0 (Mamba + dense) and 4 (attention + dense), 0.77 B parameters (the scan's
              training form and backward kernels, flash at G = 4); then 3 Trainer steps each of gemma2's and
              jamba's smoke models on both, losses within rtol 1e-4;
12. dense   — codeqwen1.5-7b, stablelm-3b, nemotron-4-15b and olmoe-1b-7b, each at full width and
              depth on the serving launcher's weights (every leaf drawn in f32 and stored in bf16 as
              the engine casts it, no master copy: nemotron's 15.6 B parameters in 31.3 GB), bf16
              compute: served as in phase 4 with flash attention launched exactly n_layers times per
              prefill (32, 32, 32, 16), every launch on the tensor-core kernel, and no kernel per
              decode step; one 4096-token prompt each (olmoe's MoE capacity 640); card against CPU
              at 2e-3 in f32 on a full-width 2-layer cut over a 64-token prompt plus 2 decode steps,
              and on the smoke model over 20 steps; the weight bytes held, and the draw's peak within
              what the launcher's memory check counts (the weights plus the largest leaf in f32);
              then `python -m repro_torch.launch.serve --arch nemotron-4-15b` through its main(), as
              a user runs it: its stats must report 15,628,775,424 parameters, the meta init's
              weight bytes, a draw peak within its check, and n_layers tensor-core flash launches per
              prefill; the phase's wall time;
13. dense-train — stablelm-3b trained as in phase 9 (full width and depth, 8 steps, B4 S2048,
              remat="unit"): per step flash attention's forward exactly 64 times (32 + 32
              recomputed) and each backward kernel 32 times, at hd 80;
14. rwkv6-train — rwkv6-7b trained as in phase 9, cut to 12 of its 32 layers (every width kept:
              its f32 masters, gradients and AdamW moments fit one card): per step WKV-6's
              training form exactly 24 times (12 + 12 recomputed) and its backward 12 times, flash
              attention never;
15. moe-train — olmoe-1b-7b trained as in phase 9, cut to 6 of its 16 layers: per step flash
              attention's forward exactly 12 times and each backward kernel 6 times (hd 128), the
              MoE's load-balance loss in the loss, finite and positive at every step;
16. jamba-train — jamba-v0.1-52b trained as in phase 9, cut to one unit of pattern positions 1 (Mamba +
              MoE, 16 experts top-2 at d_ff 14336) and 4 (attention + dense), every width kept (3.41 B
              parameters, 54.6 GB of f32 state): per step the scan's training form exactly twice (one +
              one recomputed), its backward once, flash attention's forward twice and each backward kernel
              once (H32 Kv8 hd128, G = 4), the MoE's load-balance loss finite and positive;
17. e2e     — `python -m repro_torch.launch.train_end_to_end` through its main(), as a user runs it: 40
              steps of its ~100M model (f32) with a save every 10 steps through SCISPACE and a node
              failure before step 26: one restart from step 20, steps [10, 20, 30, 40] found by SDS, the
              loss falling, 12 f32 flash forward and 12 x 3 backward launches per step computed (45);
18. library — SDPA's backward through autograd at each backward case (softcap 0, the same
              mask; is_causal for a plain causal one), the backward's library yardstick.  It runs
              last: autograd leaves a cuBLAS workspace on its own thread, which would raise every
              later phase's peak.

It ends with the kernels' JSON line, the nvidia-smi line, and the line
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repository's src/ next to it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
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


def widened(got, want):
    """Both in f64 when either is (a result held against the exact one), else both in f32."""
    if max(got.element_size(), want.element_size()) == 8:
        return got.double(), want.double()
    return got.float(), want.float()


def n_outside(got, want, tol) -> int:
    got, want = widened(got, want)
    bad = ((got - want).abs() > tol["atol"] + tol["rtol"] * want.abs()) | ~got.isfinite()
    return int(bad.sum())


def check_close(name: str, got, want, tol) -> float:
    g, w = widened(got, want)
    err = (g - w).abs().max().item()
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
    # the dense phase's archs at their serve prompts' lengths and the 4096-token long prompt: codeqwen's
    # and olmoe's MHA at hd 128, nemotron's GQA 48/8 (six query heads per KV head); then G = 6 in f32
    for label, H, Kv in DENSE_ATTENTION:
        for S in (4, 23, 300, 4096):
            cases.append((label, "bfloat16", 1, S, S, H, Kv, 128, 0, 0.0, 0, True))
    cases.append(("nemotron", "float32", 1, 300, 300, 48, 8, 128, 0, 0.0, 0, True))
    return cases


# the attention geometry (label, H, Kv) of each arch of the dense phase, all at hd 128
DENSE_ATTENTION = (("codeqwen", 32, 32), ("nemotron", 48, 8), ("olmoe", 16, 16))


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
    "wkv6_train_rows_shifted": ("wkv6", "*reinterpret_cast<float4*>(dst + (size_t)row * C + 4 * cq) = x;",
                                "*reinterpret_cast<float4*>(dst + (size_t)((row + 1) % C) * C + 4 * cq) = x;"),
    "wkv6_bwd_no_bonus": ("wkv6_bwd", [(" + nn[t % 4] + rv * ui * ak[t % 4];", " + nn[t % 4];"),
                                       ("if (qt % BG == 0) bonus[t] = acc;", "if (qt % BG == 0) bonus[t] = 0.f;")]),
    "wkv6_bwd_ignores_ds_fin": ("wkv6_bwd", "const bool has_dsfin = ds_fin != nullptr;",
                                "const bool has_dsfin = false;"),
    # every decay of the dS carry dropped (dS_{t-1} = dS_t + r_t (x) dout_t): F_t, G_L, G_sig o r_sig, P(t, sig)
    # in B, in N and M and in dw's last sum; S_{t-1}'s own decays (G_t, H, J) kept
    "wkv6_bwd_no_decay_in_carry": ("wkv6_bwd", [
        ("GR[t * SP + i] = gt * rr[0];", "GR[t * SP + i] = rr[0];"),
        ("FK[t * SP + i] = ft * kk[0];", "FK[t * SP + i] = kk[0];"),
        ("if (sg == 3) GL[i] = up;", "if (sg == 3) GL[i] = 1.f;"),
        ("for (int x = 0; x < TR; ++x) uu[x] = later ? uu[x] * ww[x] : uu[x];",
         "for (int x = 0; x < TR; ++x) uu[x] = later ? uu[x] : uu[x];"),
        ("tp[t] = t + 1 < y0 ? wt[(t + 1) * SP + ci] * (t + 1 < TP ? tp[t + 1] : 1.f) : 1.f;", "tp[t] = 1.f;"),
        ("const float crw[4] = {rq[0], wq[0] * rq[1], wq[0] * wq[1] * rq[2], wq[0] * wq[1] * wq[2] * rq[3]};",
         "const float crw[4] = {rq[0], rq[1], rq[2], rq[3]};"),
        ("{{0.f, rq[1], wq[1] * rq[2], wq[1] * wq[2] * rq[3]},", "{{0.f, rq[1], rq[2], rq[3]},"),
        ("{0.f, 0.f, rq[2], wq[2] * rq[3]},", "{0.f, 0.f, rq[2], rq[3]},"),
        ("mm = fmaf(wv, mm, rv * xr[t]);", "mm = fmaf(1.f, mm, rv * xr[t]);"),
        ("for (int m = 0; m < 4; ++m) nn[m] = fmaf(wv, nn[m], rv * ac[m]);",
         "for (int m = 0; m < 4; ++m) nn[m] = fmaf(1.f, nn[m], rv * ac[m]);"),
        ("f *= wv;", "f *= 1.f;")]),
    # dw_t = rowsum(dS_t o S_t) = w_t rowsum(dS_t o S_{t-1}) + k_t (dS_t v_t), dS_t v_t as dk forms it
    "wkv6_bwd_dw_against_new_state": ("wkv6_bwd", "const float dwv = fmaf(gk[t % 4], mm, fmaf(f, dwa[t % 4], q));",
                                      "const float dwv = fmaf(wv, fmaf(gk[t % 4], mm, fmaf(f, dwa[t % 4], q)), "
                                      "kt[t * SP + ci] * (f * yr[t] + nn[t % 4]));"),
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
    "mamba_bwd_no_decay_in_carry": ("mamba_scan_bwd", "carry[s] = ga;", "carry[s] = g;"),
    "mamba_bwd_ignores_dh_fin": ("mamba_scan_bwd", "const bool has_dhfin = dh_fin != nullptr;",
                                 "const bool has_dhfin = false;"),
    "mamba_bwd_dA_without_delta": ("mamba_scan_bwd", "dA[s] = fmaf(gah, dt, dA[s]);", "dA[s] += gah;"),
    "mamba_bwd_dC_from_old_state": ("mamba_scan_bwd",
                                    "pbc[s / 2 * 4 + 2 + s % 2] = (k + 1 < CK ? hs[k + 1][s] : fmaf(a, ho[s], x * bq[s])) * dyt;",
                                    "pbc[s / 2 * 4 + 2 + s % 2] = ho[s] * dyt;"),
    # every span but the last recomputes its old states from the next span's saved state
    "mamba_bwd_state_from_next_span": ("mamba_scan_bwd", "(live ? (((size_t)b * nchunk + c) * di + ch) * DS",
                                       "(live ? (((size_t)b * nchunk + min(c + 1, nchunk - 1)) * di + ch) * DS"),
    "flash_bwd_no_softcap_derivative": ("flash_attention_bwd", "pd = p * (1.f - t * t);", "pd = p;"),
    "flash_bwd_first_head_only": ("flash_attention_bwd", "const int n_items = group * nq;",
                                  "const int n_items = nq;"),
    "flash_bwd_no_D": ("flash_attention_bwd", "return pd * (dp - d);", "return pd * dp;"),
    "flash_bwd_last_stage_unwritten": (
        "flash_attention_bwd",
        "      mbar_expect_tx(bar, 2 * TILE);\n      tma_tile<NC>(q_s + st * TILE, &q_map, bar, h, q0, b);\n"
        "      tma_tile<NC>(do_s + st * TILE, &do_map, bar, h, q0, b);\n",
        "      mbar_expect_tx(bar, (st == STAGES - 1 ? 1 : 2) * TILE);\n"
        "      tma_tile<NC>(q_s + st * TILE, &q_map, bar, h, q0, b);\n"
        "      if (st != STAGES - 1) tma_tile<NC>(do_s + st * TILE, &do_map, bar, h, q0, b);\n"),
}


def edited_source(name, entry):
    """The text of one ``table`` entry's kernel source with its edits made; each text must
    appear in the source exactly once, before its edit."""
    from repro_torch.kernels import _build

    kernel, *edit = entry
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    for good, bad in (edit[0] if len(edit) == 1 else [edit]):
        if src.count(good) != 1:
            raise AssertionError(f"{name}: {good!r} is not in {kernel}.cu exactly once")
        src = src.replace(good, bad)
    return src


def planted_sources(table=PLANTED, folder="planted"):
    """Write each edited copy of ``table`` under build/repro_torch/<folder>/ (never into
    the source tree).  Returns {name: (src, lib)}."""
    from repro_torch.kernels import _build

    out = {}
    for name, entry in table.items():
        src = edited_source(f"{folder} {name}", entry)
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
    # (source, kernels that must not spill, how many): the bf16 flash backward's dkdv and dq at 1-4 boxes of 64
    # columns; the WKV-6 backward at C = 8, 16, 32, 64 in f32 and bf16; the scan backward at ds 4, 8, 16
    for source, what, count in (("flash_attention_bwd", "bf16 backward", 8), ("wkv6_bwd", "WKV-6 backward", 8),
                                ("mamba_scan_bwd", "scan backward", 3)):
        fns = {fn: props for fn, props in function_properties(builds[source].log).items()
               if source != "flash_attention_bwd" or "_tc" in fn}
        spills = {fn: props for fn, props in fns.items()
                  if "0 bytes spill stores" not in props or "0 bytes spill loads" not in props}
        if len(fns) != count or spills:
            raise AssertionError(f"build: ptxas reports {len(fns)} of the {count} {what} kernels; spills: {spills}")
    import torch

    from repro_torch.kernels.flash_attention import backward_geometry

    log("build", f"stablelm-3b's hd 80 runs the backward padded to {backward_geometry(torch.bfloat16, 80).hd} "
                 f"columns: the 2-box instantiations of dkdv and dq, among the 8 checked for spills above")
    return {name: lib for name, (_, lib) in planted.items()}


def function_properties(ptxas_log: str) -> dict:
    """{kernel: its ptxas "N bytes stack frame, N bytes spill stores, N bytes spill loads" line}."""
    props, current = {}, None
    for line in ptxas_log.splitlines():
        if "Function properties for " in line:
            current = line.split("Function properties for ", 1)[1].strip()
        elif current and "spill stores" in line:
            props[current] = line.strip()
            current = None
    return props


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
    4608-token sequence, where the window binds; two rows of a ragged 300; f32 at 320.  Last,
    appended so that the earlier cases keep their seeds, the training shape with softcap 0 and
    window 0: plain causal attention, the function SDPA's causal backward computes; and
    stablelm-3b's training shape (MHA at hd 80, which the bf16 kernels pad to 128 columns; what the
    padding costs is priced by scripts/flash_variants.py --padding); and olmoe-1b-7b's (MHA at hd 128,
    unpadded, qk-norm outside the kernel); and jamba's attention layer (H32 Kv8 hd128, four query heads per KV
    head, no softcap, no window)."""
    return [("smoke", "bfloat16", 2, 64, 4, 2, 16, 0, 0.0),
            ("smoke", "float32", 2, 64, 4, 2, 16, 0, 0.0),
            ("gemma2-train", "bfloat16", 4, 2048, 8, 4, 256, 4096, 50.0),
            ("gemma2-train", "bfloat16", 4, 2048, 8, 4, 256, 0, 50.0),
            ("gemma2-window-binds", "bfloat16", 1, 4608, 8, 4, 256, 4096, 50.0),
            ("gemma2-B2-ragged", "bfloat16", 2, 300, 8, 4, 256, 0, 50.0),
            ("gemma2-f32", "float32", 1, 320, 8, 4, 256, 4096, 50.0),
            ("gemma2-train-causal", "bfloat16", 4, 2048, 8, 4, 256, 0, 0.0),
            ("stablelm-train", "bfloat16", 4, 2048, 32, 32, 80, 0, 0.0),
            ("olmoe-train", "bfloat16", 4, 2048, 16, 16, 128, 0, 0.0),
            ("jamba-train", "bfloat16", 4, 2048, 32, 8, 128, 0, 0.0)]


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
    import torch.nn.functional as F

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
        padded_zero = None
        wide = fa.backward_geometry(q.dtype, hd).hd
        if wide != hd:  # what the wrapper runs: the columns padded with zeros must come out zero, the rest bitwise
            padded = [F.pad(x, (0, wide - hd)) for x in (q, k, v, o, do)]
            full = fa.flash_attention_bwd(*padded[:4], lse, padded[4], scale=1.0 / math.sqrt(hd), **kw)
            padded_zero = not any(int(g[..., hd:].count_nonzero()) for g in full)
            if not padded_zero or not all(torch.equal(g[..., :hd], w) for g, w in zip(full, grads)):
                raise AssertionError(f"{name}: with hd padded to {wide} the padded gradient columns are not zero, "
                                     f"or the others differ from the wrapper's")
        launches, _ = fa.backward_launches(q, k, v, o, lse, do, **kw)
        kernel_ms = {kname: cuda_ms(torch, launch) for kname, launch in launches}
        backward_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        forward_ms = cuda_ms(torch, lambda: fa.flash_attention_with_lse(q, k, v, **kw))
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw), max_reps=5)
        bounds = backward_bounds(torch, dtype, B, S, H, Kv, hd, window)
        row = dict(case=name, label=label, dtype=dtype, B=B, S=S, H=H, Kv=Kv, hd=hd, window=window, cap=cap,
                   seed=seed, max_abs_err=errs, tol=tols, padded_hd=wide, padded_columns_zero=padded_zero,
                   kernel_ms=kernel_ms, backward_ms=backward_ms,
                   forward_with_lse_ms=forward_ms,
                   plain_ms=plain_ms, plain="flash_attention_bwd_plain (all three gradients)",
                   bound_ms={n: b[0] for n, b in bounds.items()}, bound_by={n: b[1] for n, b in bounds.items()},
                   card=card)
        print(json.dumps(row), flush=True)
        if label.startswith(("gemma2-train", "stablelm-train", "olmoe-train", "jamba-train")) and not backward_ms < plain_ms:
            raise AssertionError(f"{name}: the backward kernels take {backward_ms:.3f} ms, no faster than "
                                 f"their plain version's {plain_ms:.3f} ms")
        rows.append(row)
    return rows


# the planted backward faults' geometries (B, S, H, Kv, hd), each with softcap 50 and q scaled by 4 so that
# 1 - t² is far from 1: gemma2's, and stablelm-3b's training shape (hd 80, padded to 128 columns)
PLANTED_BWD_SHAPES = ((1, 2048, 8, 4, 256), (4, 2048, 32, 32, 80))
# stablelm's heads with 4 per KV head: where the first-head-only fault can show at hd 80
PLANTED_BWD_GROUPED_HD80 = (4, 2048, 32, 8, 80)


def backward_planted_checks(torch, card, planted, shape, names=None):
    """Each faulty build of the backward must put elements of dq, dk or dv outside the bf16 gate,
    where the committed build puts none, at ``shape`` with softcap 50 and q scaled by 4.  With one
    query head per KV head (G = 1) the first-head-only fault changes nothing: there it must give
    the committed build's gradients bitwise."""
    import ctypes

    import repro_torch.kernels.flash_attention as fa

    B, S, H, Kv, hd = shape
    kw = dict(causal=True, window=0, logit_softcap=50.0)
    q, k, v, do = backward_inputs(torch, "bfloat16", B, S, H, Kv, hd, 4.0, seed=400)
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    tols = [grad_tol("bfloat16", w) for w in plain]

    def outside(grads):
        return {g: n_outside(got, want, tol) for g, got, want, tol in zip(("dq", "dk", "dv"), grads, plain, tols)}

    committed = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    good = outside(committed)
    if any(good.values()):
        raise AssertionError(f"planted: the committed backward fails its own gate at q x 4: {good}")
    case = f"bfloat16 B{B} S=T={S} H{H} Kv{Kv} hd{hd} window0 cap50, q x 4"
    checks = (("flash_bwd_no_softcap_derivative", "the softcap's derivative 1 - t^2 is dropped"),
              ("flash_bwd_first_head_only", "dk and dv come from the first query head of each group only"),
              ("flash_bwd_no_D", "D = rowsum(do o) is left out of ds"),
              ("flash_bwd_last_stage_unwritten",
               "dk / dv never load dO into the last stage of the TMA ring (its expected bytes cut to match)"))
    for name, fault in checks:
        if names is not None and name not in names:
            continue
        lib = fa._bind_bwd(ctypes.CDLL(str(planted[name])))
        good_lib, fa._bwd_lib = fa._bwd_lib, lambda: lib
        try:
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
        finally:
            fa._bwd_lib = good_lib
        bad = outside(grads)
        no_op = name == "flash_bwd_first_head_only" and H == Kv
        same = all(torch.equal(a, b) for a, b in zip(grads, committed))
        log("planted", json.dumps(dict(fault=f"flash backward: {fault}", case=case, outside_tol=bad,
                                       committed_outside_tol=good, bitwise_committed=same,
                                       expected="bitwise the committed build (G = 1)" if no_op else "outside",
                                       elements=[g.numel() for g in grads], tol=tols, card=card)))
        if no_op and not same:
            raise AssertionError(f"planted {name}: at G = 1 the fault changes nothing, yet the gradients differ")
        if not no_op and not any(bad.values()):
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
# phase 3, WKV-6 backward: the kernel against wkv6_bwd_plain, the forward's training form, planted faults
# ---------------------------------------------------------------------------

WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")


def wkv6_bwd_cases():
    """(label, dtype, B, S, H, C, s0 and ds_fin given): the smoke C = 16 in bf16 and (with s0 and ds_fin)
    f32; rwkv6's training shape (bf16 B4 S2048 H64 C64, no s0 or ds_fin, as training calls it); a ragged
    S = 300 with s0 and ds_fin (a last chunk of 12 tokens); f32 at S = 320.  Then decays near the clamp
    (labels ending in "clamp", see WKV_NEAR_CLAMP) in f32 and bf16, appended so that the earlier cases keep
    their seeds.  Last, the kernel's other tilings, C = 8 and 32 (H8), in f32 and bf16 at a ragged S = 300 with
    s0 and ds_fin."""
    return [("smoke", "bfloat16", 2, 64, 4, 16, False),
            ("smoke", "float32", 2, 64, 4, 16, True),
            ("rwkv6-train", "bfloat16", 4, 2048, 64, 64, False),
            ("rwkv6-ragged", "bfloat16", 1, 300, 64, 64, True),
            ("rwkv6-f32", "float32", 2, 320, 64, 64, True),
            ("rwkv6-clamp", "float32", 2, 320, 64, 64, True),
            ("rwkv6-ragged-clamp", "bfloat16", 1, 300, 64, 64, True),
            ("c8-ragged", "float32", 2, 300, 8, 8, True),
            ("c8-ragged", "bfloat16", 2, 300, 8, 8, True),
            ("c32-ragged", "float32", 2, 300, 8, 32, True),
            ("c32-ragged", "bfloat16", 2, 300, 8, 32, True)]


# decays near the reference's clamp max(w, 1e-38), each on a share of w: (share, value).  Above it 1e-36 and
# 1e-30; at it the f32 1e-38 itself, where dw must already be 0 (w > 1e-38 is strict); under it 1e-40 and 0.
WKV_W_MIN = 1e-38
WKV_NEAR_CLAMP = ((0.10, 1e-36), (0.05, 1e-30), (0.05, WKV_W_MIN), (0.05, 1e-40), (0.05, 0.0))


def wkv6_bwd_inputs(torch, dtype, B, S, H, C, carried, seed, near_clamp=False):
    """r, k, v, w, u as wkv6_inputs draws them; s0 and ds_fin ~ N(0, 1) when ``carried``; dout ~ N(0, 1), f32.
    With ``near_clamp`` the shares of w in WKV_NEAR_CLAMP are then set to their values."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v, w, u = wkv6_inputs(torch, gen, dtype, B, S, H, C)
    s0 = torch.randn((B, H, C, C), generator=gen, device="cuda") if carried else None
    dout = torch.randn((B, S, H, C), generator=gen, device="cuda")
    ds_fin = torch.randn((B, H, C, C), generator=gen, device="cuda") if carried else None
    if near_clamp:
        m, lo = torch.rand(w.shape, generator=gen, device="cuda"), 0.0
        for share, value in WKV_NEAR_CLAMP:
            w = torch.where((m >= lo) & (m < lo + share), torch.full_like(w, value), w)
            lo += share
    return r, k, v, w, u, s0, dout, ds_fin


def wkv6_bwd_tols(dtype, plain) -> dict:
    """bf16 dr, dk, dv at the backward's bf16 gate (2e-2 x rms, rtol 2e-2: both round an f32 result to bf16
    once); f32 ones, and dw, du and ds0 (f32 in every dtype), at the scan gate (1e-4 x rms, rtol 1e-4)."""
    return {g: grad_tol("bfloat16", p) if dtype == "bfloat16" and g in ("dr", "dk", "dv") else scan_tol(p)
            for g, p in zip(WKV_GRADS, plain)}


def wkv6_train_bounds(dtype, B, S, H, C, with_s0, with_dsfin):
    """{"forward_train": ..., "backward": ...}: (least ms, "bytes" or "operations").

    The training form is the forward (wkv6_bound's count) plus the states it saves, f32 [B, H, ceil(S / 16), C, C].
    The backward's f32 operations are counted in the cheapest form known, the chunked one of csrc/wkv6_bwd.cu's
    header, per head and chunk of L = 16 tokens: the four C x C x L products (X, Y, Z and E's rank-L update)
    8 C^2 L; E's decay and q = rowsum(E o S) 3 C^2; the token sums 7.5 C L^2 (A over all L^2 token pairs 2,
    B over the pairs sig > t with their decays 1.5, dv 1, the recurrences H and N 2, dw's last sum 1); and
    about 30 C L for the decays' products, J, M and each token's dr, dk, dw, du and bonus.  Bytes, each once:
    r, k, v read and dr, dk, dv written in their dtype, w, dout, dw and the saved states in f32, u, du and ds0
    (ds_fin) in f32.
    """
    from repro_torch.kernels.wkv6 import CHECKPOINT

    L = CHECKPOINT
    n, nchunk = B * S * H * C, -(-S // L)
    states = B * H * nchunk * C * C
    elt = 2 if dtype == "bfloat16" else 4
    fwd_ops_ms = 5.0 * B * S * H * C * C / PEAK_FLOPS["float32"] * 1e3
    fwd_bytes_ms = (3 * elt * n + 4 * (2 * n + H * C + (2 if with_s0 else 1) * B * H * C * C + states)) \
        / HBM_BYTES_PER_S * 1e3
    bwd_bytes = 6 * elt * n + 4 * (3 * n + states + 2 * H * C + (2 if with_dsfin else 1) * B * H * C * C)
    bwd_ops = B * H * (nchunk * (8.0 * C * C * L + 3.0 * C * C + 7.5 * C * L * L + 30.0 * C * L))
    bwd_ops_ms = bwd_ops / PEAK_FLOPS["float32"] * 1e3
    bwd_bytes_ms = bwd_bytes / HBM_BYTES_PER_S * 1e3
    return {"forward_train": (max(fwd_ops_ms, fwd_bytes_ms), "bytes" if fwd_bytes_ms >= fwd_ops_ms else "operations"),
            "backward": (max(bwd_ops_ms, bwd_bytes_ms), "bytes" if bwd_bytes_ms >= bwd_ops_ms else "operations")}


def run_wkv6_bwd_cases(torch, card):
    """Each case: the training form's out and final state bitwise the serving form's and within the scan
    gate of the plain version's, and its first saved state s0; the backward kernel against wkv6_bwd_plain at each gradient's gate, two calls bitwise equal;
    CUDA-event times of both kernels, the serving forward, the plain versions, and the bounds.  The backward
    must beat its plain version at the training shape."""
    import repro_torch.kernels.wkv6 as wk

    rows = []
    for seed, (label, dtype, B, S, H, C, carried) in enumerate(wkv6_bwd_cases(), start=500):
        near_clamp = label.endswith("clamp")
        # near the clamp the chunked plain forward's f32 cumulative log-decays reach thousands and lose the
        # scan gate's precision in their differences; at chunk 1 it is the recurrence itself
        plain_chunk = 1 if near_clamp else 256
        r, k, v, w, u, s0, dout, ds_fin = wkv6_bwd_inputs(torch, dtype, B, S, H, C, carried, seed, near_clamp)
        name = f"{label} {dtype} B{B} S{S} H{H} C{C}" + (" s0 ds_fin" if carried else "")
        out, s_fin = wk._launch(r, k, v, w, u, s0)
        out_t, s_fin_t, s_chk = wk._launch(r, k, v, w, u, s0, train=True)
        first = torch.zeros_like(s_chk[:, :, 0]) if s0 is None else s0
        if not (torch.equal(out, out_t) and torch.equal(s_fin, s_fin_t) and torch.equal(s_chk[:, :, 0], first)):
            raise AssertionError(f"{name}: the training form's out / final state differ from the serving form's, "
                                 f"or its first saved state is not s0")
        plain_out, plain_state = wk.wkv6_plain(r, k, v, w, u, chunk=plain_chunk, s0=s0)
        fwd_err = max(check_close(f"{name} training form", out_t, plain_out, scan_tol(plain_out)),
                      check_close(f"{name} training form, final state", s_fin_t, plain_state, scan_tol(plain_state)))
        del plain_out, plain_state
        before = wk.wkv6_bwd.launches
        grads = wk.wkv6_bwd(r, k, v, w, u, s_chk, dout, ds_fin)
        again = wk.wkv6_bwd(r, k, v, w, u, s_chk, dout, ds_fin)
        torch.cuda.synchronize()
        if wk.wkv6_bwd.launches != before + 2:
            raise AssertionError(f"{name}: {wk.wkv6_bwd.launches - before} backward launches for two calls")
        bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
        if not bitwise:
            raise AssertionError(f"{name}: two backward calls differ")
        plain = wk.wkv6_bwd_plain(r, k, v, w, u, s0, dout, ds_fin)
        tols = wkv6_bwd_tols(dtype, plain)
        errs = {}
        for g, got, want in zip(WKV_GRADS, grads, plain):
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {g}: {got.dtype} {tuple(got.shape)}, plain {want.dtype} "
                                     f"{tuple(want.shape)}")
            errs[g] = check_close(f"{name} {g}", got, want, tols[g])
        clamped = None
        if near_clamp:  # dw exactly 0 where w <= 1e-38, as the plain version's
            under = w <= WKV_W_MIN
            clamped = dict(elements=int(under.sum()), at_w_min=int((w == WKV_W_MIN).sum()),
                           nonzero_dw=int((grads[3][under] != 0).sum()), plain_nonzero_dw=int((plain[3][under] != 0).sum()))
            if not clamped["at_w_min"] or clamped["nonzero_dw"] or clamped["plain_nonzero_dw"]:
                raise AssertionError(f"{name}: dw where w <= 1e-38 must be exactly 0: {clamped}")
        kernel_ms = cuda_ms(torch, lambda: wk.wkv6_bwd(r, k, v, w, u, s_chk, dout, ds_fin))
        train_ms = cuda_ms(torch, lambda: wk._launch(r, k, v, w, u, s0, train=True))
        serve_ms = cuda_ms(torch, lambda: wk._launch(r, k, v, w, u, s0))
        plain_ms = cuda_ms(torch, lambda: wk.wkv6_bwd_plain(r, k, v, w, u, s0, dout, ds_fin), max_reps=2)
        plain_fwd_ms = cuda_ms(torch, lambda: wk.wkv6_plain(r, k, v, w, u, chunk=plain_chunk, s0=s0), max_reps=2)
        bounds = wkv6_train_bounds(dtype, B, S, H, C, s0 is not None, ds_fin is not None)
        row = dict(case=name, label=label, dtype=dtype, seed=seed, max_abs_err=errs, tol=tols, bitwise_repeat=bitwise,
                   forward_max_abs_err=fwd_err, near_clamp=clamped,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, plain="wkv6_bwd_plain (token by token, f32)",
                   forward_train_ms=train_ms, forward_serve_ms=serve_ms, plain_forward_ms=plain_fwd_ms,
                   bound_ms={n_: b[0] for n_, b in bounds.items()}, bound_by={n_: b[1] for n_, b in bounds.items()},
                   library_ms=None, library="none", card=card)
        print(json.dumps(row), flush=True)
        if label == "rwkv6-train" and not kernel_ms < plain_ms:
            raise AssertionError(f"{name}: the backward kernel takes {kernel_ms:.3f} ms, no faster than its plain "
                                 f"version's {plain_ms:.3f} ms")
        rows.append(row)
        del r, k, v, w, u, s0, dout, ds_fin, grads, again, plain, s_chk
    torch.cuda.empty_cache()
    return rows


def wkv6_bwd_plain_with_fault(torch, r, k, v, w, u, s0, dout, ds_fin, fault):
    """wkv6_bwd_plain's recurrence (f32, token by token, every old state kept) with one planted fault written
    into it, for the planted kernels to be held against: "no_bonus" (dk and dv without the bonus term),
    "ignores_ds_fin" (the sweep starts from zero), "no_decay" (dS_{t-1} = dS_t + r_t (x) dout_t), "dw_new"
    (dw_t = rowsum(dS_t o S_t))."""
    rf, kf, vf, wf, df = (x.float() for x in (r, k, v, w, dout))
    uf = u.float()
    state, old = s0.float(), []
    for t in range(r.shape[1]):
        old.append(state)
        state = wf[:, t, :, :, None] * state + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    old.append(state)
    vd = (vf * df).sum(-1, keepdim=True)
    bonus = 0.0 if fault == "no_bonus" else 1.0
    dr, dk = uf * kf * vd, bonus * rf * uf * vd
    dv = bonus * (rf * uf * kf).sum(-1, keepdim=True) * df
    dw = torch.empty_like(wf)
    ds = torch.zeros_like(s0.float()) if fault == "ignores_ds_fin" else ds_fin.float()
    for t in reversed(range(r.shape[1])):
        dr[:, t] += torch.einsum("bhij,bhj->bhi", old[t], df[:, t])
        dk[:, t] += torch.einsum("bhij,bhj->bhi", ds, vf[:, t])
        dv[:, t] += torch.einsum("bhij,bhi->bhj", ds, kf[:, t])
        dw[:, t] = (ds * old[t + 1 if fault == "dw_new" else t]).sum(-1)
        ds = (1.0 if fault == "no_decay" else wf[:, t, :, :, None]) * ds + rf[:, t, :, :, None] * df[:, t, :, None, :]
    du = (rf * kf * vd).sum(dim=(0, 1))
    dw = torch.where(wf > WKV_W_MIN, dw, torch.zeros_like(dw))
    return dr, dk, dv, dw, du, ds


def wkv6_bwd_planted_checks(torch, card, planted):
    """Each faulty build of the WKV-6 backward must put elements of some gradient outside its gate, at f32
    B2 S320 H64 C64 with s0 and ds_fin, where the committed build puts none, and must itself pass that gate
    against wkv6_bwd_plain_with_fault, the same fault written into the recurrence: the fault is the one its
    name says.  So must the committed backward fed by the training form whose staged store shifts the saved
    states' rows by one fail the gate."""
    import ctypes

    import repro_torch.kernels.wkv6 as wk

    B, S, H, C = 2, 320, 64, 64
    r, k, v, w, u, s0, dout, ds_fin = wkv6_bwd_inputs(torch, "float32", B, S, H, C, True, seed=600)
    _, _, s_chk = wk._launch(r, k, v, w, u, s0, train=True)
    plain = wk.wkv6_bwd_plain(r, k, v, w, u, s0, dout, ds_fin)
    tols = wkv6_bwd_tols("float32", plain)

    def outside(grads):
        return {g: n_outside(got, want, tols[g]) for g, got, want in zip(WKV_GRADS, grads, plain)}

    good = outside(wk.wkv6_bwd(r, k, v, w, u, s_chk, dout, ds_fin))
    if any(good.values()):
        raise AssertionError(f"planted: the committed WKV-6 backward fails its own gate: {good}")
    checks = (("wkv6_bwd_no_bonus", "the bonus term is dropped from dk and dv", "no_bonus"),
              ("wkv6_bwd_ignores_ds_fin", "ds_fin is ignored (the sweep starts from zero)", "ignores_ds_fin"),
              ("wkv6_bwd_no_decay_in_carry", "the dS carry has no decay: dS_{t-1} = dS_t + r_t (x) dout_t",
               "no_decay"),
              ("wkv6_bwd_dw_against_new_state", "dw is taken against S_t instead of S_{t-1}", "dw_new"))
    checks += (("wkv6_train_rows_shifted", "the training form's staged store shifts the saved states' rows by one",
                None),)
    for name, fault, written_out in checks:
        train_fault = name.startswith("wkv6_train")
        lib = (wk._bind if train_fault else wk._bind_bwd)(ctypes.CDLL(str(planted[name])))
        if train_fault:
            good_lib, wk._lib = wk._lib, lambda: lib
            try:
                _, _, bad_chk = wk._launch(r, k, v, w, u, s0, train=True)
                torch.cuda.synchronize()
            finally:
                wk._lib = good_lib
            grads = wk.wkv6_bwd(r, k, v, w, u, bad_chk, dout, ds_fin)
            torch.cuda.synchronize()
        else:
            good_lib, wk._bwd_lib = wk._bwd_lib, lambda: lib
            try:
                grads = wk.wkv6_bwd(r, k, v, w, u, s_chk, dout, ds_fin)
                torch.cuda.synchronize()
            finally:
                wk._bwd_lib = good_lib
        bad = outside(grads)
        as_named = None
        if written_out:  # the planted kernel against the recurrence with the same fault, at the same gate
            meaning = wkv6_bwd_plain_with_fault(torch, r, k, v, w, u, s0, dout, ds_fin, written_out)
            as_named = {g: n_outside(got, want, scan_tol(want)) for g, got, want in zip(WKV_GRADS, grads, meaning)}
            del meaning
        log("planted", json.dumps(dict(fault=f"WKV-6 backward: {fault}", case=f"float32 B{B} S{S} H{H} C{C} s0 ds_fin",
                                       outside_tol=bad, committed_outside_tol=good, tol=tols,
                                       outside_tol_of_the_fault_written_out=as_named,
                                       elements={g: x.numel() for g, x in zip(WKV_GRADS, grads)}, card=card)))
        if not any(bad.values()):
            raise AssertionError(f"planted {name}: the WKV-6 backward gate passed a kernel where {fault}")
        if as_named and any(as_named.values()):
            raise AssertionError(f"planted {name}: the kernel is not the recurrence where {fault}: {as_named}")


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
# phase 3, selective-scan backward: the kernel against mamba_scan_bwd_plain, the forward's training form,
# planted faults
# ---------------------------------------------------------------------------

SCAN_GRADS = ("du", "ddelta", "dA", "dB", "dC", "dh0")


def mamba_bwd_cases():
    """(label, B, S, di, ds, h0 and dh_fin given), all f32: the smoke width (di 128, ds 8) with h0 and dh_fin;
    jamba's training shape (B4 S2048 di8192 ds16, no h0 or dh_fin, as training calls it); a ragged S = 300 at
    jamba's width with h0 and dh_fin (a last span of 12 tokens); and a ragged di of 202 (rows that are not
    whole 16-byte chunks, a last block of 10 channels)."""
    return [("smoke", 2, 64, *SCAN_GEOMETRY["smoke"][:2], True),
            ("jamba-train", 4, 2048, *SCAN_GEOMETRY["jamba"][:2], False),
            ("jamba-ragged", 1, 300, *SCAN_GEOMETRY["jamba"][:2], True),
            ("jamba-ragged-di", 2, 300, 202, SCAN_GEOMETRY["jamba"][1], True)]


def mamba_bwd_inputs(torch, label, B, S, di, ds, carried, seed):
    """u, delta, A, B, C as mamba_inputs draws them; h0, dh_fin ~ N(0, 1) when ``carried``; dy ~ N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u, delta, A, Bm, Cm = mamba_inputs(torch, gen, "smoke" if label == "smoke" else "jamba", B, S, di, ds)
    h0 = torch.randn((B, di, ds), generator=gen, device="cuda") if carried else None
    dy = torch.randn((B, S, di), generator=gen, device="cuda")
    dh_fin = torch.randn((B, di, ds), generator=gen, device="cuda") if carried else None
    return u, delta, A, Bm, Cm, h0, dy, dh_fin


def mamba_bwd_exact(ms, *inputs):
    """The exact gradients: mamba_scan_bwd_plain on the inputs (u, delta, A, B, C, h0, dy, dh_fin) taken to f64."""
    return ms.mamba_scan_bwd_plain(*(None if x is None else x.double() for x in inputs))


def mamba_bwd_tols(exact, plain) -> dict:
    """Each gradient's gate against the exact one: atol the f32 plain version's own max |error| from it plus
    1e-4 x rms(exact), rtol 1e-4.  So a kernel passes when it comes no further from the exact gradient than
    mamba_scan_bwd_plain in f32 does, within the scan tolerance (the plain version passes by construction).
    The f32 plain version is not the yardstick itself: its rounding is part of what is measured (dDelta 2.2e-4
    of its rms from exact at the training shape), and a gate of 1e-4 against it would measure how alike two
    roundings are.  dA (a sum over B x S tokens), dB and dC (sums over di channels) take the same rule: their
    f32 rounding, that of the plain version too, is in the first term."""
    tols = {}
    for g, e, p in zip(SCAN_GRADS, exact, plain):
        rms = e.pow(2).mean().sqrt().item()
        tols[g] = dict(atol=(p.double() - e).abs().max().item() + SCAN_REL * rms, rtol=SCAN_REL)
    return tols


def over_rms(got, want) -> float:
    """max |got - want| over rms(want), in f64 when either is."""
    got, want = widened(got, want)
    return (got - want).abs().max().item() / want.pow(2).mean().sqrt().item()


def mamba_train_bounds(B, S, di, ds, with_h0, with_dhfin):
    """{"forward_train": ..., "backward": ...}: (least ms, "bytes" or "operations").

    The training form is the forward (mamba_bound's count) plus the states it saves, f32 [B, ceil(S / 16), di,
    ds].  The backward, per token, channel and state: recomputing the state (4 FLOP, one exponential) and the
    gradient (17 FLOP: g's, B.g's, ddelta's and dA's multiply-adds, g a, g a h, g delta u, h_t dy, the carry,
    the adds of dB and dC across channels); bytes, each once: u, delta, dy and the saved states read, du and
    ddelta written, all f32; B, C, dB, dC, A, dA, dh0 (and dh_fin) are small but counted.
    """
    from repro_torch.kernels.mamba_scan import CHECKPOINT

    states = 4 * B * -(-S // CHECKPOINT) * di * ds
    fwd_bytes = 4 * (3 * B * S * di + 2 * B * S * ds + di * ds + (2 if with_h0 else 1) * B * di * ds) + states
    fwd_bytes_ms = fwd_bytes / HBM_BYTES_PER_S * 1e3
    fwd_ops_ms = max(B * S * di * (6.0 * ds + 1) / PEAK_FLOPS["float32"], B * S * di * ds / EXP_PER_S) * 1e3
    n = B * S * di * ds
    bwd_ops_ms = max(21.0 * n / PEAK_FLOPS["float32"], n / EXP_PER_S) * 1e3
    bwd_bytes = 4 * (5 * B * S * di + 4 * B * S * ds + 2 * di * ds + (2 if with_dhfin else 1) * B * di * ds) + states
    bwd_bytes_ms = bwd_bytes / HBM_BYTES_PER_S * 1e3
    return {"forward_train": (max(fwd_ops_ms, fwd_bytes_ms), "bytes" if fwd_bytes_ms >= fwd_ops_ms else "operations"),
            "backward": (max(bwd_ops_ms, bwd_bytes_ms), "bytes" if bwd_bytes_ms >= bwd_ops_ms else "operations")}


def run_mamba_bwd_cases(torch, card):
    """Each case: the training form's y and final state bitwise the serving form's and within the scan gate of the
    plain version's, its first saved state h0 (or zero); the backward kernel against the exact gradients at each
    gradient's gate (mamba_bwd_tols), two calls bitwise equal, its distance from the f32 plain version recorded;
    CUDA-event times of both kernels, the serving forward, the plain versions, and the bounds.  The backward must
    beat its plain version at the training shape."""
    import repro_torch.kernels.mamba_scan as ms

    rows = []
    chunk = SCAN_GEOMETRY["jamba"][2]
    for seed, (label, B, S, di, ds, carried) in enumerate(mamba_bwd_cases(), start=700):
        u, delta, A, Bm, Cm, h0, dy, dh_fin = mamba_bwd_inputs(torch, label, B, S, di, ds, carried, seed)
        name = f"{label} float32 B{B} S{S} di{di} ds{ds}" + (" h0 dh_fin" if carried else "")
        y, h_fin = ms._launch(u, delta, A, Bm, Cm, h0)
        y_t, h_fin_t, h_chk = ms._launch(u, delta, A, Bm, Cm, h0, train=True)
        first = torch.zeros_like(h_chk[:, 0]) if h0 is None else h0
        if not (torch.equal(y, y_t) and torch.equal(h_fin, h_fin_t) and torch.equal(h_chk[:, 0], first)):
            raise AssertionError(f"{name}: the training form's y / final state differ from the serving form's, "
                                 f"or its first saved state is not h0")
        plain_y, plain_state = ms.mamba_scan_plain(u, delta, A, Bm, Cm, chunk=chunk, h0=h0)
        fwd_err = max(check_close(f"{name} training form", y_t, plain_y, scan_tol(plain_y)),
                      check_close(f"{name} training form, final state", h_fin_t, plain_state, scan_tol(plain_state)))
        del plain_y, plain_state
        before = ms.mamba_scan_bwd.launches
        grads = ms.mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy, dh_fin)
        again = ms.mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy, dh_fin)
        torch.cuda.synchronize()
        if ms.mamba_scan_bwd.launches != before + 2:
            raise AssertionError(f"{name}: {ms.mamba_scan_bwd.launches - before} backward launches for two calls")
        bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
        if not bitwise:
            raise AssertionError(f"{name}: two backward calls differ")
        plain = ms.mamba_scan_bwd_plain(u, delta, A, Bm, Cm, h0, dy, dh_fin)
        exact = mamba_bwd_exact(ms, u, delta, A, Bm, Cm, h0, dy, dh_fin)
        tols = mamba_bwd_tols(exact, plain)
        errs = {}
        for g, got, want, p in zip(SCAN_GRADS, grads, exact, plain):
            if got.shape != p.shape or got.dtype != p.dtype:
                raise AssertionError(f"{name} {g}: {got.dtype} {tuple(got.shape)}, plain {p.dtype} {tuple(p.shape)}")
            errs[g] = check_close(f"{name} {g} against exact", got, want, tols[g])
        rel = {g: over_rms(got, e) for g, got, e in zip(SCAN_GRADS, grads, exact)}
        plain_rel = {g: over_rms(p, e) for g, p, e in zip(SCAN_GRADS, plain, exact)}
        vs_plain = {g: over_rms(got, p) for g, got, p in zip(SCAN_GRADS, grads, plain)}
        del exact
        kernel_ms = cuda_ms(torch, lambda: ms.mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy, dh_fin))
        train_ms = cuda_ms(torch, lambda: ms._launch(u, delta, A, Bm, Cm, h0, train=True))
        serve_ms = cuda_ms(torch, lambda: ms._launch(u, delta, A, Bm, Cm, h0))
        plain_ms = cuda_ms(torch, lambda: ms.mamba_scan_bwd_plain(u, delta, A, Bm, Cm, h0, dy, dh_fin), max_reps=2)
        plain_fwd_ms = cuda_ms(torch, lambda: ms.mamba_scan_plain(u, delta, A, Bm, Cm, chunk=chunk, h0=h0), max_reps=2)
        bounds = mamba_train_bounds(B, S, di, ds, h0 is not None, dh_fin is not None)
        row = dict(case=name, label=label, dtype="float32", seed=seed, max_abs_err=errs, max_err_over_rms=rel,
                   plain_max_err_over_rms=plain_rel, max_err_over_rms_vs_plain=vs_plain,
                   against="exact: mamba_scan_bwd_plain in f64", tol=tols, bitwise_repeat=bitwise,
                   forward_max_abs_err=fwd_err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   plain="mamba_scan_bwd_plain (token by token, f32)", forward_train_ms=train_ms,
                   forward_serve_ms=serve_ms, plain_forward_ms=plain_fwd_ms,
                   plain_forward="mamba_scan_plain (chunk 256)",
                   bound_ms={n_: b[0] for n_, b in bounds.items()}, bound_by={n_: b[1] for n_, b in bounds.items()},
                   library_ms=None, library="none", card=card)
        print(json.dumps(row), flush=True)
        if label == "jamba-train" and not kernel_ms < plain_ms:
            raise AssertionError(f"{name}: the backward kernel takes {kernel_ms:.3f} ms, no faster than its plain "
                                 f"version's {plain_ms:.3f} ms")
        rows.append(row)
        del u, delta, A, Bm, Cm, h0, dy, dh_fin, grads, again, plain, h_chk, y, y_t
    torch.cuda.empty_cache()
    return rows


def mamba_bwd_planted_checks(torch, card, planted):
    """Each faulty build of the scan's backward must put elements of some gradient outside its gate against the
    exact gradients, at f32 B2 S320 at jamba's width with h0 and dh_fin, where the committed build puts none."""
    import ctypes

    import repro_torch.kernels.mamba_scan as ms

    B, S, (di, ds, _) = 2, 320, SCAN_GEOMETRY["jamba"]
    u, delta, A, Bm, Cm, h0, dy, dh_fin = mamba_bwd_inputs(torch, "jamba", B, S, di, ds, True, seed=800)
    _, _, h_chk = ms._launch(u, delta, A, Bm, Cm, h0, train=True)
    plain = ms.mamba_scan_bwd_plain(u, delta, A, Bm, Cm, h0, dy, dh_fin)
    exact = mamba_bwd_exact(ms, u, delta, A, Bm, Cm, h0, dy, dh_fin)
    tols = mamba_bwd_tols(exact, plain)

    def outside(grads):
        return {g: n_outside(got, want, tols[g]) for g, got, want in zip(SCAN_GRADS, grads, exact)}

    good = outside(ms.mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy, dh_fin))
    if any(good.values()):
        raise AssertionError(f"planted: the committed scan backward fails its own gate: {good}")
    checks = (("mamba_bwd_no_decay_in_carry", "the carry has no decay: g_t-1 = C dy + g_t"),
              ("mamba_bwd_ignores_dh_fin", "dh_fin is ignored (the sweep starts from zero)"),
              ("mamba_bwd_dA_without_delta", "dA sums g a h_t-1 without its factor delta"),
              ("mamba_bwd_dC_from_old_state", "dC is taken against h_t-1 instead of h_t"),
              ("mamba_bwd_state_from_next_span", "each span but the last recomputes from the next span's saved state"))
    for name, fault in checks:
        lib = ms._bind_bwd(ctypes.CDLL(str(planted[name])))
        good_lib, ms._bwd_lib = ms._bwd_lib, lambda: lib
        try:
            grads = ms.mamba_scan_bwd(u, delta, A, Bm, Cm, h_chk, dy, dh_fin)
            torch.cuda.synchronize()
        finally:
            ms._bwd_lib = good_lib
        bad = outside(grads)
        log("planted", json.dumps(dict(fault=f"selective-scan backward: {fault}",
                                       case=f"float32 B{B} S{S} di{di} ds{ds} h0 dh_fin", outside_tol=bad,
                                       committed_outside_tol=good, tol=tols,
                                       elements={g: x.numel() for g, x in zip(SCAN_GRADS, grads)}, card=card)))
        if not any(bad.values()):
            raise AssertionError(f"planted {name}: the scan backward gate passed a kernel where {fault}")


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
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd

    return {"flash_attention": (flash_attention, "launches"),
            "flash_attention_wgmma": (flash_attention, "launches_wgmma"),
            "flash_attention_scalar": (flash_attention, "launches_scalar"),
            "flash_attention_bwd_rowdot": (flash_attention_bwd, "launches_rowdot"),
            "flash_attention_bwd_dkdv": (flash_attention_bwd, "launches_dkdv"),
            "flash_attention_bwd_dq": (flash_attention_bwd, "launches_dq"),
            "wkv6": (wkv6, "launches"), "wkv6_train": (wkv6, "launches_train"), "wkv6_bwd": (wkv6_bwd, "launches"),
            "mamba_scan": (mamba_scan, "launches"), "mamba_scan_train": (mamba_scan, "launches_train"),
            "mamba_scan_bwd": (mamba_scan_bwd, "launches")}


def launch_counts(n_flash: int = 0, n_wkv6: int = 0, n_scan: int = 0, n_bwd: int = 0, n_wkv6_train: int = 0,
                  n_wkv6_bwd: int = 0, n_scan_train: int = 0, n_scan_bwd: int = 0) -> dict:
    """A pass's exact launch counts: every flash launch of the bf16 paths on the tensor-core kernel,
    n_bwd launches of each flash backward kernel, n_wkv6 WKV-6 forward launches of which n_wkv6_train
    in the training form, n_wkv6_bwd of the WKV-6 backward, and the same three for the selective scan."""
    return {"flash_attention": n_flash, "flash_attention_wgmma": n_flash, "flash_attention_scalar": 0,
            "flash_attention_bwd_rowdot": n_bwd, "flash_attention_bwd_dkdv": n_bwd, "flash_attention_bwd_dq": n_bwd,
            "wkv6": n_wkv6, "wkv6_train": n_wkv6_train, "wkv6_bwd": n_wkv6_bwd, "mamba_scan": n_scan,
            "mamba_scan_train": n_scan_train, "mamba_scan_bwd": n_scan_bwd}


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


# the archs with an untied output head, served at full width and depth in the dense phase
DENSE_ARCHS = ("codeqwen1.5-7b", "stablelm-3b", "nemotron-4-15b", "olmoe-1b-7b")
DENSE_CHECK_PROMPT = 64  # tokens of the full-width 2-layer cut's card-vs-CPU prompt (nemotron's cut: 3.9 B parameters)


def dense_phases(torch, card):
    """Each arch of DENSE_ARCHS at full width and depth, bf16 compute, on the serving launcher's weights (each
    leaf drawn in f32 and stored as the engine casts it, no master copy): serve as phase 4 does, one 4096-token
    prompt, and card against CPU in f32 on a full-width 2-layer cut and on the smoke model."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.serve import draw_peak_bytes, weight_bytes
    from repro_torch.models import Model

    rng = np.random.default_rng(24)
    out = {}
    for arch in DENSE_ARCHS:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        per_pass = {"prefill": launch_counts(n_flash=cfg.n_layers), "decode": launch_counts()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0), compute_weights=True)
        torch.cuda.synchronize()
        held = sum(t.numel() * t.element_size() for t in leaves(params))
        draw_peak = torch.cuda.max_memory_allocated() - before
        n = model.count_params(params)
        dtypes = {}
        for t in leaves(params):
            dtypes[str(t.dtype)] = dtypes.get(str(t.dtype), 0) + t.numel()
        info = dict(model=arch, layers=cfg.n_layers, params=n, weight_bytes=held, params_by_dtype=dtypes,
                    draw_peak_bytes=draw_peak, launcher_draw_peak_bytes=draw_peak_bytes(cfg), card=card)
        log(f"dense {arch}", json.dumps(info))
        if held != weight_bytes(cfg) or "lm_head" not in params:
            raise AssertionError(f"dense {arch}: {held} bytes of weights held, the launcher counts {weight_bytes(cfg)}")
        if draw_peak > draw_peak_bytes(cfg):
            raise AssertionError(f"dense {arch}: the draw peaked at {draw_peak} bytes over what was held before, "
                                 f"more than the {draw_peak_bytes(cfg)} the launcher's memory check counts")
        prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 25))) for _ in range(8)]
        eng, stats = serve(torch, model, params, card, prompts=prompts, max_len=256, slots=4, max_new=16,
                           phase=f"dense {arch}", per_pass=per_pass)
        del params  # the engine holds the same tensors
        long_stats = serve(torch, model, eng.params, card, prompts=[rng.integers(0, cfg.vocab_size, size=4096)],
                           max_len=8192, slots=1, max_new=8, phase=f"dense-long {arch}", per_pass=per_pass)[1]
        del eng
        torch.cuda.empty_cache()

        # depth cut to 2 layers, every width full, f32: the CPU holds the cut too, so its prompt stays short
        cut = cfg.replace(n_layers=2, dtype="float32")
        cut_params = Model(cut, device="cuda").init(torch.Generator(device="cuda").manual_seed(2))
        compare_with_cpu(torch, cut, cut_params, rng.integers(0, cut.vocab_size, size=(1, DENSE_CHECK_PROMPT)),
                         [int(t) for t in rng.integers(0, cut.vocab_size, size=2)], f"dense-check {arch}")
        del cut_params
        torch.cuda.empty_cache()
        small = smoke_variant(cfg)
        small_params = Model(small, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
        compare_with_cpu(torch, small, small_params, rng.integers(0, small.vocab_size, size=(1, 20)),
                         [int(t) for t in rng.integers(0, small.vocab_size, size=20)], f"dense-check {arch}")
        del small_params
        torch.cuda.empty_cache()
        out[arch] = dict(info, serve=stats, long=long_stats, wall_s=time.perf_counter() - t_arch)
        log("time", f"dense {arch} done in {out[arch]['wall_s']:.1f} s")
    return out


def launcher_serve(torch, card, arch):
    """``python -m repro_torch.launch.serve --arch <arch>`` as a user runs it, through its ``main``: the memory
    check against the card's free memory, the kernels' build, the compute-dtype draw and 8 requests of 16 new
    tokens.  Its stats must report the meta init's parameters and weight bytes, a draw peak within what the
    check counts, and exactly n_layers tensor-core flash launches per prefill, none per decode step."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import count_params, init_lm

    cfg = get_config(arch)
    counters = kernel_counters()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)             # count only the launcher's run
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = launch_serve.main(["--arch", arch, "--requests", "8", "--max-new", "16"])
    launches = {k: getattr(*c) for k, c in counters.items()}
    torch.cuda.empty_cache()
    stats = json.loads(printed.getvalue())
    want = {k: n * stats["prefills"] for k, n in launch_counts(n_flash=cfg.n_layers).items()}
    stats.update(exit_code=rc, kernel_launches=launches, allocated_before_bytes=before, card=card)
    log(f"launcher {arch}", json.dumps(stats))
    if rc != 0 or stats["prefills"] != 8 or stats["params"] != count_params(init_lm(cfg, None, "meta")):
        raise AssertionError(f"launcher {arch}: exit {rc}, {stats['prefills']} prefills, {stats['params']} parameters")
    if stats["weight_bytes"] != launch_serve.weight_bytes(cfg):
        raise AssertionError(f"launcher {arch}: holds {stats['weight_bytes']} bytes of weights, its meta init counts "
                             f"{launch_serve.weight_bytes(cfg)}")
    if stats["draw_peak_bytes"] - before > launch_serve.draw_peak_bytes(cfg):
        raise AssertionError(f"launcher {arch}: the draw peaked at {stats['draw_peak_bytes'] - before} bytes, more "
                             f"than the {launch_serve.draw_peak_bytes(cfg)} its memory check counts")
    if launches != want:
        raise AssertionError(f"launcher {arch}: kernel launches {launches}, expected {want}")
    return stats


# ---------------------------------------------------------------------------
# phases 9-12: training, checkpoint and restart, card against CPU, and the backward's library yardstick
# ---------------------------------------------------------------------------

TRAIN = dict(steps=8, seq_len=2048, global_batch=4, microbatches=1, lr=1e-3, seed=0)
# phases 14-15: the depth each arch is cut to, every width kept, so that its f32 masters, gradients and two
# AdamW moments (16 bytes a parameter) fit one card: rwkv6-7b 2.89 B parameters, olmoe-1b-7b 2.72 B
TRAIN_CUTS = {"rwkv6-7b": 12, "olmoe-1b-7b": 6}
# phase 16: jamba-v0.1-52b cut to one unit of two of its pattern positions, every width kept: 1 (Mamba + MoE,
# 16 experts top-2 at d_ff 14336) and 4 (attention + dense), 3.41 B parameters, 54.6 GB of f32 state; position
# 0 (Mamba + dense, +0.28 B) would take the reckoned peak past 72 GB.  At full depth its state is 821 GB.
JAMBA_TRAIN_CUT = (1, 4)


class FullCollections:
    """Python's full (generation-2) garbage collections while active: when each began, in seconds from the
    start, and how many ms it took.  A training step that holds one is that much longer."""

    def __enter__(self):
        self.events, self.t0, self._start = [], time.perf_counter(), None
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def _callback(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.events.append(dict(at_s=self._start - self.t0, ms=1e3 * (time.perf_counter() - self._start)))


def train_phase(torch, card, arch="gemma2-2b", phase="train", keep_final=False, n_layers=None):
    """``arch`` at full width through the launcher's Trainer, at full depth or cut to ``n_layers``; exact
    launches per step.  With ``keep_final`` also returns the final parameters on the host (the ckpt phase's
    yardstick)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_trainer, cut_config

    counters = kernel_counters()
    marks = []

    def mark(step):  # the Trainer calls this before each step: the counters then, read after
        marks.append({k: getattr(*c) for k, c in counters.items()})

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    trainer = build_trainer(arch, device="cuda", fault_hook=mark, n_layers=n_layers, **TRAIN)
    cfg = trainer.model.cfg
    params = trainer.state["params"]
    dtypes = sorted({str(t.dtype) for t in leaves(params)})
    if (cfg != cut_config(get_config(arch), n_layers) or cfg.remat != "unit" or cfg.dtype != "bfloat16"
            or dtypes != ["torch.float32"]):
        raise AssertionError(f"{phase}: {cfg.n_layers} layers, remat {cfg.remat}, compute {cfg.dtype}, "
                             f"params {dtypes}")
    n_attn = cfg.n_units * sum(spec.mixer in ("attn", "attn_local") for spec in cfg.pattern)
    n_rwkv = cfg.n_units * sum(spec.mixer == "rwkv" for spec in cfg.pattern)
    n_mamba = cfg.n_units * sum(spec.mixer == "mamba" for spec in cfg.pattern)
    has_moe = any(spec.ffn == "moe" for spec in cfg.pattern)
    auxes = []
    if has_moe:
        train_loss = trainer.model.train_loss

        def recording(*args, **kw):  # each step's load-balance loss, read after the run
            loss, metrics = train_loss(*args, **kw)
            auxes.append(metrics["moe_aux"].detach())
            return loss, metrics

        trainer.model.train_loss = recording
    per_step = launch_counts(n_flash=2 * n_attn, n_bwd=n_attn,   # forward, recomputed forward, backward
                             n_wkv6=2 * n_rwkv, n_wkv6_train=2 * n_rwkv, n_wkv6_bwd=n_rwkv,
                             n_scan=2 * n_mamba, n_scan_train=2 * n_mamba, n_scan_bwd=n_mamba)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)             # count only this run of the main path
    with FullCollections() as full_gc:
        result = trainer.run(TRAIN["steps"])
    final = {k: getattr(*c) for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    ends = marks[1:] + [final]
    steps = [{k: end[k] - start[k] for k in final} for start, end in zip(marks, ends)]
    wrong = [(i, got) for i, got in enumerate(steps) if got != per_step]
    if len(steps) != TRAIN["steps"] or wrong:
        raise AssertionError(f"{phase}: kernel launches per step differ from {per_step}: {wrong[:3]}")
    log_rows = trainer.metrics_log
    losses = [m["loss"] for m in log_rows]
    norms = [m["grad_norm"] for m in log_rows]
    if not all(math.isfinite(x) for x in losses + norms) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses {losses}, grad norms {norms}: not all finite, or not falling")
    auxes = [float(a) for a in auxes]
    if has_moe and (len(auxes) != TRAIN["steps"] * TRAIN["microbatches"]
                    or not all(math.isfinite(a) and a > 0 for a in auxes)):
        raise AssertionError(f"{phase}: MoE load-balance losses {auxes}: not one finite positive value a step")
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    step_ms = [1e3 * m["seconds"] for m in log_rows]
    stats = dict(model=cfg.name, layers=cfg.n_layers, params=sum(t.numel() for t in leaves(params)),
                 pattern=[(spec.mixer, spec.ffn) for spec in cfg.pattern], cut=n_layers,
                 full_depth_layers=get_config(arch).n_layers,
                 remat=cfg.remat, batch=TRAIN["global_batch"], seq=TRAIN["seq_len"], steps=len(log_rows),
                 losses=losses, grad_norms=norms, moe_aux=auxes if has_moe else None, lrs=[m["lr"] for m in log_rows], step_ms=step_ms,
                 step_ms_after_first=sum(step_ms[1:]) / len(step_ms[1:]),
                 tok_per_s_after_first=tokens * len(step_ms[1:]) / (sum(step_ms[1:]) / 1e3),
                 wall_s=result["wall_s"], kernel_launches=final, launches_per_step=per_step,
                 max_memory_allocated_bytes=peak, full_gc=full_gc.events, phase_wall_s=time.perf_counter() - t_phase,
                 card=card)
    log(phase, json.dumps(stats))
    final_host = {path: t.detach().cpu() for path, t in convert.flatten(params).items()} if keep_final else None
    del trainer, params
    torch.cuda.empty_cache()
    return stats, final_host


# The ckpt phase keeps its checkpoints on disk, in a PosixBackend data center under the checkout's build/, not in
# the training launcher's in-memory one.  It runs gemma2-2b cut to 14 of its 26 layers, every width kept, against
# a clean run of the same cut: the card's machine ends a command that writes more than 45 GiB to its disk, even
# if the bytes are deleted again, and two saves of the full-depth state (2 x 24.75 GB, 46.1 GiB) pass that; two
# of the cut's (2 x 16.59 GB, 30.9 GiB) do not.  The numbers below were read at full depth.  This phase's own numbers on the card's machine (the NVIDIA H100 80GB HBM3
# host): MemTotal 108.4 GB, MemAvailable 93.2 GB when it starts, 80.2 GB free on the disk that holds the checkout
# (and tempfile.gettempdir()), and a peak resident set of 77.5 GB with the checkpoints on disk (the state on the
# host, a shard's bytes and their join, phase 9's parameters).  Held in RAM, the two checkpoints would add
# 2 x 24.75 GB to that peak, and the in-memory store a third copy of the shard being written: well past MemTotal.
CKPT = dict(ckpt_every=4, fail_at=6, n_shards=2, n_layers=14)
CKPT_DISK = 2.2       # free disk the phase asks for, in checkpoints of the state's size
CKPT_PEAK_REL = 0.01  # the card's peak may exceed the clean run's by this share


def host_memory() -> dict:
    """MemTotal and MemAvailable from /proc/meminfo, and this process's peak resident set, in bytes."""
    import resource

    with open("/proc/meminfo") as fh:
        info = {k: int(v.split()[0]) * 1024 for k, v in (line.split(":", 1) for line in fh)}
    return dict(mem_total=info["MemTotal"], mem_available=info["MemAvailable"],
                ru_maxrss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)


def ckpt_phase(torch, card, train_stats, train_final):
    """Phase 9's run cut to CKPT["n_layers"], checkpointed through SCISPACE every 4 steps, through an injected
    node failure before step 7: one restore of step 4 (found by an SDS search) and a replay of steps 5-8, held
    against ``train_stats`` / ``train_final``, a clean run of the same cut."""
    import shutil
    import tempfile

    from repro_torch import convert
    from repro_torch.core import Collaboration
    from repro_torch.launch.train import build_trainer
    from repro_torch.train import CheckpointManager, FaultInjector

    t_phase = time.perf_counter()
    host_before = host_memory()
    counters = kernel_counters()
    marks = []
    faults = FaultInjector(fail_at=[CKPT["fail_at"]])

    def hook(step):  # the failure first: a step that fails leaves no mark
        faults(step)
        marks.append({k: getattr(*c) for k, c in counters.items()})

    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt-", dir=ROOT / "build")
    collab = Collaboration()
    try:
        collab.add_datacenter("pod0", root=root, n_dtns=2)
        ckpt = CheckpointManager(collab, run="chip-smoke", home_dc="pod0", n_shards=CKPT["n_shards"])
        torch.cuda.empty_cache()
        trainer = build_trainer("gemma2-2b", device="cuda", fault_hook=hook, ckpt=ckpt,
                                ckpt_every=CKPT["ckpt_every"], n_layers=CKPT["n_layers"], **TRAIN)
        state_bytes = sum(t.numel() * t.element_size() for t in leaves(trainer.state))
        disk_free = shutil.disk_usage(root).free
        if disk_free < CKPT_DISK * state_bytes:
            raise AssertionError(f"ckpt: {disk_free} bytes free under {root}, the phase needs "
                                 f"{CKPT_DISK} x {state_bytes}")
        per_step = train_stats["launches_per_step"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)             # count only this run of the main path
        result = trainer.run(TRAIN["steps"])
        final = {k: getattr(*c) for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        found = ckpt.list_steps()
        ends = marks[1:] + [final]
        steps = [{k: end[k] - start[k] for k in final} for start, end in zip(marks, ends)]
        rows = [m for m in trainer.metrics_log if "loss" in m]
        events = [m for m in trainer.metrics_log if "event" in m]
        saves = [dict(step=m["step"], **m["ckpt"]) for m in rows if "ckpt" in m]
        restores = [dict(step=m["restored_step"], restore_s=m["restore_s"]) for m in events]  # read + copy to card
        want = train_stats["losses"]
        loss_rel = [abs(m["loss"] - want[m["step"] - 1]) / abs(want[m["step"] - 1]) for m in rows]
        leaf_rel, bitwise_params = {}, True
        with torch.no_grad():
            for path, live in convert.flatten(trainer.state["params"]).items():
                ref = train_final[path].to(live.device)
                leaf_rel[path] = ((live - ref).norm() / ref.norm().clamp_min(1e-30)).item()
                bitwise_params = bitwise_params and torch.equal(live, ref)
                del ref
        worst = max(leaf_rel, key=leaf_rel.get)
        stats = dict(
            model=trainer.model.cfg.name, steps_run=len(rows), restarts=result["restarts"], fired=faults.fired,
            events=events, ckpt_steps_discovered_via_sds=found, n_shards=CKPT["n_shards"], backend="posix",
            state_bytes=state_bytes, saves=saves, restores=restores,
            losses=[m["loss"] for m in rows],
            steps=[m["step"] for m in rows], step_ms=[1e3 * m["seconds"] for m in rows],
            max_loss_rel=max(loss_rel), loss_rtol=LOSS_RTOL,
            losses_bitwise_equal=all(r == 0.0 for r in loss_rel), worst_leaf=worst, worst_leaf_rel=leaf_rel[worst],
            params_bitwise_equal=bitwise_params, kernel_launches=final, launches_per_step=steps,
            max_memory_allocated_bytes=peak, train_max_memory_allocated_bytes=train_stats["max_memory_allocated_bytes"],
            disk_free_bytes=disk_free, host_before=host_before, card=card)
        del trainer
    finally:
        collab.close()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    stats.update(host_after=host_memory(), wall_s=time.perf_counter() - t_phase)
    log("ckpt", json.dumps(stats))
    if stats["restarts"] != 1 or faults.fired != [CKPT["fail_at"]] or len(events) != 1:
        raise AssertionError(f"ckpt: {stats['restarts']} restarts, failures {faults.fired}, events {events}")
    if found != [4, 8] or [s["step"] for s in saves] != [4, 8] or [r["step"] for r in restores] != [4]:
        raise AssertionError(f"ckpt: SDS finds steps {found}; saved {saves}, restored {restores}")
    if stats["steps"] != [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]:
        raise AssertionError(f"ckpt: ran steps {stats['steps']}, not 1-6 then 5-8 after the restore")
    wrong = [(i, got) for i, got in enumerate(steps) if got != per_step]
    if len(steps) != len(rows) or wrong:
        raise AssertionError(f"ckpt: kernel launches per step differ from the clean run's {per_step}: {wrong[:3]}")
    if not all(r <= LOSS_RTOL for r in loss_rel):
        raise AssertionError(f"ckpt: losses {stats['losses']} against the clean run's {want} (rtol {LOSS_RTOL})")
    if not all(math.isfinite(r) and r <= LOSS_RTOL for r in leaf_rel.values()):
        raise AssertionError(f"ckpt: parameter leaf {worst} differs from the clean run's by {leaf_rel[worst]:.3e}")
    if peak > (1 + CKPT_PEAK_REL) * train_stats["max_memory_allocated_bytes"]:
        raise AssertionError(f"ckpt: peak {peak} bytes against the clean run's "
                             f"{train_stats['max_memory_allocated_bytes']}")
    return stats


def train_check_cut(torch, card, cut, label):
    """The card's loss and gradients against the CPU's (plain attention and WKV-6), f32, on the same weights
    and batch: each MoE layer's top-k expert ids equal first, then the loss within rtol 1e-5 and every
    gradient leaf within ||card - cpu|| / ||cpu|| <= 1e-4."""
    from repro_torch import convert
    from repro_torch.data import ShardedPipeline, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.models import moe

    batch = ShardedPipeline(SyntheticLM(vocab_size=cut.vocab_size, seq_len=320, period=16, vocab_eff=256),
                            global_batch=1).batch_at(0)
    params_gpu = Model(cut, device="cuda").init(torch.Generator(device="cuda").manual_seed(3))
    out, routes, real_gating = {}, {}, moe._top_k_gating

    def recording(logits, top_k):  # the forward's expert ids on each device (a recomputation repeats them)
        gates, idx, probs = real_gating(logits, top_k)
        routes.setdefault(logits.device.type, []).append(idx.detach().cpu())
        return gates, idx, probs

    moe._top_k_gating = recording
    try:
        for device, params in (("cuda", params_gpu), ("cpu", tree_map(lambda t: t.detach().cpu(), params_gpu))):
            flat = convert.flatten(params)
            for leaf in flat.values():
                leaf.requires_grad_(True)
            loss, _ = Model(cut, device=device).train_loss(params, batch, loss_chunk=64)
            grads = torch.autograd.grad(loss, list(flat.values()))
            out[device] = (float(loss.detach()), {p: g.detach().cpu() for p, g in zip(flat, grads)})
            del params, flat, grads
    finally:
        moe._top_k_gating = real_gating
    del params_gpu
    if routes:  # the MoE layers' choices first: a different expert would make every later number differ
        n_cpu = cut.n_layers if cut.remat == "none" else 2 * cut.n_layers
        ids = {d: torch.stack(r[:len(routes["cpu"])]) for d, r in routes.items()}
        differ = int((ids["cuda"] != ids["cpu"]).any(-1).sum())
        log("train-check", json.dumps(dict(cut=label, moe_calls={d: len(r) for d, r in routes.items()},
                                           top_k=cut.moe.top_k, experts=cut.moe.n_experts,
                                           tokens_with_other_experts=differ, card=card)))
        if len(routes["cpu"]) != n_cpu or differ:
            raise AssertionError(f"train-check {cut.name}: top-{cut.moe.top_k} expert ids differ between card and "
                                 f"CPU at {differ} tokens ({len(routes['cpu'])} gating calls on the CPU)")
    (loss_g, grads_g), (loss_c, grads_c) = out["cuda"], out["cpu"]
    rel = {p: ((grads_g[p] - g).norm() / g.norm().clamp_min(1e-30)).item() for p, g in grads_c.items()}
    worst = max(rel, key=rel.get)
    log("train-check", json.dumps(dict(
        cut=f"{label}, B1 S320, loss chunk 64", loss_card=loss_g, loss_cpu=loss_c,
        worst_leaf=worst, worst_rel_err=rel[worst], leaves=len(rel), loss_rtol=LOSS_RTOL,
        grad_leaf_rel=GRAD_LEAF_REL, head_rel_err={p: rel[p] for p in ("embed/table", "lm_head/table") if p in rel},
        card=card)))
    if not abs(loss_g - loss_c) <= LOSS_RTOL * abs(loss_c):
        raise AssertionError(f"train-check {cut.name}: loss on the card {loss_g} against {loss_c} on the CPU")
    if not all(math.isfinite(r) and r <= GRAD_LEAF_REL for r in rel.values()):
        raise AssertionError(f"train-check {cut.name}: gradient leaf {worst} differs by {rel[worst]:.3e} (relative)")
    del out, grads_g, grads_c
    torch.cuda.empty_cache()


# phase 11: jamba-v0.1-52b's card-against-CPU cut, pattern positions 0 (Mamba + dense) and 4 (attention + dense),
# 0.77 B parameters: the selective scan's training form and backward and flash at G = 4, every width kept, in f32
# on the host too; olmoe's cut already holds the MoE's training to the CPU
JAMBA_CHECK_CUT = (0, 4)


def smoke_trainers_agree(torch, card, arch):
    """3 Trainer steps of ``arch``'s smoke model on the card and on the CPU, from the card trainer's weights (the
    two generators draw different numbers): losses within rtol 1e-4."""
    from repro_torch.launch.train import build_trainer

    trainers = {device: build_trainer(arch, smoke=True, steps=3, device=device) for device in ("cuda", "cpu")}
    with torch.no_grad():
        for a, b in zip(leaves(trainers["cpu"].state["params"]), leaves(trainers["cuda"].state["params"])):
            a.copy_(b.cpu())
    losses = {}
    for device, trainer in trainers.items():
        trainer.run(3)
        losses[device] = [m["loss"] for m in trainer.metrics_log]
    log("train-check", json.dumps(dict(model=f"{arch} smoke", smoke_losses_card=losses["cuda"],
                                       smoke_losses_cpu=losses["cpu"], rtol=1e-4, card=card)))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def train_check(torch, card):
    """Training, card against CPU: a full-width unit of gemma2-2b (a local and a global layer), a full-width
    layer each of codeqwen1.5-7b (an untied head), rwkv6-7b (the WKV-6 kernels) and olmoe-1b-7b (the MoE
    and its load-balance loss), jamba-v0.1-52b's cut JAMBA_CHECK_CUT (the selective scan's kernels), and 3
    Trainer steps of gemma2's and jamba's smoke models."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_config

    cut = get_config("gemma2-2b").replace(n_layers=2, dtype="float32")  # one unit: a local and a global layer
    train_check_cut(torch, card, cut, f"{cut.name} {cut.n_layers} layers f32")
    cut = get_config("codeqwen1.5-7b").replace(n_layers=1, dtype="float32")
    train_check_cut(torch, card, cut, f"{cut.name} {cut.n_layers} layer f32, untied head")
    cut = get_config("rwkv6-7b").replace(n_layers=1, dtype="float32")
    train_check_cut(torch, card, cut, f"{cut.name} {cut.n_layers} layer f32, WKV-6 forward and backward kernels")
    cut = get_config("olmoe-1b-7b").replace(n_layers=1, dtype="float32")
    train_check_cut(torch, card, cut, f"{cut.name} {cut.n_layers} layer f32, top-8 of 64 experts, untied head")
    cut = cut_config(get_config("jamba-v0.1-52b"), JAMBA_CHECK_CUT).replace(dtype="float32")
    train_check_cut(torch, card, cut, f"{cut.name} pattern positions {JAMBA_CHECK_CUT} "
                                      f"{[(spec.mixer, spec.ffn) for spec in cut.pattern]} f32, selective-scan kernels")
    for arch in ("gemma2-2b", "jamba-v0.1-52b"):
        smoke_trainers_agree(torch, card, arch)


# phase 17: the end-to-end example's twin on the card, as a user runs it: a few dozen steps of its ~100M model
# (f32, 12 layers, seq 128, batch 2), a save every 10 steps through SCISPACE (in-memory data centers pod0 and
# peer, 2 shards of 1.6 GB of state a save) and a node failure before step 26
E2E_ARGS = dict(steps=40, fail_at=25, ckpt_every=10)


def e2e_phase(torch, card):
    """``python -m repro_torch.launch.train_end_to_end`` through its ``main``: exit 0, one restart from step 20
    (the latest an SDS search finds), steps [10, 20, 30, 40] found at the end, a falling loss, and per step
    computed (25 before the failure, 20 after it) 12 f32 flash forward launches (the scalar kernel, remat none)
    and 12 of each backward kernel."""
    import contextlib
    import io

    from repro_torch.launch import train_end_to_end as e2e

    counters = kernel_counters()
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)             # count only this run of the main path
    printed = io.StringIO()
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in E2E_ARGS.items()]
    with contextlib.redirect_stdout(printed):
        rc = e2e.main(argv)
    launches = {k: getattr(*c) for k, c in counters.items()}
    head, _, body = printed.getvalue().partition("\n")
    result = json.loads(body)
    steps_run = E2E_ARGS["fail_at"] + E2E_ARGS["steps"] - (E2E_ARGS["fail_at"] // E2E_ARGS["ckpt_every"]
                                                          * E2E_ARGS["ckpt_every"])
    n_layers = e2e.build_100m_config().n_layers
    want = {k: v * steps_run for k, v in launch_counts(n_bwd=n_layers).items()}
    want.update(flash_attention=n_layers * steps_run, flash_attention_scalar=n_layers * steps_run)
    stats = dict(argv=argv, model_line=head, exit_code=rc, result=result, steps_computed=steps_run,
                 kernel_launches=launches, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 wall_s=time.perf_counter() - t0, card=card)
    log("e2e", json.dumps(stats))
    if rc != 0 or result["restarts"] != 1 or result["final_step"] != E2E_ARGS["steps"]:
        raise AssertionError(f"e2e: exit {rc}, {result['restarts']} restarts, final step {result['final_step']}")
    if result["ckpt_steps_discovered_via_sds"] != list(range(10, E2E_ARGS["steps"] + 1, E2E_ARGS["ckpt_every"])):
        raise AssertionError(f"e2e: SDS finds steps {result['ckpt_steps_discovered_via_sds']}")
    if not result["last_loss"] < result["first_loss"]:
        raise AssertionError(f"e2e: loss {result['first_loss']} -> {result['last_loss']}")
    if launches != want:
        raise AssertionError(f"e2e: kernel launches {launches}, expected {want}")
    return stats


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


def backward_entries(rows, train_stats, ckpt_stats, dense_train_stats, moe_train_stats, jamba_train_stats, card):
    """The kernels line's entries of the backward kernels, at gemma2's training shape, window 4096, at
    stablelm-3b's (hd 80), at olmoe-1b-7b's (H16 hd 128) and at jamba's (H32 Kv8 hd 128, G = 4)."""
    row = next(r for r in rows if r["label"] == "gemma2-train" and r["window"] == 4096)
    same = next(r for r in rows if r["label"] == "gemma2-train-causal")  # softcap 0: SDPA's own function
    hd80 = next(r for r in rows if r["label"] == "stablelm-train")
    olmoe = next(r for r in rows if r["label"] == "olmoe-train")
    jamba = next(r for r in rows if r["label"] == "jamba-train")
    max_err = max(row["max_abs_err"][g] for g in ("dq", "dk", "dv"))
    return [dict(
        name=f"flash_attention_bwd_{kname}", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:126",
        replaces_note="the gradient of that forward-only Pallas kernel: the reference differentiates its jnp "
                      "twin (src/repro/models/attention.py:80-163) with JAX",
        launches=train_stats["kernel_launches"][f"flash_attention_bwd_{kname}"],
        launches_ckpt=ckpt_stats["kernel_launches"][f"flash_attention_bwd_{kname}"], max_abs_err=max_err,
        ms=row["kernel_ms"][kname], plain_ms=row["plain_ms"], plain=row["plain"], bound_ms=row["bound_ms"][kname],
        bound_by=row["bound_by"][kname], library_ms=row["library_ms"], library=row["library"],
        backward_ms=row["backward_ms"], backward_bound_ms=row["bound_ms"]["backward"], tol=row["tol"],
        shape=row["case"], same_function_shape=same["case"], same_function_ms=same["kernel_ms"][kname],
        same_function_backward_ms=same["backward_ms"], same_function_library_ms=same["library_ms"],
        same_function_library=same["library"],
        launches_dense_train=dense_train_stats["kernel_launches"][f"flash_attention_bwd_{kname}"],
        hd80_shape=hd80["case"], hd80_ms=hd80["kernel_ms"][kname], hd80_backward_ms=hd80["backward_ms"],
        hd80_plain_ms=hd80["plain_ms"], hd80_bound_ms=hd80["bound_ms"][kname],
        hd80_backward_bound_ms=hd80["bound_ms"]["backward"], hd80_library_ms=hd80["library_ms"],
        hd80_max_abs_err={g: hd80["max_abs_err"][g] for g in ("dq", "dk", "dv")},
        launches_moe_train=moe_train_stats["kernel_launches"][f"flash_attention_bwd_{kname}"],
        olmoe_shape=olmoe["case"], olmoe_ms=olmoe["kernel_ms"][kname], olmoe_backward_ms=olmoe["backward_ms"],
        olmoe_plain_ms=olmoe["plain_ms"], olmoe_bound_ms=olmoe["bound_ms"][kname],
        olmoe_backward_bound_ms=olmoe["bound_ms"]["backward"], olmoe_library_ms=olmoe["library_ms"],
        olmoe_max_abs_err={g: olmoe["max_abs_err"][g] for g in ("dq", "dk", "dv")},
        launches_jamba_train=jamba_train_stats["kernel_launches"][f"flash_attention_bwd_{kname}"],
        jamba_shape=jamba["case"], jamba_ms=jamba["kernel_ms"][kname], jamba_backward_ms=jamba["backward_ms"],
        jamba_plain_ms=jamba["plain_ms"], jamba_bound_ms=jamba["bound_ms"][kname],
        jamba_backward_bound_ms=jamba["bound_ms"]["backward"], jamba_library_ms=jamba["library_ms"],
        jamba_max_abs_err={g: jamba["max_abs_err"][g] for g in ("dq", "dk", "dv")},
        card=card) for kname in ("rowdot", "dkdv", "dq")]


def wkv6_train_entries(rows, rwkv_train_stats, card):
    """The kernels line's entries of WKV-6's training form and its backward, at rwkv6's training shape."""
    row = next(r for r in rows if r["label"] == "rwkv6-train")
    common = dict(route="cuda", replaces="src/repro/kernels/rwkv6_scan.py:96", shape=row["case"], library_ms=None,
                  library="none", card=card)
    return [dict(
        name="wkv6_train_form", source="src/repro_torch/kernels/csrc/wkv6.cu",
        replaces_note="wkv6_pallas's function, and the state before every 16 tokens for the backward",
        launches=rwkv_train_stats["kernel_launches"]["wkv6_train"], max_abs_err=row["forward_max_abs_err"],
        max_abs_err_note="out and final state against wkv6_plain at the scan gate (and bitwise the serving form's)",
        ms=row["forward_train_ms"], serving_form_ms=row["forward_serve_ms"], plain_ms=row["plain_forward_ms"],
        bound_ms=row["bound_ms"]["forward_train"], bound_by=row["bound_by"]["forward_train"], **common,
    ), dict(
        name="wkv6_bwd", source="src/repro_torch/kernels/csrc/wkv6_bwd.cu",
        replaces_note="the gradient of that forward-only Pallas kernel: the reference differentiates its jnp twin "
                      "wkv_chunked (src/repro/models/rwkv6.py:77-149) with JAX",
        launches=rwkv_train_stats["kernel_launches"]["wkv6_bwd"], max_abs_err=max(row["max_abs_err"].values()),
        max_abs_err_by_grad=row["max_abs_err"], tol=row["tol"], ms=row["kernel_ms"], plain_ms=row["plain_ms"],
        plain=row["plain"], bound_ms=row["bound_ms"]["backward"], bound_by=row["bound_by"]["backward"], **common,
    )]


def mamba_train_entries(rows, jamba_train_stats, card):
    """The kernels line's entries of the selective scan's training form and its backward, at jamba's training shape."""
    row = next(r for r in rows if r["label"] == "jamba-train")
    common = dict(route="cuda", replaces="src/repro/kernels/mamba_scan.py:76", shape=row["case"], library_ms=None,
                  library="none", card=card)
    return [dict(
        name="mamba_scan_train_form", source="src/repro_torch/kernels/csrc/mamba_scan.cu",
        replaces_note="mamba_scan_pallas's function, and the state before every 16 tokens for the backward",
        launches=jamba_train_stats["kernel_launches"]["mamba_scan_train"], max_abs_err=row["forward_max_abs_err"],
        max_abs_err_note="y and final state against mamba_scan_plain at the scan gate (and bitwise the serving form's)",
        ms=row["forward_train_ms"], serving_form_ms=row["forward_serve_ms"], plain_ms=row["plain_forward_ms"],
        plain=row["plain_forward"], bound_ms=row["bound_ms"]["forward_train"],
        bound_by=row["bound_by"]["forward_train"], **common,
    ), dict(
        name="mamba_scan_bwd", source="src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
        replaces_note="the gradient of that forward-only Pallas kernel: the reference differentiates its jnp twin "
                      "ssm_chunked_scan (src/repro/models/mamba.py:82-145) with JAX",
        launches=jamba_train_stats["kernel_launches"]["mamba_scan_bwd"], max_abs_err=max(row["max_abs_err"].values()),
        max_abs_err_by_grad=row["max_abs_err"], max_err_over_rms=row["max_err_over_rms"], tol=row["tol"],
        ms=row["kernel_ms"], plain_ms=row["plain_ms"], plain=row["plain"], bound_ms=row["bound_ms"]["backward"],
        bound_by=row["bound_by"]["backward"], **common,
    )]


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
    wkv_bwd_rows = run_wkv6_bwd_cases(torch, card)
    wkv6_bwd_planted_checks(torch, card, planted)
    scan_rows = run_mamba_cases(torch, card)
    mamba_planted_checks(torch, card, planted)
    scan_bwd_rows = run_mamba_bwd_cases(torch, card)
    mamba_bwd_planted_checks(torch, card, planted)
    bwd_rows = run_backward_cases(torch, card)
    for shape in PLANTED_BWD_SHAPES:
        backward_planted_checks(torch, card, planted, shape)
    backward_planted_checks(torch, card, planted, PLANTED_BWD_GROUPED_HD80, names=("flash_bwd_first_head_only",))
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
    train_stats, _ = train_phase(torch, card)
    log("time", f"phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # 10. the same training checkpointed through SCISPACE, through a failure and a restore
    clean_stats, clean_final = train_phase(torch, card, phase="ckpt-clean", keep_final=True,
                                           n_layers=CKPT["n_layers"])
    ckpt_stats = ckpt_phase(torch, card, clean_stats, clean_final)
    del clean_final
    log("time", f"phase 10 done at {time.perf_counter() - t_start:.1f} s")

    # 11. training, card against CPU
    train_check(torch, card)
    log("time", f"phase 11 done at {time.perf_counter() - t_start:.1f} s")

    # 12. the four archs with an untied head, served at full width and depth
    t_phase = time.perf_counter()
    dense_stats = dense_phases(torch, card)
    launcher_stats = launcher_serve(torch, card, "nemotron-4-15b")
    log("time", f"phase 12 (dense) took {time.perf_counter() - t_phase:.1f} s, done at "
                f"{time.perf_counter() - t_start:.1f} s; {torch.cuda.memory_allocated()} bytes still allocated")

    # 13. stablelm-3b training at full width and depth
    t_phase = time.perf_counter()
    dense_train_stats, _ = train_phase(torch, card, arch="stablelm-3b", phase="dense-train")
    log("time", f"phase 13 (dense-train) took {time.perf_counter() - t_phase:.1f} s, done at "
                f"{time.perf_counter() - t_start:.1f} s")

    # 14-15. rwkv6-7b and olmoe-1b-7b training at full width, cut in depth
    t_phase = time.perf_counter()
    rwkv_train_stats, _ = train_phase(torch, card, arch="rwkv6-7b", phase="rwkv6-train",
                                      n_layers=TRAIN_CUTS["rwkv6-7b"])
    log("time", f"phase 14 (rwkv6-train) took {time.perf_counter() - t_phase:.1f} s, done at "
                f"{time.perf_counter() - t_start:.1f} s")
    t_phase = time.perf_counter()
    moe_train_stats, _ = train_phase(torch, card, arch="olmoe-1b-7b", phase="moe-train",
                                     n_layers=TRAIN_CUTS["olmoe-1b-7b"])
    log("time", f"phase 15 (moe-train) took {time.perf_counter() - t_phase:.1f} s, done at "
                f"{time.perf_counter() - t_start:.1f} s")

    # 16. jamba-v0.1-52b training at full width, cut to pattern positions 1 and 4
    t_phase = time.perf_counter()
    jamba_train_stats, _ = train_phase(torch, card, arch="jamba-v0.1-52b", phase="jamba-train",
                                       n_layers=JAMBA_TRAIN_CUT)
    log("time", f"phase 16 (jamba-train) took {time.perf_counter() - t_phase:.1f} s, done at "
                f"{time.perf_counter() - t_start:.1f} s")

    # 17. the end-to-end example's twin, through a node failure
    e2e_stats = e2e_phase(torch, card)
    log("time", f"phase 17 (e2e) took {e2e_stats['wall_s']:.1f} s, done at {time.perf_counter() - t_start:.1f} s")

    # 18. the backward's library yardstick, after every peak has been read
    library_backward(torch, card, bwd_rows)
    log("time", f"phase 18 done at {time.perf_counter() - t_start:.1f} s")

    main_row = next(r for r in rows if r["case"].startswith("gemma2-serve-long bfloat16")
                    and r["window"] == 4096)
    jamba_row = next(r for r in rows if r["case"].startswith("jamba-serve-long bfloat16"))
    wkv_row = next(r for r in wkv_rows if r["case"] == "rwkv6 bfloat16 B1 S4096 H64 C64 s0 zero")
    scan_row = next(r for r in scan_rows if r["case"] == "jamba float32 B1 S4096 di8192 ds16 h0 zero")
    dense_rows = {label: next(r for r in rows if r["case"].startswith(f"{label} bfloat16 B1 S4096 "))
                  for label, _, _ in DENSE_ATTENTION}
    dense_keys = ("case", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "library_ms", "library_causal_ms",
                  "tflops")
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
        launches_ckpt=ckpt_stats["kernel_launches"]["flash_attention"],
        launches_dense={arch: st["serve"]["kernel_launches"]["flash_attention_wgmma"]
                        for arch, st in dense_stats.items()},
        launches_dense_long={arch: st["long"]["kernel_launches"]["flash_attention_wgmma"]
                             for arch, st in dense_stats.items()},
        launches_dense_train=dense_train_stats["kernel_launches"]["flash_attention"],
        launches_moe_train=moe_train_stats["kernel_launches"]["flash_attention"],
        launches_launcher_nemotron=launcher_stats["kernel_launches"]["flash_attention_wgmma"],
        dense_long_shapes={label: {key: r[key] for key in dense_keys} for label, r in dense_rows.items()},
        card=card,
    ), *backward_entries(bwd_rows, train_stats, ckpt_stats, dense_train_stats, moe_train_stats, jamba_train_stats,
                         card), dict(
        name="wkv6", route="cuda", source="src/repro_torch/kernels/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:96", launches=rwkv_stats["kernel_launches"]["wkv6"],
        max_abs_err=wkv_row["max_abs_err"], ms=wkv_row["kernel_ms"], plain_ms=wkv_row["plain_ms"],
        bound_ms=wkv_row["bound_ms"], bound_by=wkv_row["bound_by"], library_ms=None,
        tol=wkv_row["tol"], shape=wkv_row["case"], library="none",
        launches_long_prompt=rwkv_long_stats["kernel_launches"]["wkv6"],
        launches_rwkv6_train=rwkv_train_stats["kernel_launches"]["wkv6"], card=card,
    ), *wkv6_train_entries(wkv_bwd_rows, rwkv_train_stats, card), dict(
        name="mamba_scan", route="cuda", source="src/repro_torch/kernels/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan.py:76", launches=jamba_stats["kernel_launches"]["mamba_scan"],
        max_abs_err=scan_row["max_abs_err"], ms=scan_row["kernel_ms"], plain_ms=scan_row["plain_ms"],
        bound_ms=scan_row["bound_ms"], bound_by=scan_row["bound_by"], library_ms=None,
        tol=scan_row["tol"], shape=scan_row["case"], library="none",
        launches_long_prompt=jamba_long_stats["kernel_launches"]["mamba_scan"],
        launches_jamba_train=jamba_train_stats["kernel_launches"]["mamba_scan"], card=card,
    ), *mamba_train_entries(scan_bwd_rows, jamba_train_stats, card)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

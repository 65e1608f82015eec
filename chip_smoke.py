#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build    — nvcc builds every kernel source under src/repro_torch/kernels/csrc,
              printing the build time and ptxas' register / shared-memory report;
3. kernels  — each kernel's wrapper against its plain PyTorch version on the card,
              at the smoke shape, the gemma2-2b geometry and the serve path's own
              shapes, with the stated tolerance; one JSON line per case with
              kernel, plain, library (one PyTorch call) and bound times;
   planted  — a copy of the kernel built to skip the last live KV tile of every
              block must fail the same gate at the long-prompt bf16 shape;
4. serve    — gemma2-2b at full width (26 layers, bf16 compute, f32 weights from a
              seeded torch.Generator) through ServeEngine: 8 prompts of 4-24 tokens,
              4 slots, 16 new tokens, greedy; the kernel's launch count must rise by
              exactly 26 per prefill;
5. long     — one 4608-token prompt (max_len 8192): the local layers' 4096 window
              binds inside the kernel and their ring cache is used;
6. check    — the card's logits against the CPU's (plain attention) on the same
              weights: the full-width model in f32 and the smoke model, at the
              reference's 2e-3.

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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
F32_TOL = dict(atol=2e-5, rtol=2e-5)     # the reference's kernel tolerance (tests/test_kernels.py)
BF16_REL = 2e-2                          # the reference's bf16 tolerance, taken relative to the output
LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)   # the reference's prefill/decode tolerance
HBM_BYTES_PER_S = 3.35e12                # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 outside them


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
    """(label, dtype, B, S, T, H, Kv, hd, window, cap, q_offset); all causal."""
    cases = [("smoke", "float32", 2, 64, 64, 4, 2, 16, 0, 0.0, 0),
             ("smoke", "bfloat16", 2, 64, 64, 4, 2, 16, 0, 0.0, 0)]
    for dtype in ("bfloat16", "float32"):
        for window in (4096, 0):
            for S in (23, 1024, 8192):
                cases.append(("gemma2", dtype, 1, S, S, 8, 4, 256, window, 50.0, 0))
        cases.append(("gemma2-q_offset", dtype, 1, 512, 1536, 8, 4, 256, 4096, 50.0, 1024))
    for window in (4096, 0):  # the long-prompt serve phase's own shapes
        cases.append(("gemma2-serve-long", "bfloat16", 1, 4608, 4608, 8, 4, 256, window, 50.0, 0))
    return cases


def attention_bound(torch, dtype, B, S, T, H, Kv, hd, window, q_offset):
    """Least time for the work this mask needs: max(bytes / HBM rate, FLOP / peak)."""
    q_pos = q_offset + torch.arange(S, dtype=torch.float64)
    lo = (q_pos - window + 1).clamp(min=0) if window else torch.zeros_like(q_pos)
    hi = q_pos.clamp(max=T - 1)
    pairs = float((hi - lo + 1).clamp(min=0).sum()) * B * H
    flops = 4.0 * hd * pairs                              # QK^T and PV, 2 FLOP per MAC
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (2 * B * S * H * hd + 2 * B * T * Kv * hd)  # q, out, k, v once each
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_inputs(torch, gen, dtype, B, S, T, H, Kv, hd):
    dt = getattr(torch, dtype)
    return tuple(torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dt)
                 for shape in ((B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd)))


def run_kernel_cases(torch, card):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, dtype, B, S, T, H, Kv, hd, window, cap, q_offset in attention_cases():
        q, k, v = attention_inputs(torch, gen, dtype, B, S, T, H, Kv, hd)
        kw = dict(causal=True, window=window, logit_softcap=cap, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        plain = flash_attention_plain(q, k, v, **kw)
        name = f"{label} {dtype} B{B} S{S} T{T} H{H} Kv{Kv} hd{hd} window{window} cap{cap} q_offset{q_offset}"
        tol = kernel_tol(dtype, plain)
        err = check_close(name, out, plain, tol)
        kernel_ms = cuda_ms(torch, lambda: flash_attention(q, k, v, **kw))
        plain_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, **kw), max_reps=5)
        # the library yardstick: SDPA with the same masks but softcap 0, since no
        # single PyTorch call computes softcapped attention
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        q_pos = q_offset + torch.arange(S, device="cuda")[:, None]
        k_pos = torch.arange(T, device="cuda")[None, :]
        mask = k_pos <= q_pos
        if window:
            mask &= k_pos > q_pos - window
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1.0 / math.sqrt(hd), enable_gqa=True), max_reps=5)
        bound_ms, bound_by = attention_bound(torch, dtype, B, S, T, H, Kv, hd, window, q_offset)
        row = dict(case=name, dtype=dtype, S=S, T=T, window=window, q_offset=q_offset,
                   max_abs_err=err, tol=tol, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library="sdpa, same mask, softcap 0",
                   bound_ms=bound_ms, bound_by=bound_by, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def planted_fault_check(torch, card):
    """A kernel that skips the last live KV tile of each block must fail the bf16 gate."""
    import ctypes

    import repro_torch.kernels.flash_attention as fa
    from repro_torch.kernels import _build

    loop = "for (int kt = kt_begin; kt < kt_end; ++kt)"
    src = (_build.CSRC / "flash_attention.cu").read_text()
    if src.count(loop) != 1:
        raise AssertionError(f"planted: the KV loop {loop!r} is not in the kernel source once")
    planted = _build.BUILD_DIR / "planted" / "flash_attention_skip_last_tile.cu"
    planted.parent.mkdir(parents=True, exist_ok=True)
    planted.write_text(src.replace(loop, "for (int kt = kt_begin; kt < kt_end - 1; ++kt)"))
    _build.compile_source(planted, planted.with_suffix(".so"))
    lib = fa._bind(ctypes.CDLL(str(planted.with_suffix(".so"))))

    B, S, H, Kv, hd = 1, 4608, 8, 4, 256
    kw = dict(causal=True, window=4096, logit_softcap=50.0, q_offset=0)
    q, k, v = attention_inputs(torch, torch.Generator(device="cuda").manual_seed(1),
                               "bfloat16", B, S, S, H, Kv, hd)
    plain = fa.flash_attention_plain(q, k, v, **kw)
    good_lib, fa._lib = fa._lib, lambda: lib
    try:
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
    finally:
        fa._lib = good_lib
    tol = kernel_tol("bfloat16", plain)
    err = (out.float() - plain.float()).abs().max().item()
    bad, bad_fixed = n_outside(out, plain, tol), n_outside(out, plain, dict(atol=2e-2, rtol=2e-2))
    log("planted", json.dumps(dict(
        fault="KV loop stops one tile early", case=f"bfloat16 B{B} S=T={S} H{H} Kv{Kv} hd{hd} window4096 cap50",
        max_abs_err=err, tol=tol, outside_tol=bad, outside_fixed_tol=bad_fixed, elements=out.numel(),
        card=card)))
    if not bad:
        raise AssertionError("planted: the bf16 gate passed a kernel that skips a live KV tile")


# ---------------------------------------------------------------------------
# phases 4-6: the serving path
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def serve(torch, model, params, card, *, prompts, max_len, slots, max_new, phase):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(model, params, ServeConfig(max_len=max_len, slots=slots, eos_token=-1, seed=0),
                      device="cuda")
    reqs = [eng.submit(p, max_new) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0          # count only this run of the main path
    stats = eng.run_until_drained(reqs)
    launches = flash_attention.launches
    vocab = model.cfg.vocab_size
    if not all(r.done for r in reqs):
        raise AssertionError(f"{phase}: requests left pending")
    if not all(len(r.out_tokens) == max_new and all(0 <= t < vocab for t in r.out_tokens) for r in reqs):
        raise AssertionError(f"{phase}: a request has the wrong token count or an out-of-range token")
    if launches != model.cfg.n_layers * stats["prefills"] or stats["prefills"] != len(prompts):
        raise AssertionError(f"{phase}: {launches} kernel launches for {stats['prefills']} prefills "
                             f"of a {model.cfg.n_layers}-layer model")
    stats.update(kernel_launches=launches, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 card=card)
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
    log(phase, f"{cfg.name} {cfg.dtype}: prompt {S}, {len(decode_tokens)} decode steps, "
               f"max |logit err| card vs CPU {max(errs):.3e} (tol {LOGIT_TOL})")


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
    from repro_torch.kernels import _build
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = smi_line()
    print(card, flush=True)
    log("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"{torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    builds = _build.build_all()
    log("build", f"{sorted(builds)} built in {time.perf_counter() - t0:.1f} s on {card} "
                 f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for res in builds.values():
        for line in res.log.splitlines():
            if any(key in line for key in ("Compiling entry", "registers", "spill")):
                log("build", f"{res.name}: {line.strip()}")

    # 3. kernel vs plain, and the gate against a planted fault
    rows = run_kernel_cases(torch, card)
    planted_fault_check(torch, card)

    # 4. serve at full width
    cfg = get_config("gemma2-2b")
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    log("serve", f"{cfg.name}: {model.count_params(params)} parameters, f32 master weights, "
                 f"{cfg.dtype} compute")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 25))) for _ in range(8)]
    eng, stats = serve(torch, model, params, card, prompts=prompts, max_len=256, slots=4,
                       max_new=16, phase="serve")

    # 5. a prompt longer than the local window
    long_prompt = [rng.integers(0, cfg.vocab_size, size=4608)]
    _, long_stats = serve(torch, model, eng.params, card, prompts=long_prompt, max_len=8192, slots=1,
                          max_new=8, phase="long")
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

    main_row = next(r for r in rows if r["case"].startswith("gemma2-serve-long bfloat16")
                    and r["window"] == 4096)
    kernels = [dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:126", launches=stats["kernel_launches"],
        max_abs_err=main_row["max_abs_err"], ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
        tol=main_row["tol"], shape=main_row["case"], library="sdpa, same mask, softcap 0",
        launches_long_prompt=long_stats["kernel_launches"], card=card,
    )]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

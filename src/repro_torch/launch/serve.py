"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Counterpart of ``src/repro/launch/serve.py``.  Builds the model from a seeded
``torch.Generator``, boots the continuous-batching engine and serves a
synthetic request stream (numpy-seeded prompts of 4–23 tokens), printing the
throughput stats as JSON.  Runs on the card unless ``--device cpu`` is given.
The weights are held in the compute dtype only: each leaf is drawn in f32
and stored as the engine casts it (``Model.init(..., compute_weights=True)``),
bitwise the weights of f32 masters cast at use, so nemotron-4-15b (15.6 B
parameters, 31.3 GB in bf16) serves at full width on one 80 GB card.  On the
card it first works out, from a ``meta`` init that draws nothing, the bytes
the draw will hold at its peak (the weights, plus the f32 draw of the largest
leaf), and refuses before building or drawing anything when they exceed the
card's free memory: jamba-v0.1-52b at full depth (51.3 B
parameters, 102.6 GB in bf16) does not fit one H100, and ``chip_smoke.py``
serves it cut in depth through ``Model`` and ``ServeEngine``.
``--profile DIR`` traces the serving run with ``torch.profiler`` and writes
``DIR/trace.json.gz`` (Chrome trace) and ``DIR/ops.txt`` (op tables by device
and by host time); the stats then
add the device's busy time (the sum of its kernels' durations) and idle share,
both inflated by the profiler's own host overhead.

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --smoke --device cpu \
        --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b     # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch nemotron-4-15b
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import flatten
from repro_torch.device import resolve_device
from repro_torch.kernels._build import build_all
from repro_torch.models import Model
from repro_torch.models.transformer import count_params, init_lm
from repro_torch.serve import ServeConfig, ServeEngine


def _meta_leaves(cfg):
    return flatten(init_lm(cfg, None, "meta", compute_weights=True)).values()


def weight_bytes(cfg) -> int:
    """Bytes of the served weights, from a ``meta`` init (nothing drawn): every weight that is
    cast at use in the compute dtype, the rest (norm scales, the MoE router, the scans' own
    leaves) in ``cfg.param_dtype``, as :func:`main` draws them."""
    return sum(t.numel() * t.element_size() for t in _meta_leaves(cfg))


def _block_bytes(nbytes: int) -> int:
    """The most the CUDA caching allocator counts for one tensor of ``nbytes``: the request rounded up
    to 512 bytes, and a remainder of up to 1 MiB that it may leave unsplit in the tensor's block."""
    return -(-nbytes // 512) * 512 + (1 << 20)


def draw_peak_bytes(cfg) -> int:
    """Most bytes the draw holds at once: the weights, plus the f32 draw of the largest leaf that is
    stored narrower (drawn in f32, cast, then freed; its cast copy is among the weights), each tensor
    counted as the caching allocator may count it."""
    leaves = list(_meta_leaves(cfg))
    transient = max((4 * t.numel() for t in leaves if t.element_size() < 4), default=0)
    return sum(_block_bytes(t.numel() * t.element_size()) for t in leaves) + _block_bytes(transient)


def check_fits(cfg, free_bytes: int) -> None:
    """Raise before anything is drawn when the draw needs more than ``free_bytes`` at its peak."""
    need = draw_peak_bytes(cfg)
    if need <= free_bytes:
        return
    n = count_params(init_lm(cfg, None, "meta"))
    raise RuntimeError(
        f"{cfg.name} ({cfg.n_layers} layers, {n} parameters) needs {need / 1e9:.1f} GB to draw its weights "
        f"({weight_bytes(cfg) / 1e9:.1f} GB held in {cfg.dtype}), more than the {free_bytes / 1e9:.1f} GB free "
        f"on the card; nothing was drawn. Serve a depth cut through Model and ServeEngine, as chip_smoke.py does."
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None, metavar="DIR", help="trace the run into DIR")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    device = resolve_device(args.device)
    build_s = 0.0
    if device.type == "cuda":  # refuse what cannot fit, then build the kernels before anything is timed
        check_fits(cfg, torch.cuda.mem_get_info(device)[0])
        t0 = time.perf_counter()
        build_all()
        build_s = time.perf_counter() - t0
    model = Model(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), compute_weights=True)
    held = {"params": model.count_params(params),
            "weight_bytes": sum(t.numel() * t.element_size() for t in flatten(params).values())}
    if device.type == "cuda":
        held["draw_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    eng = ServeEngine(
        model,
        params,
        ServeConfig(
            max_len=args.max_len, slots=args.slots,
            temperature=args.temperature, eos_token=-1, seed=args.seed,
        ),
        device=device,
    )
    del params  # the engine holds the same tensors
    rng = np.random.default_rng(args.seed)
    reqs = [
        eng.submit(rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 24))), args.max_new)
        for _ in range(args.requests)
    ]
    with _profiled(args.profile, device) as prof:
        stats = eng.run_until_drained(reqs)
    if prof is not None:
        stats.update(_write_profile(prof, Path(args.profile), stats["wall_s"], device))
    if not all(r.done for r in reqs):
        raise RuntimeError("engine stopped with requests still pending")
    stats.update(held, kernel_build_s=build_s)
    stats["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(stats, indent=1))
    return 0


@contextlib.contextmanager
def _profiled(out_dir, device):
    if out_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield prof


def _write_profile(prof, out_dir: Path, wall_s: float, device) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "trace.json.gz"))
    ops = prof.key_averages()
    sorts = (["self_device_time_total"] if device.type == "cuda" else []) + ["self_cpu_time_total"]
    (out_dir / "ops.txt").write_text("\n".join(f"sorted by {k}\n{ops.table(sort_by=k, row_limit=40)}" for k in sorts))
    if device.type != "cuda":
        return {"profile_dir": str(out_dir)}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    return {"profile_dir": str(out_dir), "device_kernels": float(len(kernels)),
            "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / max(wall_s, 1e-9)}


if __name__ == "__main__":
    sys.exit(main())

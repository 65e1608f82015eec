"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Counterpart of ``src/repro/launch/serve.py``.  Builds the model from a seeded
``torch.Generator``, boots the continuous-batching engine and serves a
synthetic request stream (numpy-seeded prompts of 4–23 tokens), printing the
throughput stats as JSON.  Runs on the card unless ``--device cpu`` is given.
On the card it first works out, from a ``meta`` init that draws nothing,
the bytes the weights will take, and refuses before building or drawing
anything when they exceed the card's free memory: jamba-v0.1-52b at full
depth (51.3 B parameters, 102.6 GB even in bf16) does not fit one H100, and
``chip_smoke.py`` serves it cut in depth through ``Model`` and ``ServeEngine``.
``--profile DIR`` traces the serving run with ``torch.profiler`` and writes
``DIR/trace.json.gz`` (Chrome trace) and ``DIR/ops.txt`` (op tables by device
and by host time); the stats then
add the device's busy time (the sum of its kernels' durations) and idle share,
both inflated by the profiler's own host overhead.

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --smoke --device cpu \
        --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b     # full width, on the card
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
from repro_torch.models.layers import cast_for_compute
from repro_torch.models.transformer import count_params, init_lm
from repro_torch.serve import ServeConfig, ServeEngine


def weight_bytes(cfg) -> int:
    """Bytes of the served weights at their peak, from a ``meta`` init (nothing drawn):
    the master weights in ``cfg.param_dtype`` plus the compute-dtype copy that the
    engine makes of every leaf it casts (none for a leaf already in that dtype)."""
    master = init_lm(cfg, None, "meta")
    cast = flatten(cast_for_compute(master, getattr(torch, cfg.dtype)))
    master = flatten(master)
    return sum(t.numel() * t.element_size() for p, t in master.items()) + sum(
        t.numel() * t.element_size() for p, t in cast.items() if t is not master[p])


def check_fits(cfg, free_bytes: int) -> None:
    """Raise before anything is drawn when the weights need more than ``free_bytes``."""
    need = weight_bytes(cfg)
    if need <= free_bytes:
        return
    n = count_params(init_lm(cfg, None, "meta"))
    lean = weight_bytes(cfg.replace(param_dtype=cfg.dtype))
    raise RuntimeError(
        f"{cfg.name} ({cfg.n_layers} layers, {n} parameters) needs {need / 1e9:.1f} GB of weights "
        f"({cfg.param_dtype} master weights and their {cfg.dtype} copy; {lean / 1e9:.1f} GB with "
        f"{cfg.dtype} master weights), more than the {free_bytes / 1e9:.1f} GB free on the card; "
        f"nothing was drawn. Serve a depth cut through Model and ServeEngine, as chip_smoke.py does."
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
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    eng = ServeEngine(
        model,
        params,
        ServeConfig(
            max_len=args.max_len, slots=args.slots,
            temperature=args.temperature, eos_token=-1, seed=args.seed,
        ),
        device=device,
    )
    del params  # the engine keeps the compute-dtype copy
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
    stats["kernel_build_s"] = build_s
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

"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Twin of ``src/repro/launch/train.py``: config → model → data pipeline → train
step → loop, on one card (``--device cuda``, the default) or the CPU
(``--device cpu``).  It prints the reference's JSON plus the peak device
memory.  ``--profile DIR`` traces the run with ``torch.profiler`` as the serve
launcher does (``DIR/trace.json.gz``, ``DIR/ops.txt``, and the device's busy
time and idle share in the JSON, inflated by the profiler's own host
overhead).  Examples:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 8 --seq-len 2048 \\
        --global-batch 4 --lr 1e-3

Not ported yet, and refused with a non-zero exit: checkpointing through
SCISPACE (``--ckpt-every`` > 0, ROADMAP.md queue 1, item 3e) and the
cross-pod modes other than ``auto`` (queue 1, item 6).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from ..configs import get_config, smoke_variant
from ..data import ShardedPipeline, SyntheticLM
from ..device import resolve_device
from ..kernels._build import build_all
from ..models import Model
from ..optim import AdamW, AdamWConfig
from ..train import Trainer, TrainerConfig
from .serve import _profiled, _write_profile

__all__ = ["build_trainer", "main"]


def build_trainer(arch: str, *, smoke: bool = False, steps: int = 50, seq_len: int = 128, global_batch: int = 8,
                  microbatches: int = 1, lr: float = 3e-3, seed: int = 0, device="cuda",
                  fault_hook: Optional[Callable[[int], None]] = None) -> Trainer:
    """The launcher's trainer: the reference's schedule (warmup steps // 10) and data
    (``SyntheticLM(period=16, vocab_eff=256)``), loss chunk min(seq_len, 256)."""
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    model = Model(cfg, device=resolve_device(device))
    opt = AdamW(AdamWConfig(peak_lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps))
    pipe = ShardedPipeline(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len, period=16, vocab_eff=256),
                           global_batch=global_batch)
    return Trainer(model, opt, pipe, TrainerConfig(microbatches=microbatches, loss_chunk=min(seq_len, 256)),
                   fault_hook=fault_hook, seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--cross-pod", default="auto", choices=["auto", "manual", "compressed"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--profile", default=None, metavar="DIR", help="trace the run into DIR")
    args = ap.parse_args(argv)
    if args.ckpt_every:
        print("repro_torch.launch.train: checkpointing through SCISPACE is not ported yet "
              "(ROADMAP.md queue 1, item 3e); run with --ckpt-every 0", file=sys.stderr)
        return 2
    if args.cross_pod != "auto":
        print(f"repro_torch.launch.train: --cross-pod {args.cross_pod} is not ported yet "
              f"(ROADMAP.md queue 1, item 6); run with --cross-pod auto", file=sys.stderr)
        return 2

    trainer = build_trainer(args.arch, smoke=args.smoke, steps=args.steps, seq_len=args.seq_len,
                            global_batch=args.global_batch, microbatches=args.microbatches, lr=args.lr,
                            seed=args.seed, device=args.device)
    on_card = trainer.model.device.type == "cuda"
    build_s = 0.0
    if on_card:  # build the kernels before anything is timed
        t0 = time.perf_counter()
        build_all()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
    with _profiled(args.profile, trainer.model.device) as prof:
        result = trainer.run(args.steps)
    if prof is not None:
        result.update(_write_profile(prof, Path(args.profile), result["wall_s"], trainer.model.device))
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    result["step_ms"] = [1e3 * m["seconds"] for m in trainer.metrics_log]
    result["kernel_build_s"] = build_s
    print(json.dumps({**result, "first_loss": losses[0], "last_loss": losses[-1],
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                      "device": torch.cuda.get_device_name(trainer.model.device) if on_card else "cpu"}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

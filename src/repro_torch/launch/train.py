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
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --smoke --device cpu --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b --smoke --device cpu

``--ckpt-every N`` saves every N steps through SCISPACE, as the reference
launcher does: one in-memory data center ``pod0`` of 2 DTNs, native writes
published by MEU, run name ``--run``; the JSON then also gives the steps an
SDS search finds (``ckpt_steps_discovered_via_sds``) and each save's accounting
(``ckpt_saves``: bytes, pack, write and publish seconds, MEU RPCs).  Not ported yet, and
refused with a non-zero exit: the cross-pod modes other than ``auto``
(ROADMAP.md queue 1, item 6).  On the card a model whose f32 master weights,
gradients and two AdamW moments (16 bytes a parameter) alone pass the card's
free memory is refused before anything is drawn: rwkv6-7b (7.27 B parameters,
116 GB) and olmoe-1b-7b (6.92 B, 111 GB) train on one card only cut in depth
(``build_trainer(..., n_layers=...)``, as ``chip_smoke.py`` does), or as
``--smoke``; jamba-v0.1-52b (51.6 B parameters, 821 GB) only as a cut of its
8-layer pattern (``n_layers=(1, 4)``: a Mamba + MoE and the attention layer),
or as ``--smoke``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import torch

from ..configs import get_config, smoke_variant
from ..core import Collaboration
from ..data import ShardedPipeline, SyntheticLM
from ..device import resolve_device
from ..kernels._build import build_all
from ..models import Model
from ..models.transformer import count_params, init_lm
from ..optim import AdamW, AdamWConfig
from ..train import CheckpointManager, Trainer, TrainerConfig
from .serve import _profiled, _write_profile

__all__ = ["build_trainer", "check_state_fits", "cut_config", "main"]

STATE_BYTES_PER_PARAM = 16  # the f32 master weight, its gradient and the two AdamW moments


def check_state_fits(cfg, free_bytes: int) -> None:
    """Raise before anything is drawn when the training state alone needs more than ``free_bytes``
    (activations come on top of it)."""
    n = count_params(init_lm(cfg, None, "meta"))
    need = STATE_BYTES_PER_PARAM * n
    if need > free_bytes:
        raise RuntimeError(
            f"{cfg.name} ({cfg.n_layers} layers, {n} parameters) needs {need / 1e9:.1f} GB for its f32 master "
            f"weights, gradients and AdamW moments alone, more than the {free_bytes / 1e9:.1f} GB free on the card; "
            f"nothing was drawn. Train a depth cut through build_trainer(n_layers=...), as chip_smoke.py does.")


def cut_config(cfg, n_layers: Union[int, Sequence[int], None]):
    """``cfg`` cut in depth: to ``n_layers`` layers, or to one unit of the pattern positions it lists."""
    if n_layers is None:
        return cfg
    if isinstance(n_layers, int):
        return cfg.replace(n_layers=n_layers)
    positions = tuple(n_layers)
    if not positions or any(not 0 <= i < len(cfg.pattern) for i in positions):
        raise ValueError(f"{cfg.name}: pattern positions {positions} outside its {len(cfg.pattern)}-layer pattern")
    return cfg.replace(n_layers=len(positions), pattern=tuple(cfg.pattern[i] for i in positions))


def build_trainer(arch: str, *, smoke: bool = False, steps: int = 50, seq_len: int = 128, global_batch: int = 8,
                  microbatches: int = 1, lr: float = 3e-3, seed: int = 0, device="cuda",
                  fault_hook: Optional[Callable[[int], None]] = None, ckpt: Optional[CheckpointManager] = None,
                  ckpt_every: int = 0, n_layers: Union[int, Sequence[int], None] = None) -> Trainer:
    """The launcher's trainer: the reference's schedule (warmup steps // 10) and data
    (``SyntheticLM(period=16, vocab_eff=256)``), loss chunk min(seq_len, 256); with ``ckpt``, a save
    every ``ckpt_every`` steps and a restore on a node failure.  ``n_layers`` cuts the depth, every
    width kept: an int keeps that many layers of the repeated pattern; a sequence of pattern
    positions keeps one unit of just those layers, in that order (jamba's ``(1, 4)``: its first
    Mamba + MoE layer and its attention layer)."""
    cfg = get_config(arch)
    cfg = cut_config(smoke_variant(cfg) if smoke else cfg, n_layers)
    model = Model(cfg, device=resolve_device(device))
    opt = AdamW(AdamWConfig(peak_lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps))
    pipe = ShardedPipeline(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len, period=16, vocab_eff=256),
                           global_batch=global_batch)
    return Trainer(model, opt, pipe, TrainerConfig(microbatches=microbatches, loss_chunk=min(seq_len, 256),
                                                   ckpt_every=ckpt_every),
                   ckpt=ckpt, fault_hook=fault_hook, seed=seed)


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
    ap.add_argument("--run", default="cli-run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--profile", default=None, metavar="DIR", help="trace the run into DIR")
    args = ap.parse_args(argv)
    if args.cross_pod != "auto":
        print(f"repro_torch.launch.train: --cross-pod {args.cross_pod} is not ported yet "
              f"(ROADMAP.md queue 1, item 6); run with --cross-pod auto", file=sys.stderr)
        return 2

    collab, ckpt = None, None
    if args.ckpt_every:
        collab = Collaboration()
        collab.add_datacenter("pod0", n_dtns=2)
        ckpt = CheckpointManager(collab, run=args.run, home_dc="pod0")
    try:
        device = resolve_device(args.device)
        if device.type == "cuda":
            cfg = get_config(args.arch)
            check_state_fits(smoke_variant(cfg) if args.smoke else cfg, torch.cuda.mem_get_info(device)[0])
        trainer = build_trainer(args.arch, smoke=args.smoke, steps=args.steps, seq_len=args.seq_len,
                                global_batch=args.global_batch, microbatches=args.microbatches, lr=args.lr,
                                seed=args.seed, device=args.device, ckpt=ckpt, ckpt_every=args.ckpt_every)
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
        rows = [m for m in trainer.metrics_log if "loss" in m]
        result["step_ms"] = [1e3 * m["seconds"] for m in rows]
        result["kernel_build_s"] = build_s
        if ckpt is not None:
            result["ckpt_steps_discovered_via_sds"] = ckpt.list_steps()
            result["ckpt_saves"] = [dict(step=m["step"], **m["ckpt"]) for m in rows if "ckpt" in m]
        print(json.dumps({**result, "first_loss": rows[0]["loss"], "last_loss": rows[-1]["loss"],
                          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                          "device": torch.cuda.get_device_name(trainer.model.device) if on_card else "cpu"},
                         indent=1))
    finally:
        if collab is not None:
            collab.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

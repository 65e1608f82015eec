"""The training loop — port of ``src/repro/train/trainer.py:46-180`` without a mesh or checkpoints.

The reference's loop restores the latest SCISPACE checkpoint when a step
fails, and re-raises when it has no checkpoint manager (``:156``).
Checkpointing through SCISPACE is not ported yet (ROADMAP.md queue 1, item
3e), so ``ckpt`` must be ``None`` and a failure, injected or real, ends the
run with its exception.  The data pipeline is stateless, so a later restart
replays exactly.  Elastic re-meshing (``reshard``) and the straggler
balancer wait for the multi-card slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.pipeline import ShardedPipeline
from ..optim.adamw import AdamW
from .step import build_train_step, init_state

__all__ = ["Trainer", "TrainerConfig", "FaultInjector"]


class FaultInjector:
    """Deterministic failure schedule for restart tests: fail at given steps."""

    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])
        self.fired: List[int] = []

    def __call__(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.append(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclass
class TrainerConfig:
    microbatches: int = 1
    loss_chunk: int = 256
    cross_pod: str = "auto"


class Trainer:
    def __init__(self, model, optimizer: AdamW, pipeline: ShardedPipeline, cfg: TrainerConfig = TrainerConfig(),
                 *, ckpt=None, fault_hook: Optional[Callable[[int], None]] = None, seed: int = 0):
        if ckpt is not None:
            raise NotImplementedError("checkpointing through SCISPACE is not ported yet (ROADMAP.md queue 1, item 3e)")
        self.model = model
        self.optimizer = optimizer
        self.pipeline = pipeline
        self.cfg = cfg
        self.fault_hook = fault_hook
        self.state = init_state(model, optimizer, torch.Generator(device=model.device).manual_seed(seed))
        self.step_fn = build_train_step(model, optimizer, microbatches=cfg.microbatches,
                                        loss_chunk=cfg.loss_chunk, cross_pod=cfg.cross_pod)
        self.metrics_log: List[Dict[str, float]] = []

    def _device_batch(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {name: torch.from_numpy(np.ascontiguousarray(x)).to(self.model.device) for name, x in batch_np.items()}

    def current_step(self) -> int:
        return int(self.state["step"])

    def run(self, n_steps: int) -> Dict[str, Any]:
        """Run to global step ``n_steps``; a failing step raises (there is no checkpoint to restore)."""
        t_loop = time.perf_counter()
        while self.current_step() < n_steps:
            step = self.current_step()
            if self.fault_hook is not None:
                self.fault_hook(step)
            batch = self._device_batch(self.pipeline.batch_at(step))
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            row = {"step": step + 1, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"])}
            row["seconds"] = time.perf_counter() - t0   # the float() reads above wait for the card
            self.metrics_log.append(row)
        return {
            "final_step": self.current_step(),
            "restarts": 0,
            "wall_s": time.perf_counter() - t_loop,
            "final_loss": next((m["loss"] for m in reversed(self.metrics_log) if "loss" in m), None),
        }

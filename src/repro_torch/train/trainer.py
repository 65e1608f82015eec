"""The training loop — port of ``src/repro/train/trainer.py:46-180`` without a mesh.

Checkpoint/restart through SCISPACE as the reference's: with a
:class:`~repro_torch.train.checkpoint.CheckpointManager` the loop saves after
every ``ckpt_every``-th step, and when a step fails with a
:class:`NodeFailure` it restores the latest step that an SDS search finds, or
starts again from the initial state when there is none, and replays.  The
data pipeline is stateless, so the replay is exact.

Where the port differs from the reference:

- Only :class:`NodeFailure` is treated as a node failure; the reference
  catches every ``RuntimeError`` (``:153``), which in torch would also turn a
  failed kernel launch, a CUDA error or an out-of-memory error into a silent
  restore-and-replay.  Those propagate.
- A restore copies the saved leaves into the live tensors in place, under
  ``torch.no_grad()``: the parameters stay the same autograd leaves and the
  moments the same tensors, and the card never holds a second copy of the
  state.  A restart with no checkpoint re-draws the parameters from a
  generator seeded with the trainer's ``seed`` (the reference re-initialises
  from ``PRNGKey(0)`` whatever its seed, ``:163``) and zeroes the rest; it
  holds one extra copy of the parameters while it copies them.

Elastic re-meshing (``reshard``) and the straggler balancer wait for the
multi-card slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.pipeline import ShardedPipeline
from ..optim.adamw import AdamW, tree_leaves
from .checkpoint import CheckpointManager
from .step import build_train_step, init_state

__all__ = ["Trainer", "TrainerConfig", "FaultInjector", "NodeFailure"]


class NodeFailure(RuntimeError):
    """A node failure: the one exception the Trainer answers with a restore."""


class FaultInjector:
    """Deterministic failure schedule for restart tests: fail at given steps."""

    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])
        self.fired: List[int] = []

    def __call__(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.append(step)
            raise NodeFailure(f"injected node failure at step {step}")


@dataclass
class TrainerConfig:
    microbatches: int = 1
    loss_chunk: int = 256
    cross_pod: str = "auto"
    ckpt_every: int = 0           # 0 ⇒ no checkpointing
    max_restarts: int = 3


class Trainer:
    def __init__(self, model, optimizer: AdamW, pipeline: ShardedPipeline, cfg: TrainerConfig = TrainerConfig(),
                 *, ckpt: Optional[CheckpointManager] = None, fault_hook: Optional[Callable[[int], None]] = None,
                 seed: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.pipeline = pipeline
        self.cfg = cfg
        self.ckpt = ckpt
        self.fault_hook = fault_hook
        self.seed = seed
        self.state = init_state(model, optimizer, self._generator())
        self.step_fn = build_train_step(model, optimizer, microbatches=cfg.microbatches,
                                        loss_chunk=cfg.loss_chunk, cross_pod=cfg.cross_pod)
        self.metrics_log: List[Dict[str, Any]] = []

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.model.device).manual_seed(self.seed)

    def _device_batch(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {name: torch.from_numpy(np.ascontiguousarray(x)).to(self.model.device) for name, x in batch_np.items()}

    def current_step(self) -> int:
        return int(self.state["step"])

    @torch.no_grad()
    def _restart(self) -> Optional[int]:
        """Restore the latest published checkpoint into the live state, or the initial state when there is none;
        returns the step restored (None for the initial state)."""
        latest = self.ckpt.latest_step()
        if latest is None:
            fresh = {"params": self.model.init(self._generator())}
            for live in tree_leaves({"opt_state": self.state["opt_state"], "step": self.state["step"]}):
                live.zero_()
        else:
            fresh = self.ckpt.restore(self.state, latest)
        for live, saved in zip(tree_leaves({k: self.state[k] for k in fresh}), tree_leaves(fresh)):
            live.copy_(saved)
        return latest

    def run(self, n_steps: int) -> Dict[str, Any]:
        """Run to global step ``n_steps``, restoring on a :class:`NodeFailure` when checkpoints are kept.

        A step that saves carries the save's accounting in its metrics row (``"ckpt"``); a restart's event row
        carries the step restored (``"restored_step"``) and the seconds of the read and the copy into the live
        state (``"restore_s"``)."""
        restarts = 0
        t_loop = time.perf_counter()
        while self.current_step() < n_steps:
            step = self.current_step()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self._device_batch(self.pipeline.batch_at(step))
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                row = {"step": step + 1, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"])}
                row["seconds"] = time.perf_counter() - t0   # the float() reads above wait for the card
                self.metrics_log.append(row)
                if self.ckpt is not None and self.cfg.ckpt_every and (step + 1) % self.cfg.ckpt_every == 0:
                    row["ckpt"] = self.ckpt.save(self.state, step + 1)
            except NodeFailure as exc:
                restarts += 1
                if restarts > self.cfg.max_restarts or self.ckpt is None:
                    raise
                t0 = time.perf_counter()
                restored = self._restart()
                step = self.current_step()   # a read of the state: waits for every copy queued before it
                self.metrics_log.append({"step": step, "event": f"restart({exc})", "restored_step": restored,
                                         "restore_s": time.perf_counter() - t0})
        return {
            "final_step": self.current_step(),
            "restarts": restarts,
            "wall_s": time.perf_counter() - t_loop,
            "final_loss": next((m["loss"] for m in reversed(self.metrics_log) if "loss" in m), None),
        }

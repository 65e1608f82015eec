"""AdamW, its cosine schedule and global-norm clipping — port of ``src/repro/optim/adamw.py:21-99``.

Functional, as the reference: the state is ``{"mu", "nu", "count"}`` with f32
moments shaped like the parameter tree, and :meth:`AdamW.update` takes the
gradients, the state and the parameters.  Unlike the reference's pure
functions, it updates the parameters, the moments and the count in place
under ``torch.no_grad()`` (and clipping scales the gradients in place), so a
step holds no second copy of any of them.  The order is the reference's:
clip, then the moments, then bias correction, then ``upd + wd·p``, then
``p - lr·upd`` with lr taken at ``count + 1``.  ``torch.optim.AdamW`` is not
used: its update order and its metrics differ.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = ["AdamWConfig", "AdamW", "cosine_schedule", "global_norm", "clip_by_global_norm", "tree_leaves",
           "tree_unflatten"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in the order JAX flattens a dict (sorted keys)."""
    out: List[torch.Tensor] = []
    for key in sorted(tree):
        leaf = tree[key]
        out.extend(tree_leaves(leaf) if isinstance(leaf, dict) else (leaf,))
    return out


def tree_unflatten(like, leaves: List[torch.Tensor]):
    """A nested dict shaped like ``like`` holding ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        return {key: build(node[key]) if isinstance(node[key], dict) else next(it) for key in sorted(node)}

    return build(like)


def cosine_schedule(peak_lr: float, *, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``peak_lr``, then cosine decay to ``final_frac·peak_lr``; f32 in, f32 out."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return schedule


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32."""
    return torch.sqrt(torch.stack([x.float().square().sum() for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scales every leaf in place by min(1, max_norm / norm); returns (tree, norm before clipping)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for x in tree_leaves(tree):
        x.copy_(x.float() * scale)
    return tree, norm


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamW:
    """init(params) → state;  update(grads, state, params) → (params, state, stats), in place."""

    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg
        self.schedule = cosine_schedule(cfg.peak_lr, warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps)

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda tree: {k: zeros(v) if isinstance(v, dict) else torch.zeros(v.shape, dtype=torch.float32,
                                                                                     device=v.device)
                              for k, v in tree.items()}
        device = tree_leaves(params)[0].device
        return {"mu": zeros(params), "nu": zeros(params), "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
        cfg = self.cfg
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        state["count"] += 1
        cf = state["count"].to(torch.float32)
        lr = self.schedule(state["count"])
        b1c = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=cf.device) ** cf
        b2c = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=cf.device) ** cf
        for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                                tree_leaves(params)):
            g = g.float()
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
            upd = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
            upd += cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
        return params, state, {"grad_norm": gnorm, "lr": lr}

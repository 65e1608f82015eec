"""Train-step builder — port of ``src/repro/train/step.py:44-165`` in ``auto`` mode.

The reference jits one step over a device mesh; ``auto`` is its baseline, in
which the compiler places the gradient reduction.  One card needs no
reduction, so here the step is eager PyTorch.  ``manual`` and ``compressed``
(the hierarchical and int8 cross-pod hops) raise: they wait for
``torch.distributed`` (ROADMAP.md queue 1, item 6).

State: ``{"params", "opt_state": {"mu", "nu", "count"}, "step"}``; the
parameters are the autograd leaves (f32 masters), updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..optim.adamw import AdamW, tree_leaves, tree_unflatten

__all__ = ["TrainState", "init_state", "build_train_step"]

TrainState = Dict[str, Any]


def init_state(model, optimizer: AdamW, generator: torch.Generator) -> TrainState:
    params = model.init(generator)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def _microbatched_grads(model, params, batch, microbatches: int, loss_chunk: int):
    """Mean loss and grads over ``microbatches`` sequential row slices of the batch.

    Each slice's grads are added in f32; the sum is then scaled by
    1/microbatches, as the reference's scan accumulates and averages.
    """
    leaves = tree_leaves(params)
    if microbatches == 1:
        loss, metrics = model.train_loss(params, batch, loss_chunk=loss_chunk)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params, list(grads))
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"batch of {rows} rows does not split into {microbatches} microbatches")
    n = rows // microbatches
    acc, loss_sum = None, None
    for i in range(microbatches):
        one = {name: x[i * n:(i + 1) * n] for name, x in batch.items()}
        loss, _ = model.train_loss(params, one, loss_chunk=loss_chunk)
        grads = torch.autograd.grad(loss, leaves)
        if acc is None:
            acc, loss_sum = [g.float() for g in grads], loss.detach()
        else:
            for a, g in zip(acc, grads):
                a.add_(g.float())
            loss_sum = loss_sum + loss.detach()
        del grads
    inv = 1.0 / microbatches
    for a in acc:
        a.mul_(inv)
    loss = loss_sum * inv
    return loss, {"loss": loss}, tree_unflatten(params, acc)


def build_train_step(model, optimizer: AdamW, *, microbatches: int = 1, loss_chunk: int = 256,
                     cross_pod: str = "auto"):
    """Returns ``step(state, batch) -> (state, metrics)``; metrics hold loss, grad_norm and lr tensors."""
    if cross_pod not in ("auto", "manual", "compressed"):
        raise ValueError(f"unknown cross_pod mode {cross_pod!r}")
    if cross_pod != "auto":
        raise NotImplementedError(f"cross_pod={cross_pod!r} needs the pod hop on torch.distributed, "
                                  f"not ported yet (ROADMAP.md queue 1, item 6)")

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, _, grads = _microbatched_grads(model, state["params"], batch, microbatches, loss_chunk)
        params, opt_state, stats = optimizer.update(grads, state["opt_state"], state["params"])
        del grads
        return {"params": params, "opt_state": opt_state, "step": state["step"] + 1}, {"loss": loss, **stats}

    return step

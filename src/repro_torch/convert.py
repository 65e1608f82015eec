"""Move a JAX parameter tree into the port: ``params_from_jax``.

The reference's parameters are a pytree of nested dicts whose leaves are named
by their path (``units/pos0/mixer/wq/w``, the join of
``repro.distributed.sharding.path_of``).  The port keeps the same tree, so a
model trained or initialised in JAX can be served here.  The caller hands the
tree over as numpy arrays (``jax.tree.map(np.asarray, params)``); this module
imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import numpy as np
import torch

from .models.transformer import init_lm

__all__ = ["path_of", "flatten", "unflatten", "params_from_jax"]


def path_of(keys: Iterable[Any]) -> str:
    """Key path → ``'units/pos0/mixer/wq/w'`` (the reference's ``path_of`` join)."""
    return "/".join(str(k) for k in keys)


def flatten(tree: Dict[str, Any], prefix=()) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(flatten(leaf, prefix + (key,)))
        else:
            out[path_of(prefix + (key,))] = leaf
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _to_tensor(x) -> torch.Tensor:
    arr = np.array(x, copy=True)  # arrays of a JAX tree are read-only
    if arr.dtype.name == "bfloat16":  # numpy's bfloat16 extension type; torch reads it via f32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree: Dict[str, Any], cfg, device) -> Dict[str, Any]:
    """A JAX parameter tree (numpy leaves) → the port's parameter tree on ``device``.

    Paths and shapes are checked against the port's own ``init_lm`` layout.
    """
    expected = {p: tuple(t.shape) for p, t in flatten(init_lm(cfg, None, "meta")).items()}
    got = flatten(tree)
    missing, extra = sorted(set(expected) - set(got)), sorted(set(got) - set(expected))
    if missing or extra:
        raise KeyError(f"parameter paths differ from {cfg.name}: missing {missing}, unexpected {extra}")
    out = {}
    for path, leaf in got.items():
        t = _to_tensor(leaf)
        if tuple(t.shape) != expected[path]:
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected {expected[path]}")
        out[path] = t.to(device)
    return unflatten(out)

"""Config registry — counterpart of ``src/repro/configs/__init__.py``.

Holds the architectures this port runs so far: gemma2-2b and rwkv6-7b.  Other
architectures join the registry with the slices that port their mixers.
"""

from __future__ import annotations

from typing import Dict

from .base import LayerSpec, ModelConfig, RWKVSpec, smoke_variant
from .gemma2_2b import CONFIG as _gemma2
from .rwkv6_7b import CONFIG as _rwkv6

__all__ = ["ARCHS", "get_config", "smoke_variant", "ModelConfig", "LayerSpec", "RWKVSpec"]

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (_gemma2, _rwkv6)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]

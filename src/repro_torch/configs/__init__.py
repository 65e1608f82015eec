"""Config registry — counterpart of ``src/repro/configs/__init__.py``.

Holds the architectures this port runs so far: gemma2-2b, rwkv6-7b and
jamba-v0.1-52b.  Other
architectures join the registry with the slices that port their mixers.
"""

from __future__ import annotations

from typing import Dict

from .base import SHAPES, LayerSpec, MambaSpec, ModelConfig, MoESpec, RWKVSpec, ShapeConfig, smoke_variant
from .gemma2_2b import CONFIG as _gemma2
from .jamba_v0_1_52b import CONFIG as _jamba
from .rwkv6_7b import CONFIG as _rwkv6

__all__ = ["ARCHS", "SHAPES", "get_config", "smoke_variant", "ModelConfig", "LayerSpec", "MoESpec", "MambaSpec",
           "RWKVSpec", "ShapeConfig"]

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (_gemma2, _rwkv6, _jamba)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]

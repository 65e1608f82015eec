"""Config registry — counterpart of ``src/repro/configs/__init__.py``.

Holds the architectures this port runs so far: gemma2-2b, rwkv6-7b,
jamba-v0.1-52b, and the four with an untied output head: codeqwen1.5-7b,
stablelm-3b, nemotron-4-15b and olmoe-1b-7b.  The other architectures
(llama4's shared expert, seamless-m4t's encoder-decoder, internvl2's vision
splice) join the registry with the slices that port what they need.
"""

from __future__ import annotations

from typing import Dict

from .base import SHAPES, LayerSpec, MambaSpec, ModelConfig, MoESpec, RWKVSpec, ShapeConfig, smoke_variant
from .codeqwen1_5_7b import CONFIG as _codeqwen
from .gemma2_2b import CONFIG as _gemma2
from .jamba_v0_1_52b import CONFIG as _jamba
from .nemotron_4_15b import CONFIG as _nemotron
from .olmoe_1b_7b import CONFIG as _olmoe
from .rwkv6_7b import CONFIG as _rwkv6
from .stablelm_3b import CONFIG as _stablelm

__all__ = ["ARCHS", "SHAPES", "get_config", "smoke_variant", "ModelConfig", "LayerSpec", "MoESpec", "MambaSpec",
           "RWKVSpec", "ShapeConfig"]

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (_gemma2, _rwkv6, _jamba, _codeqwen, _stablelm, _nemotron,
                                                    _olmoe)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]

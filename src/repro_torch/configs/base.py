"""Model configuration: the fields of ``repro.configs.base`` the serving path reads.

Counterpart of ``src/repro/configs/base.py`` (:class:`LayerSpec`,
:class:`ModelConfig`, :func:`smoke_variant`).  A model is ``n_units`` repeats
of a ``pattern`` of :class:`LayerSpec`; parameters and caches are stacked per
pattern position with a leading ``n_units`` dimension, as in the reference.
Fields that only the reference's other families or sharding read are left
out; they arrive with the slices that port those paths.  The training fields
(``remat``, ``remat_loss_chunk``, ``gather_ce``) and :class:`ShapeConfig` /
:data:`SHAPES` serve the gemma2-2b training slice.  The rwkv
fields (:class:`RWKVSpec`, ``ssm_chunk``, ``sub_quadratic``) serve rwkv6-7b;
the mamba and moe fields (:class:`MambaSpec`, :class:`MoESpec`,
``moe_block``) serve jamba-v0.1-52b.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["MoESpec", "MambaSpec", "RWKVSpec", "LayerSpec", "ModelConfig", "ShapeConfig", "SHAPES",
           "smoke_variant"]


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden width
    shared_expert: bool = False   # Llama4-style always-on expert
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    capacity_factor: float = 1.25  # per-expert slots = ceil(S·K·cf/E)


@dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 ⇒ ceil(d_model/16)


@dataclass(frozen=True)
class RWKVSpec:
    head_dim: int = 64


@dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating pattern unit."""

    mixer: str  # 'attn' | 'attn_local' | 'mamba' | 'rwkv'
    ffn: str    # 'dense' | 'moe' | 'rwkv_cmix'

    def __post_init__(self):
        if self.mixer not in ("attn", "attn_local", "mamba", "rwkv"):
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in ("dense", "moe", "rwkv_cmix"):
            raise ValueError(f"unknown ffn {self.ffn!r}")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|hybrid|ssm|encdec|vlm|audio
    d_model: int
    n_layers: int
    pattern: Tuple[LayerSpec, ...]
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0              # 0 ⇒ d_model // n_heads
    d_ff: int = 0
    activation: str = "swiglu"     # swiglu|gelu|relu2
    norm: str = "rmsnorm"          # rmsnorm|layernorm
    use_rope: bool = True
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # partial rotary
    qkv_bias: bool = False
    qk_norm: bool = False          # q/k RMSNorm
    attn_window: int = 0           # sliding window for 'attn_local' mixers
    attn_softcap: float = 0.0      # Gemma2 attention-logit softcap
    final_softcap: float = 0.0     # Gemma2 final-logit softcap
    post_block_norm: bool = False  # Gemma2 sandwich norms
    tie_embeddings: bool = True
    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
    rwkv: Optional[RWKVSpec] = None
    dtype: str = "bfloat16"        # compute dtype
    param_dtype: str = "float32"   # master-weight dtype
    attn_chunk_q: int = 512        # query / key chunks of the plain attention
    attn_chunk_kv: int = 1024
    ssm_chunk: int = 256           # chunk of the plain WKV and selective scans
    moe_block: int = 0             # MoE dispatch block (0 ⇒ whole sequence)
    remat: str = "unit"            # 'none'|'unit'|'dots'
    remat_loss_chunk: bool = False # recompute logits chunks in backward
    gather_ce: bool = False        # legacy take_along_axis CE (baseline only)
    # capability flags
    sub_quadratic: bool = False    # eligible for long_500k

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern len {len(self.pattern)}"
            )
        if any(s.mixer in ("attn", "attn_local") for s in self.pattern):
            if not (self.n_heads > 0 and self.n_kv_heads > 0):
                raise ValueError(f"{self.name}: attention needs n_heads and n_kv_heads")
        if any(s.ffn == "moe" for s in self.pattern) and self.moe is None:
            raise ValueError(f"{self.name}: moe layers need a MoESpec")
        if any(s.mixer == "mamba" for s in self.pattern) and self.mamba is None:
            raise ValueError(f"{self.name}: mamba mixers need a MambaSpec")
        if any(s.mixer == "rwkv" for s in self.pattern) and self.rwkv is None:
            raise ValueError(f"{self.name}: rwkv mixers need an RWKVSpec")
        if self.remat not in ("none", "unit", "dots"):
            raise ValueError(f"{self.name}: unknown remat {self.remat!r}")

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int

    def __post_init__(self):
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown shape kind {self.kind!r}")


#: The assigned LM-transformer shape set (same four cells for every arch).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """A reduced same-family config for CPU tests (the reference's own reduction).

    Keeps the pattern but shrinks width, depth (one unit), vocab, window and
    expert count.
    """
    kw: Dict = dict(
        d_model=64,
        n_layers=len(cfg.pattern),
        d_ff=128,
        vocab_size=512,
        dtype="float32",
        param_dtype="float32",
        attn_chunk_q=32,
        attn_chunk_kv=32,
        ssm_chunk=16,
        remat="none",
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1))
        kw["head_dim"] = 16
    if cfg.moe is not None:
        kw["moe"] = MoESpec(
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff=64,
            shared_expert=cfg.moe.shared_expert,
        )
    if cfg.mamba is not None:
        kw["mamba"] = MambaSpec(d_state=8, d_conv=4, expand=2)
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVSpec(head_dim=16)
    if cfg.attn_window:
        kw["attn_window"] = 16
    return cfg.replace(name=cfg.name + "-smoke", **kw)

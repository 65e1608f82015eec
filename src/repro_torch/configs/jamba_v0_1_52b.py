"""jamba-v0.1-52b, hybrid Mamba + attention with MoE [arXiv:2403.19887] — counterpart of ``src/repro/configs/jamba_v0_1_52b.py``.

32 layers in four 8-layer units, d_model 4096, 32 heads (GQA kv=8) of 128,
d_ff 14336, vocab 65536.  Each unit has exactly one attention layer (index 4)
and seven Mamba-1 layers (d_state 16, d_conv 4, expand 2); MoE (16 experts,
top-2) replaces the MLP on the odd layers.  No RoPE: the Mamba layers carry
position.  Decode holds a KV cache for the attention layers and O(1) state
for the Mamba ones.
"""

from .base import LayerSpec, MambaSpec, ModelConfig, MoESpec

_UNIT = tuple(
    LayerSpec(
        mixer="attn" if i == 4 else "mamba",
        ffn="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_layers=32,
    pattern=_UNIT,
    vocab_size=65536,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    activation="swiglu",
    norm="rmsnorm",
    use_rope=False,
    moe=MoESpec(n_experts=16, top_k=2, d_ff=14336),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
    sub_quadratic=True,
)

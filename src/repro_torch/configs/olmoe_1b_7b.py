"""olmoe-1b-7b, fine-grained MoE, 64 experts top-8 [arXiv:2409.02060] — counterpart of
``src/repro/configs/olmoe_1b_7b.py``.

16 layers, d_model 2048, 16 heads (GQA kv=16, i.e. MHA) of head_dim 128,
vocab 50304, a MoE of 64 SwiGLU experts of d_ff 1024 with top-8 routing in
every layer and no shared expert; q/k RMSNorm per head, RMSNorm, an untied
output head.
"""

from .base import LayerSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    d_model=2048,
    n_layers=16,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    vocab_size=50304,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    activation="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    moe=MoESpec(n_experts=64, top_k=8, d_ff=1024),
    tie_embeddings=False,
)

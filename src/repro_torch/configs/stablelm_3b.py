"""stablelm-3b, dense with partial rotary embeddings [hf:stabilityai/stablelm-2-1_6b] — counterpart of
``src/repro/configs/stablelm_3b.py``.

32 layers, d_model 2560, 32 heads (GQA kv=32, i.e. MHA) of head_dim 80, d_ff
6912, vocab 50304: RoPE on 25 % of each head, LayerNorm, SwiGLU, QKV biases,
an untied output head.
"""

from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    d_model=2560,
    n_layers=32,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    vocab_size=50304,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    activation="swiglu",
    norm="layernorm",
    rope_fraction=0.25,
    qkv_bias=True,
    tie_embeddings=False,
)

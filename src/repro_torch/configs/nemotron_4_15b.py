"""nemotron-4-15b, dense GQA with a squared-ReLU MLP [arXiv:2402.16819] — counterpart of
``src/repro/configs/nemotron_4_15b.py``.

32 layers, d_model 6144, 48 heads (GQA kv=8, so 6 query heads per KV head)
of head_dim 128, d_ff 24576, vocab 256000: squared ReLU, RoPE, no biases,
LayerNorm, an untied output head.
"""

from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    d_model=6144,
    n_layers=32,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    vocab_size=256000,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    activation="relu2",
    norm="layernorm",
    tie_embeddings=False,
)

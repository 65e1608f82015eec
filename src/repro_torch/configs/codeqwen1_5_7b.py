"""codeqwen1.5-7b, dense Qwen1.5-architecture code model [hf:Qwen/CodeQwen1.5-7B] — counterpart of
``src/repro/configs/codeqwen1_5_7b.py``.

32 layers, d_model 4096, 32 heads (GQA kv=32, i.e. MHA) of head_dim 128, d_ff
13440, vocab 92416: QKV biases, SwiGLU, RMSNorm, RoPE base 1e6, an untied
output head.
"""

from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    d_model=4096,
    n_layers=32,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    vocab_size=92416,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=False,
)

"""rwkv6-7b, attention-free RWKV-6 "Finch" [arXiv:2404.05892] — counterpart of ``src/repro/configs/rwkv6_7b.py``.

32 layers, d_model 4096, 64 heads of head_dim 64, d_ff 14336, vocab 65536:
a data-dependent-decay time-mix (the WKV recurrence over a C×C state per
head) and a squared-ReLU channel-mix in every layer, LayerNorm, no RoPE,
tied embeddings.  Decode carries O(1) state per layer.
"""

from .base import LayerSpec, ModelConfig, RWKVSpec

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    d_model=4096,
    n_layers=32,
    pattern=(LayerSpec(mixer="rwkv", ffn="rwkv_cmix"),),
    vocab_size=65536,
    d_ff=14336,
    norm="layernorm",
    use_rope=False,
    rwkv=RWKVSpec(head_dim=64),
    sub_quadratic=True,
)

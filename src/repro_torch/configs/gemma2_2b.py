"""gemma2-2b [arXiv:2408.00118] — counterpart of ``src/repro/configs/gemma2_2b.py``.

26 layers, d_model 2304, 8 heads (GQA kv=4), head_dim 256, d_ff 9216,
vocab 256000; alternating 4096-token sliding-window and global layers,
attention-logit softcap 50, final-logit softcap 30, sandwich (post-block)
RMSNorms, tied embeddings scaled by sqrt(d_model).  The MLP is the
reference's non-gated tanh-GELU over ``wi_up``.
"""

from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    d_model=2304,
    n_layers=26,
    pattern=(
        LayerSpec(mixer="attn_local", ffn="dense"),
        LayerSpec(mixer="attn", ffn="dense"),
    ),
    vocab_size=256000,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    activation="gelu",
    norm="rmsnorm",
    attn_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_block_norm=True,
    tie_embeddings=True,
    sub_quadratic=True,   # windowed layers bound the quadratic term
)

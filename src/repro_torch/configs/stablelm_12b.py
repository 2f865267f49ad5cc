"""StableLM-2-12B [hf:stabilityai/stablelm-2-12b]. Partial rotary (25%).

The widths are the 12B model's; the ``source`` field names
``stablelm-2-1_6b``, as the JAX package's config does, and is kept equal to
it.  head_dim 160 with ``rotary_pct`` 0.25 rotates the first 40 dims of
each head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    act="swiglu",
    norm="layernorm",
    pos_kind="rope",
    rope_theta=10000.0,
    rotary_pct=0.25,
    source="hf:stabilityai/stablelm-2-1_6b; hf",
)

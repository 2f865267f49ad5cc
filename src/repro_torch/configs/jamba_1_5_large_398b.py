"""Jamba-1.5-Large (398B total) [arXiv:2403.19887; hf].

Hybrid: 1 attention layer per 8 (1:7 attn:mamba interleave), MoE (16 experts,
top-2) on every other layer.  72 layers = 9 periods of 8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    act="swiglu",
    norm="rmsnorm",
    pos_kind="none",  # Jamba uses no explicit positional encoding
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    ssm_state=16,
    d_inner=16384,  # expand=2
    conv_width=4,
    attn_every=8,
    source="arXiv:2403.19887; hf",
)

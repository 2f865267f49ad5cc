"""Phi-3.5-MoE (42B total, 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

16 experts, top-2 routing.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    act="swiglu",
    norm="rmsnorm",
    pos_kind="rope",
    rope_theta=10000.0,
    n_experts=16,
    experts_per_token=2,
    moe_every=1,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

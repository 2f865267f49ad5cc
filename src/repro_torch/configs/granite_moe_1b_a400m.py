"""IBM Granite-3.0-1B-A400M MoE base [hf:ibm-granite/granite-3.0-1b-a400m-base].

32 experts, top-8 routing, per-expert d_ff=512.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    act="swiglu",
    norm="rmsnorm",
    pos_kind="rope",
    rope_theta=10000.0,
    tie_embeddings=True,
    n_experts=32,
    experts_per_token=8,
    moe_every=1,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

"""Falcon-Mamba-7B (pure Mamba-1, attention-free) [arXiv:2410.05355; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,  # Mamba-1 block has no separate MLP
    vocab_size=65024,
    norm="rmsnorm",
    pos_kind="none",
    ssm_state=16,
    d_inner=8192,  # expand=2
    conv_width=4,
    source="arXiv:2410.05355; unverified",
)

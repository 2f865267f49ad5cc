"""DeepSeek-67B (llama-arch, GQA kv=8, 95 layers) [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    act="swiglu",
    norm="rmsnorm",
    pos_kind="rope",
    rope_theta=10000.0,
    source="arXiv:2401.02954; hf",
)

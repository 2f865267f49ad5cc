"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

VLM: the vision frontend is a STUB — ``input_specs`` supplies precomputed
patch/text embeddings (batch, seq, d_model) plus 3-component M-RoPE position
ids (temporal, height, width).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    act="swiglu",
    norm="rmsnorm",
    pos_kind="mrope",
    rope_theta=1_000_000.0,
    input_kind="embeddings",
    source="arXiv:2409.12191; hf",
)

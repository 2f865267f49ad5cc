"""MusicGen-large decoder backbone over EnCodec tokens [arXiv:2306.05284; hf].

Audio: the EnCodec frontend is a STUB — ``input_specs`` supplies precomputed
frame embeddings (the sum of the four codebook embeddings per frame); the LM
head predicts the 2048-way codebook distribution.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,  # MHA (GQA with kv == heads)
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    norm="layernorm",
    pos_kind="sinusoidal",
    input_kind="embeddings",
    source="arXiv:2306.05284; hf",
)

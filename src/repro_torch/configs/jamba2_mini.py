"""AI21-Jamba2-Mini [hf:ai21labs/AI21-Jamba2-Mini, config.json].

Hybrid: blocks of 8 layers, attention at index 4 of each (``attn_layer_period``
8, ``attn_layer_offset`` 4) and Mamba-1 elsewhere, the mixer's dt, B and C
RMS-normed after ``x_proj``; MoE (16 experts of width 14,336, top-2 of the
softmax, not renormalised) on every odd layer (``expert_layer_period`` 2,
offset 1), dense SwiGLU of the same width on the others.  32 layers, 4
periods; no positional encoding, untied head, 262,144 positions.
"""
from repro_torch.configs.base import PortConfig

CONFIG = PortConfig(
    name="jamba2-mini",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    act="swiglu",
    norm="rmsnorm",
    pos_kind="none",
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    ssm_state=16,
    d_inner=8192,  # mamba_expand 2
    dt_rank=256,
    conv_width=4,
    attn_every=8,
    attn_offset=4,
    mamba_inner_norms=True,
    moe_renormalize=False,
    source="https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/config.json",
)

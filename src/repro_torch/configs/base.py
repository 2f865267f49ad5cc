"""Architecture + input-shape configuration for the PyTorch port.

A copy of the JAX package's ``configs/base.py`` (pure Python): the port keeps
its own so that nothing of the JAX package is imported.  ``reduced()``
derives the CPU-test variant of the same family (same layer plan, tiny dims).

``PortConfig`` adds the fields of mechanisms that no arch of the JAX package
has (Jamba's attention offset, the Mamba mixer's inner norms, top-k weights
left unnormalised).  ``ModelConfig`` holds each as a class attribute at its
default, so every ``ModelConfig`` computes as the JAX package's and its
fields stay the JAX package's, one for one.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Tuple

# ---------------------------------------------------------------------------
# Layer plan: the repeating period of heterogeneous layers (Jamba interleave,
# MoE frequency).  The model stacks `n_layers / len(plan)` scanned periods.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    """One layer slot inside the repeating period."""

    mixer: str  # "attn" | "mamba"
    mlp: str  # "dense" | "moe" | "none"


@dataclass(frozen=True)
class InputShape:
    """One benchmark cell's input geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int  # query heads; 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    act: str = "swiglu"  # swiglu | gelu | relu2
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    pos_kind: str = "rope"  # rope | mrope | sinusoidal | none
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    input_kind: str = "tokens"  # tokens | embeddings (stub modality frontend)
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # apply MoE MLP every k-th layer (1 = all layers)
    # --- SSM (Mamba-1) ---
    ssm_state: int = 0
    d_inner: int = 0  # mamba inner width (expand * d_model)
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    conv_width: int = 4
    attn_every: int = 0  # hybrid: one attention layer per `attn_every` layers
    # --- misc ---
    dtype: str = "bfloat16"
    source: str = ""

    # ``PortConfig``'s fields at their defaults (class attributes, no fields)
    attn_offset = 0
    mamba_inner_norms = False
    moe_renormalize = True

    # -- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def resolved_dt_rank(self) -> int:
        if self.dt_rank:
            return self.dt_rank
        return math.ceil(self.d_model / 16)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def sub_quadratic(self) -> bool:
        """True when long-context decode shapes (500k) are admissible."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_attention_free(self) -> bool:
        return self.n_heads == 0

    def layer_plan(self) -> List[LayerSpec]:
        """The repeating period of layers."""
        period = 1
        if self.attn_every:
            period = self.attn_every
        if self.is_moe:
            period = _lcm(period, self.moe_every)
        plan = []
        for i in range(period):
            if self.is_attention_free:
                mixer = "mamba"
            elif self.attn_every:
                mixer = "attn" if i == self.attn_offset else "mamba"
            else:
                mixer = "attn"
            if self.d_ff == 0:
                mlp = "none"
            elif self.is_moe and (i % self.moe_every == self.moe_every - 1):
                mlp = "moe"
            else:
                mlp = "dense"
            plan.append(LayerSpec(mixer=mixer, mlp=mlp))
        assert self.n_layers % len(plan) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"period={len(plan)}"
        )
        return plan

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_plan())

    # -- parameter accounting (used by the cost model and 6ND MFU) ----------
    def _mixer_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.mixer == "attn":
            hd = self.resolved_head_dim
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o
        # mamba-1
        di, ds, dtr = self.d_inner, self.ssm_state, self.resolved_dt_rank
        in_proj = d * 2 * di
        conv = self.conv_width * di + di
        x_proj = di * (dtr + 2 * ds)
        dt_proj = dtr * di + di
        a_d = di * ds + di
        out_proj = di * d
        norms = dtr + 2 * ds if self.mamba_inner_norms else 0
        return in_proj + conv + x_proj + dt_proj + a_d + out_proj + norms

    def _mlp_params(self, spec: LayerSpec) -> Tuple[int, int]:
        """(total, active) parameters of the MLP slot."""
        d = self.d_model
        if spec.mlp == "none":
            return 0, 0
        mats = 3 if self.act == "swiglu" else 2
        one = mats * d * self.d_ff
        if spec.mlp == "moe":
            router = d * self.n_experts
            return one * self.n_experts + router, one * self.experts_per_token + router
        return one, one

    def param_count(self) -> int:
        plan = self.layer_plan()
        per_period = sum(
            self._mixer_params(s) + self._mlp_params(s)[0] + 2 * self.d_model
            for s in plan
        )
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return per_period * self.n_periods + emb + head + self.d_model

    def active_param_count(self) -> int:
        plan = self.layer_plan()
        per_period = sum(
            self._mixer_params(s) + self._mlp_params(s)[1] + 2 * self.d_model
            for s in plan
        )
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return per_period * self.n_periods + emb + head + self.d_model

    # -- smoke-test variant ---------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        plan_len = len(self.layer_plan())
        n_layers = plan_len * (2 if plan_len <= 4 else 1)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=0 if self.is_attention_free else 4,
            n_kv_heads=0 if self.is_attention_free else min(self.n_kv_heads, 2),
            head_dim=0 if self.is_attention_free else 16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            d_inner=128 if self.d_inner else 0,
            dt_rank=8 if self.is_ssm else 0,
            dtype="float32",
        )


@dataclass(frozen=True)
class PortConfig(ModelConfig):
    """A ``ModelConfig`` with the port's own fields; their defaults change
    nothing."""

    attn_offset: int = 0  # hybrid: the attention layer's index in the period (Jamba's attn_layer_offset)
    mamba_inner_norms: bool = False  # RMS norms of dt, B and C after x_proj (Jamba's mixer)
    moe_renormalize: bool = True  # top-k weights over their sum; False: the softmax's as they are


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)

"""The schedule plan the port's steps are built from.

Only ``SchedulePlan`` is ported so far (a copy of the JAX package's
``core/space.py:52-79``); the schedule space and the search over it follow
with ROADMAP item A4.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SchedulePlan:
    """A complete schedule: one value per stage."""

    batch_axes: str = "data"  # "data" | "pod_data"
    param_strategy: str = "fsdp_tp"  # replicated | tp | fsdp | fsdp_tp
    mixer_tp: bool = True  # shard attention heads / mamba d_inner over model
    seq_shard: bool = False  # sequence-parallel activations / KV-cache seq
    ffn_tp: bool = True
    moe_mode: str = "dense"  # ep | tp | dense (dense = replicated experts)
    vocab_shard: bool = True
    remat: str = "dots"  # none | dots | full
    microbatches: int = 1
    attn_block: Tuple[int, int] = (256, 256)  # flash (block_q, block_kv)
    scan_chunk: int = 128  # mamba time chunk
    grad_comm: str = "fp32"  # fp32 | int8 | rs_ag
    overlap: float = 0.5  # collective/compute overlap factor
    opt_dtype: str = "float32"  # float32 | int8 Adam moments
    kv_dtype: str = "bf16"  # bf16 | int8 KV cache (decode shapes)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SchedulePlan":
        d = dict(d)
        if isinstance(d.get("attn_block"), list):
            d["attn_block"] = tuple(d["attn_block"])
        return SchedulePlan(**d)

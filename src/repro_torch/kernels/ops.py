"""Kernel entry points the models call, with dispatch by device.

The counterpart of the JAX package's ``kernels/ops.py``.  There is no mode
switch: a tensor on the CPU takes a kernel's plain PyTorch version, a tensor
on a CUDA device launches the hand-written kernel or raises.  Kernel block
shapes come from the schedule plan (``KernelTiles``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn


@dataclasses.dataclass(frozen=True)
class KernelTiles:
    """Schedule-tunable kernel block shapes (the scan and MoE tiles join
    with their kernels, ROADMAP items B3 and B4)."""

    attn_block_q: int = 256
    attn_block_kv: int = 256


DEFAULT_TILES = KernelTiles()

# every kernel of the port, by name, with its launch counter
COUNTERS = {"rmsnorm": _rn.LAUNCHES, "flash_attention": _fa.LAUNCHES}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def attention(q, k, v, *, causal: bool = True, tiles: KernelTiles = DEFAULT_TILES) -> torch.Tensor:
    return _fa.flash_attention(
        q, k, v, causal=causal, block_q=tiles.attn_block_q, block_kv=tiles.attn_block_kv
    )


def rmsnorm(x, w, *, eps: float = 1e-6) -> torch.Tensor:
    return _rn.rmsnorm(x, w, eps=eps)

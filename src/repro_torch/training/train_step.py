"""Builders for the prefill and decode step functions, on one device.

The counterpart of the serving half of the JAX package's
``training/train_step.py``: the plan's kernel knobs become ``KernelTiles``
and are threaded through ``transformer.forward`` / ``decode_step``.  The
train step follows with ROADMAP item A3; sharding over a mesh with A8.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.space import SchedulePlan
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import KernelTiles
from repro_torch.models import transformer


def tiles_from_plan(plan: SchedulePlan) -> KernelTiles:
    return KernelTiles(
        attn_block_q=plan.attn_block[0],
        attn_block_kv=plan.attn_block[1],
        scan_chunk=plan.scan_chunk,
    )


def make_positions(cfg: ModelConfig, batch: int, seq: int, device="cuda") -> torch.Tensor:
    if cfg.pos_kind == "mrope":
        raise NotImplementedError("M-RoPE positions are not ported yet: ROADMAP item A2")
    device = resolve_device(device)
    return torch.arange(seq, dtype=torch.long, device=device)[None, :].expand(batch, seq)


def _single_device(mesh, device) -> torch.device:
    if mesh is not None:
        raise NotImplementedError("steps over a mesh are not ported yet: ROADMAP item A8")
    return resolve_device(device)


def make_prefill_step(
    cfg: ModelConfig,
    shape: Optional[InputShape],
    plan: SchedulePlan,
    mesh=None,
    device="cuda",
) -> Callable:
    """(params, batch) -> logits for the full prompt (inference forward)."""
    _single_device(mesh, device)
    tiles = tiles_from_plan(plan)

    def prefill_step(params, batch):
        return transformer.forward(params, cfg, batch["inputs"], batch["positions"], tiles=tiles)

    return prefill_step


def make_serve_step(
    cfg: ModelConfig,
    shape: Optional[InputShape],
    plan: SchedulePlan,
    mesh=None,
    device="cuda",
) -> Callable:
    """(params, cache, inputs, cur, commit=None) -> (logits, cache): one decode
    token, its cache state written into ``cache`` in place for the rows in
    ``commit``; the plan's tiles reach the MoE MLP's grouped GEMMs."""
    _single_device(mesh, device)
    tiles = tiles_from_plan(plan)

    def serve_step(params, cache, inputs, cur, commit=None):
        return transformer.decode_step(params, cfg, cache, inputs, cur, commit=commit, tiles=tiles)

    return serve_step

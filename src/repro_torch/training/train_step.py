"""Builders for the train, prefill and decode step functions, on one device.

The counterpart of the JAX package's ``training/train_step.py``: the plan's
kernel knobs become ``KernelTiles`` and are threaded through
``transformer.forward`` / ``decode_step``; the train step also threads the
plan's ``remat``, ``microbatches``, ``grad_comm`` and (through the default
optimizer config) ``opt_dtype``.  Sharding over a mesh is ROADMAP item A8.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.space import SchedulePlan
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ops import KernelTiles
from repro_torch.models import transformer
from repro_torch.models.losses import cross_entropy
from repro_torch.training import optimizer as optim


def tiles_from_plan(plan: SchedulePlan) -> KernelTiles:
    return KernelTiles(
        attn_block_q=plan.attn_block[0],
        attn_block_kv=plan.attn_block[1],
        scan_chunk=plan.scan_chunk,
    )


def make_positions(cfg: ModelConfig, batch: int, seq: int, device="cuda") -> torch.Tensor:
    """``(batch, seq)`` ids ``0..seq-1``; for M-RoPE ``(batch, 3, seq)``, the
    same ids in each of the three components (text positions)."""
    device = resolve_device(device)
    pos = torch.arange(seq, dtype=torch.long, device=device)
    if cfg.pos_kind == "mrope":
        return pos[None, None, :].expand(batch, 3, seq)
    return pos[None, :].expand(batch, seq)


def _single_device(mesh, device) -> torch.device:
    if mesh is not None:
        raise NotImplementedError("steps over a mesh are not ported yet: ROADMAP item A8")
    return resolve_device(device)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def make_train_step(
    cfg: ModelConfig,
    shape: Optional[InputShape],
    plan: SchedulePlan,
    opt_cfg: Optional[optim.OptimizerConfig] = None,
    mesh=None,
    device="cuda",
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch``: ``{"inputs": (B,S) or (B,S,d), "labels": (B,S), "positions":
    (B,S) or (B,3,S)}``
    tensors on the device.  The parameters are marked as requiring grad and
    updated in place (``optimizer.apply_updates``).  With ``microbatches >
    1`` each microbatch's gradient comes from ``torch.autograd.grad`` and is
    summed into f32 buffers, then divided by their number, as the JAX scan
    does (``.grad`` never accumulates in the bf16 parameter dtype).
    ``metrics``: ``loss``, ``lr`` and ``grad_norm``, f32 0-dim tensors.
    """
    _single_device(mesh, device)
    opt_cfg = opt_cfg or optim.OptimizerConfig(moment_dtype=plan.opt_dtype)
    tiles = tiles_from_plan(plan)
    n_mb = plan.microbatches

    def loss_fn(params, inputs, labels, positions):
        logits = transformer.forward(params, cfg, inputs, positions, tiles=tiles, remat=plan.remat)
        return cross_entropy(logits[:, :-1, :], labels[:, 1:])

    def train_step(params, opt_state, batch):
        inputs, labels, positions = batch["inputs"], batch["labels"], batch["positions"]
        paths, leaves = zip(*optim.leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        if n_mb > 1:
            B = inputs.shape[0]
            if B % n_mb:
                raise ValueError(f"batch {B} does not split into {n_mb} microbatches")
            mb = B // n_mb
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=inputs.device)
            for i in range(n_mb):
                rows = slice(i * mb, (i + 1) * mb)
                mb_loss = loss_fn(params, inputs[rows], labels[rows], positions[rows])
                for acc, g in zip(grads, torch.autograd.grad(mb_loss, leaves)):
                    acc.add_(g)
                loss += mb_loss.detach()
            loss /= n_mb
            for acc in grads:
                acc.div_(n_mb)
        else:
            loss = loss_fn(params, inputs, labels, positions)
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach()
        if plan.grad_comm == "int8":
            # the JAX step's fake quant of the reduced gradient: the numerics
            # of the compressed collective, here through the hand kernels
            grads = [fake_quant_rowwise(g) for g in grads]
        params, opt_state, opt_metrics = optim.apply_updates(
            params, optim.tree_from_leaves(params, dict(zip(paths, grads))), opt_state, opt_cfg
        )
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step


def fake_quant_rowwise(g: torch.Tensor) -> torch.Tensor:
    """``dequantize(quantize(g))`` rowwise over the last axis, in g's dtype;
    bit-identical to the JAX ``_fake_quant_rowwise``, for leaves of ``ndim >=
    2`` with a last axis of at least 16 (others pass through)."""
    if g.ndim < 2 or g.shape[-1] < 16:
        return g
    q, s = ops.quantize_int8(g.reshape(-1, g.shape[-1]))
    return ops.dequantize_int8(q, s, dtype=g.dtype).reshape(g.shape)


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

    @torch.no_grad()
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

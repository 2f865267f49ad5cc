"""Builders for the train, prefill and decode step functions.

The counterpart of the JAX package's ``training/train_step.py``: the plan's
kernel knobs become ``KernelTiles`` and are threaded through
``transformer.forward`` / ``decode_step``; the train step also threads the
plan's ``remat``, ``microbatches``, ``grad_comm`` and (through the default
optimizer config) ``opt_dtype``.

Given a mesh (``launch.mesh.Mesh``) the train and prefill steps run SPMD,
one process a rank: the parameters and optimizer state are the rank's
shards under ``ShardingRules`` (``shard_params``), the rank takes its rows
of the global batch (split over the batch axes) and runs its microbatches,
the model runs under a ``ParallelContext``, and the gradients are summed
over the batch axes before the optimizer updates the shards in place.  The
numbers are the one-device step's (``tests/test_torch_distributed.py``).
The decode step over a mesh holds each rank's shard of the cache
(``ShardingRules.cache_pspecs``): KV heads split over ``model``, or
positions split over ``model`` (or the whole mesh for batch-1 long
context) with the partial softmaxes combined explicitly, Mamba's state by
``d_inner``, rows over the batch axes.
Without a mesh the same steps run on one device, a mesh of size 1
(``ParallelContext.local``) whose collectives are all the identity.
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
from repro_torch.models.losses import cross_entropy, cross_entropy_vocab_parallel
from repro_torch.runtime import tracing
from repro_torch.runtime.graphs import StepGraphs
from repro_torch.sharding import collectives as cc
from repro_torch.sharding.parallel import (
    ParallelContext, gather_tree, local_shape, shard_tree,
)
from repro_torch.sharding.rules import ShardingRules
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


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------
def moe_dist_for(cfg: ModelConfig, shape: Optional[InputShape], plan: SchedulePlan, mesh) -> bool:
    """Whether the MoE MLPs run expert-parallel: the plan asks for it, TP is
    on, the batch splits over the batch axes and the experts over ``model``
    (the JAX package's ``moe_dist_for``, which returns its shard_map
    context where this returns True)."""
    if not (cfg.is_moe and plan.moe_mode == "ep" and mesh is not None):
        return False
    if plan.param_strategy not in ("tp", "fsdp_tp", "tp2d"):
        return False
    spec = mesh.spec
    batch_axes = ("pod", "data") if plan.batch_axes == "pod_data" and spec.multi_pod else ("data",)
    dp = 1
    for a in batch_axes:
        dp *= spec.axis(a)
    if shape is not None and shape.global_batch % dp != 0:
        return False
    return cfg.n_experts % min(spec.axis("model"), cfg.n_experts) == 0


def parallel_context(cfg: ModelConfig, shape: Optional[InputShape], plan: SchedulePlan,
                     mesh=None, device="cuda") -> ParallelContext:
    """This rank's ``ParallelContext`` for ``cfg`` under ``plan`` on ``mesh``;
    without a mesh, one device's (``device``)."""
    shapes = transformer.param_shapes(cfg)
    if mesh is None:
        return ParallelContext.local(shapes, resolve_device(device))
    rules = ShardingRules(cfg, shape, plan, mesh.spec)
    return ParallelContext(mesh, rules.param_pspecs(shapes), shapes, batch_axes=rules.batch,
                           seq_shard=plan.seq_shard, moe_ep=moe_dist_for(cfg, shape, plan, mesh),
                           rules=rules)


def shardings_for_train(cfg, shape, plan, mesh, opt_state=None) -> dict:
    """Each parameter leaf's spec and its local shard shape on ``mesh``, the
    optimizer state's specs (given a state, whole or local: only its
    structure is read), and, given a ``shape``, the batch's specs."""
    par = parallel_context(cfg, shape, plan, mesh)
    rules = ShardingRules(cfg, shape, plan, mesh.spec)
    local = {path: local_shape(par.flat_shapes[path], spec, mesh)
             for path, spec in par.flat_specs.items()}
    out = {"params": par.specs, "local_shapes": local, "rules": rules}
    if shape is not None:
        out["batch"] = {
            "inputs": rules.batch_spec(3 if cfg.input_kind == "embeddings" else 2),
            "labels": rules.batch_spec(2),
            "positions": rules.batch_spec(3 if cfg.pos_kind == "mrope" else 2),
        }
    if opt_state is not None:
        out["opt_state"] = optim.opt_state_pspecs(opt_state, par.specs)
    return out


def shard_params(params: dict, par: ParallelContext) -> dict:
    """Whole parameter leaves (torch or numpy, e.g. from ``init_params`` on
    the CPU or ``convert.params_from_numpy``) -> this rank's shards, on the
    mesh's device.  A leaf is read, never changed."""
    return shard_tree(params, par.specs, par.mesh)


def gather_params(params: dict, par: ParallelContext) -> dict:
    """``shard_params`` backwards: whole leaves on every rank (collective)."""
    return gather_tree(params, par.specs, par.mesh)


def gather_opt_state(opt_state: dict, par: ParallelContext) -> dict:
    """An optimizer state's shards -> whole leaves on every rank (collective;
    an int8 moment's scales are replicated along the last axis)."""
    return gather_tree(opt_state, optim.opt_state_pspecs(opt_state, par.specs), par.mesh)


def _local_rows(par: ParallelContext, batch: dict) -> dict:
    """This rank's rows of a global batch (split over the batch axes)."""
    B = batch["inputs"].shape[0]
    if B % par.dp:
        raise ValueError(f"batch {B} does not split over {par.dp} ranks of {par.batch_axes}")
    b, i = B // par.dp, par.mesh.index(par.batch_axes)
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


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

    ``mesh``: the step of this rank (see the module's docstring): ``params``
    and ``opt_state`` are its shards (``shard_params``;
    ``optim.init_opt_state(params, oc, step.par)``), ``batch`` is the global
    batch, and ``loss`` and ``grad_norm`` are the global ones.  Without one
    the step runs on ``device``, a mesh of size 1.  The step carries its
    context as ``step.par`` and ``step.loss_and_grads(params, batch) ->
    (loss, {dotted path: gradient})``, the gradients summed over the batch
    and scaled as the optimizer reads them.
    """
    opt_cfg = opt_cfg or optim.OptimizerConfig(moment_dtype=plan.opt_dtype)
    par = parallel_context(cfg, shape, plan, mesh, device)
    tiles = tiles_from_plan(plan)
    n_mb = plan.microbatches
    vsplit = transformer.vocab_split(cfg, par)

    def loss_fn(params, inputs, labels, positions):
        logits = transformer.forward(params, cfg, inputs, positions, tiles=tiles, remat=plan.remat,
                                     par=par)
        if vsplit:
            return cross_entropy_vocab_parallel(logits[:, :-1, :], labels[:, 1:], par.mesh, "model")
        return cross_entropy(logits[:, :-1, :], labels[:, 1:])

    def loss_and_grads(params, batch):
        batch = _local_rows(par, batch)
        inputs, labels, positions = batch["inputs"], batch["labels"], batch["positions"]
        paths, leaves = zip(*optim.leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        B = inputs.shape[0]
        if B % n_mb:
            raise ValueError(f"a rank's batch {B} does not split into {n_mb} microbatches")
        mb = B // n_mb
        grads, loss = None, torch.zeros((), dtype=torch.float32, device=par.mesh.device)
        for i in range(n_mb):
            rows = slice(i * mb, (i + 1) * mb)
            mb_loss = loss_fn(params, inputs[rows], labels[rows], positions[rows])
            gs = torch.autograd.grad(mb_loss, leaves)
            if grads is None:
                # one microbatch on one batch rank keeps the parameters' dtype,
                # as the JAX step's gradient does; a sum is taken in f32
                grads = list(gs) if n_mb == 1 and par.dp == 1 else [g.float() for g in gs]
            else:
                for acc, g in zip(grads, gs):
                    acc.add_(g)
            loss += mb_loss.detach()
        flat = dict(zip(paths, grads))
        par.reduce_batch_grads(flat)
        scale = n_mb * par.dp
        if scale > 1:
            for g in grads:
                g.div_(scale)
        loss = cc.all_reduce_(loss.reshape(1), par.mesh, par.batch_axes)[0] / scale
        return loss, flat

    def train_step(params, opt_state, batch):
        loss, flat = loss_and_grads(params, batch)
        if plan.grad_comm == "int8":
            # the JAX step's fake quant of the reduced gradient: the numerics
            # of the compressed collective, here through the hand kernels
            flat = {path: fake_quant_rowwise(g, par.mesh, par.row_axes(path), par.global_shape(path))
                    for path, g in flat.items()}
        params, opt_state, opt_metrics = optim.apply_updates(
            params, optim.tree_from_leaves(params, flat), opt_state, opt_cfg, dist=par)
        return params, opt_state, {"loss": loss, **opt_metrics}

    train_step.par = par
    train_step.loss_and_grads = loss_and_grads
    return train_step


def fake_quant_rowwise(g: torch.Tensor, mesh=None, axes=(), shape=None) -> torch.Tensor:
    """``dequantize(quantize(g))`` rowwise over the last axis, in g's dtype;
    bit-identical to the JAX ``_fake_quant_rowwise``, for leaves of ``ndim >=
    2`` with a last axis of at least 16 (others pass through).  A shard:
    ``shape`` is the whole leaf's and its last axis is split over ``axes``
    of ``mesh`` (the row's amax is the group's, ``optimizer.quantize_rows``)."""
    shape = tuple(shape or g.shape)
    if len(shape) < 2 or shape[-1] < 16:
        return g
    q, s = optim.quantize_rows(g, mesh, axes)
    return ops.dequantize_int8(q.contiguous(), s, dtype=g.dtype).reshape(g.shape)


def make_prefill_step(
    cfg: ModelConfig,
    shape: Optional[InputShape],
    plan: SchedulePlan,
    mesh=None,
    device="cuda",
) -> Callable:
    """(params, batch) -> logits for the full prompt (inference forward).

    ``mesh``: this rank's step; ``params`` are its shards, ``batch`` the
    global batch, and the logits ``(B / dp, S, V)`` those of its rows (over
    the whole vocabulary)."""
    tiles = tiles_from_plan(plan)
    par = parallel_context(cfg, shape, plan, mesh, device)
    vsplit = transformer.vocab_split(cfg, par)

    @torch.no_grad()
    def prefill_step(params, batch):
        batch = _local_rows(par, batch)
        logits = transformer.forward(params, cfg, batch["inputs"], batch["positions"], tiles=tiles,
                                     par=par)
        return cc.all_gather_raw(logits, par.mesh, "model", logits.ndim - 1) if vsplit else logits

    prefill_step.par = par
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
    ``commit``; the plan's tiles reach the MoE MLP's grouped GEMMs.

    Without a mesh, where ``inputs`` lie on a CUDA device, the step runs
    through CUDA graphs (``runtime.graphs.StepGraphs``): the first call of a
    key runs as it is, the second captures the step and replays it, later
    ones replay it; each call advances the cache once and returns logits of
    its own.  On the CPU, on meta tensors and over a mesh it runs as it is.

    ``mesh``: this rank's step.  ``shape`` is the decode cell's
    ``InputShape``: ``global_batch`` rows over a cache of ``seq_len``
    positions, as the JAX dry run passes it.  ``params`` are the rank's
    shards (``shard_params``), ``cache`` its shard
    (``transformer.init_cache(..., par=step.par)`` or ``shard_cache``),
    ``inputs`` / ``cur`` / ``commit`` the global rows, and the logits
    ``(B, V)`` every row's on every rank.  The step carries its context as
    ``step.par`` and its graphs as ``step.graphs`` (None over a mesh)."""
    tiles = tiles_from_plan(plan)
    par = parallel_context(cfg, shape, plan, mesh, device)
    if mesh is not None:
        if shape is None:
            raise ValueError("decode over a mesh needs the cell's InputShape (rows, cache length)")
        par = par.for_decode(shape.global_batch, shape.seq_len)
    vsplit = transformer.vocab_split(cfg, par)

    def step(params, cache, inputs, cur, commit):
        logits, _ = transformer.decode_step(
            params, cfg, cache, par.decode_rows(inputs), par.decode_rows(cur) if cur.ndim else cur,
            commit=None if commit is None else par.decode_rows(commit), tiles=tiles, par=par)
        if vsplit:
            logits = cc.all_gather_raw(logits, par.mesh, "model", logits.ndim - 1)
        if par.rows_split:
            logits = cc.all_gather_raw(logits, par.mesh, par.batch_axes, 0)
        return logits

    graphs = StepGraphs(step) if mesh is None else None

    def serve_step(params, cache, inputs, cur, commit=None):
        if mesh is not None and inputs.shape[0] != shape.global_batch:
            raise ValueError(f"{inputs.shape[0]} rows, the cell has {shape.global_batch}")
        with tracing.span(tracing.ROOT):
            cur = torch.as_tensor(cur, dtype=torch.long, device=inputs.device)
            run = graphs if graphs is not None and inputs.is_cuda else step
            return run(params, cache, inputs, cur, commit), cache

    serve_step.par = par
    serve_step.graphs = graphs
    return serve_step

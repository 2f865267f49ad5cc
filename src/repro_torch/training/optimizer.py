"""AdamW with optional int8-quantized moments.

The counterpart of the JAX package's ``training/optimizer.py``.  Parameters,
gradients and moments are nested dicts with the parameter tree's nesting; a
moment leaf is an f32 tensor or, for ``moment_dtype="int8"`` and a leaf of
``ndim >= 2`` with a last axis of at least 16, ``{"q": int8, "s": f32 (..., 1)}``,
rowwise over the last axis.  The int8 codec runs through ``ops.quantize_int8``
/ ``ops.dequantize_int8`` on ``(-1, shape[-1])`` views: the hand kernels on
the card, their plain versions on the CPU.  The stacked leading
``n_periods`` axis makes the ``norm1``/``norm2`` leaves 2-D, so they are
quantized, exactly as in the JAX package.

Where the JAX ``apply_updates`` returns new trees, this one writes the new
parameters and moments into the given tensors in place (one copy of each on
the card) and returns the same objects.  It reads, updates and writes each
leaf in ``chunks``, runs of the leading axis of at most ``CHUNK_ELEMS``
elements, so that no f32 temporary is larger than a chunk; the update is
elementwise and an int8 moment rowwise over the last axis, so the
parameters and moments come out as a whole-leaf update would make them.
The weight decay reads the whole leaf's rank, never a chunk's.  The global
norm sums each chunk's f32 sum of squares, in order: over a leaf of several
chunks that is another order of sums than the whole leaf's.  Step scalars (learning rate, clip
scale, bias corrections) are f32 0-dim tensors on the parameters' device, as
JAX computes them.

Over a mesh (``dist``, a ``sharding.parallel.ParallelContext``) every rank
updates its own shards in place.  What needs the whole leaf: an int8
moment's quantizability reads the leaf's global shape, and the amax of a
row whose last axis is split is the max over that axis's group, so that the
scale is the whole row's (its spec drops the last axis: it is replicated
there); the global norm sums each leaf's local sums of squares over its
shard group and counts a replicated leaf once.  A shard is chunked by its
own shape: the ranks of a row's group hold equal shapes, so they take the
same chunks, one amax exchange each.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.sharding import collectives as cc
from repro_torch.sharding.parallel import ParallelContext
from repro_torch.sharding.rules import PartitionSpec


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # float32 | int8


def lr_at(oc: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay, in f32 like the JAX schedule."""
    s = step.to(torch.float32)
    warm = s / max(oc.warmup_steps, 1)
    prog = torch.clamp((s - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return oc.peak_lr * torch.where(s < oc.warmup_steps, warm, cos)


# the most elements of a leaf one optimizer chunk takes: ~256 MiB an f32
# temporary, one period of falcon-mamba-7b's in_proj
CHUNK_ELEMS = 1 << 26


def chunks(shape) -> List[Any]:
    """The indices of the chunks a leaf of ``shape`` is read and updated in:
    runs of its leading axis of at most ``CHUNK_ELEMS`` elements, each at
    least one index long; a 0-dim leaf is one chunk (``...``)."""
    shape = tuple(shape)
    if not shape:
        return [...]
    per = max(1, CHUNK_ELEMS // max(math.prod(shape[1:]), 1))
    return [slice(a, min(a + per, shape[0])) for a in range(0, max(shape[0], 1), per)]


# -- int8 moment codecs -------------------------------------------------------
def _quantizable(leaf) -> bool:
    """For a leaf, or a leaf's (global) shape."""
    shape = tuple(getattr(leaf, "shape", leaf))
    return len(shape) >= 2 and shape[-1] >= 16


def _is_moment(m) -> bool:
    return isinstance(m, dict) and set(m) == {"q", "s"}


def quantize_rows(x: torch.Tensor, mesh=None, axes=()):
    """``ops.quantize_int8`` of ``x``'s rows over its last axis ->
    ``(q (R, C), s (R, 1))``.  Where that axis is split over ``axes`` of
    ``mesh``, the row's amax is the group's max: appended as one more
    column, it is the kernel's row amax, so the scale is the whole row's."""
    rows = x.reshape(-1, x.shape[-1])
    if not axes or mesh.size(axes) == 1:
        return ops.quantize_int8(rows)
    amax = cc.all_reduce_max(rows.abs().amax(dim=-1, keepdim=True), mesh, axes)
    q, s = ops.quantize_int8(torch.cat([rows, amax.to(rows.dtype)], dim=1))
    return q[:, :-1], s


def _mom_zero(leaf: torch.Tensor, oc: OptimizerConfig, shape):
    if oc.moment_dtype == "int8" and _quantizable(shape):
        return {
            "q": torch.zeros(leaf.shape, dtype=torch.int8, device=leaf.device),
            "s": torch.zeros(leaf.shape[:-1] + (1,), dtype=torch.float32, device=leaf.device),
        }
    return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)


def _mom_chunk(m, index):
    """The rows ``index`` of the moment ``m`` (views): an int8 moment's codes
    and scales on the same rows."""
    if _is_moment(m):
        return {"q": m["q"][index], "s": m["s"][index]}
    return m[index]


def _mom_read(m) -> torch.Tensor:
    if _is_moment(m):
        q = m["q"]
        return ops.dequantize_int8(q.reshape(-1, q.shape[-1]), m["s"].reshape(-1, 1)).reshape(q.shape)
    return m


def _mom_write_(m, val: torch.Tensor, mesh=None, axes=()) -> None:
    """Store ``val`` into the moment ``m`` in place (requantized if int8,
    ``quantize_rows`` over ``axes``)."""
    if _is_moment(m):
        q, s = quantize_rows(val, mesh, axes)
        m["q"].copy_(q.reshape(m["q"].shape))
        m["s"].copy_(s.reshape(m["s"].shape))
    else:
        m.copy_(val)


# -- trees ----------------------------------------------------------------------
def leaves(tree: dict, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(dotted path, leaf)`` in insertion order; an int8 moment is one leaf."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict) and not _is_moment(v):
            yield from leaves(v, path + ".")
        else:
            yield path, v


def tree_from_leaves(like: dict, flat: Dict[str, Any], prefix: str = "") -> dict:
    """The tree of ``like``'s nesting whose leaves are ``flat[dotted path]``."""
    return {
        k: tree_from_leaves(v, flat, f"{prefix}{k}.") if isinstance(v, dict) and not _is_moment(v)
        else flat[f"{prefix}{k}"]
        for k, v in like.items()
    }


# -- public API ---------------------------------------------------------------
def init_opt_state(params: dict, oc: OptimizerConfig, dist=None) -> Dict[str, Any]:
    """Zero moments of ``params`` (this rank's shards under ``dist``; one
    device's context by default)."""
    dist = dist or ParallelContext.local(params)

    def zeros():
        return tree_from_leaves(params, {path: _mom_zero(p, oc, dist.global_shape(path))
                                         for path, p in leaves(params)})

    return {"mu": zeros(), "nu": zeros(), "step": 0}


def _sum_sq(g: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of ``g``: each chunk's, summed in order."""
    total = None
    for index in chunks(g.shape):
        s = torch.sum(torch.square(g[index].float()))
        total = s if total is None else total + s
    return total


def global_norm(tree: dict, dist=None) -> torch.Tensor:
    dist = dist or ParallelContext.local(tree)
    return torch.sqrt(dist.norm_sq({path: _sum_sq(g) for path, g in leaves(tree)}))


def opt_state_pspecs(state: Dict[str, Any], param_pspecs: dict) -> Dict[str, Any]:
    """Optimizer-state PartitionSpecs mirroring the param specs: an int8
    moment's codes take its leaf's spec, its scales the same without the
    last axis."""
    def per_moment(mom_tree):
        specs = dict(leaves(param_pspecs))
        return tree_from_leaves(mom_tree, {
            path: {"q": specs[path], "s": PartitionSpec(*specs[path][:-1], None)}
            if _is_moment(m) else specs[path]
            for path, m in leaves(mom_tree)})

    return {"mu": per_moment(state["mu"]), "nu": per_moment(state["nu"]), "step": PartitionSpec()}


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: Dict[str, Any], oc: OptimizerConfig,
                  dist=None):
    """One AdamW step, in place: returns ``(params, state, {"lr", "grad_norm"})``
    with the metrics as f32 0-dim tensors.  Under ``dist`` the trees are
    this rank's shards and the gradients already summed over the batch."""
    dist = dist or ParallelContext.local(params)
    flat_p = list(leaves(params))
    device = flat_p[0][1].device
    step = state["step"] + 1
    step_t = torch.tensor(step, dtype=torch.int32, device=device)
    lr = lr_at(oc, step_t)
    gnorm = global_norm(grads, dist)
    scale = torch.minimum(torch.ones((), device=device), oc.clip_norm / (gnorm + 1e-9))
    bc1 = 1.0 - oc.b1 ** step_t.to(torch.float32)
    bc2 = 1.0 - oc.b2 ** step_t.to(torch.float32)
    flat_g = dict(leaves(grads))
    flat_mu, flat_nu = dict(leaves(state["mu"])), dict(leaves(state["nu"]))
    for path, p in flat_p:
        decay = p.ndim >= 2  # decoupled weight decay on matrices only: the whole leaf's rank
        axes = dist.row_axes(path)
        for index in chunks(p.shape):
            pc, mu, nu = p[index], _mom_chunk(flat_mu[path], index), _mom_chunk(flat_nu[path], index)
            g = flat_g[path][index].float() * scale
            m = oc.b1 * _mom_read(mu) + (1 - oc.b1) * g
            v = oc.b2 * _mom_read(nu) + (1 - oc.b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
            if decay:
                delta = delta + oc.weight_decay * pc.float()
            pc.copy_((pc.float() - lr * delta).to(pc.dtype))
            _mom_write_(mu, m, dist.mesh, axes)
            _mom_write_(nu, v, dist.mesh, axes)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}

"""Collectives over one set of a mesh's axes, and their autograd.

The port's counterpart of what ``shard_map`` and XLA's SPMD partitioner put
into the JAX package's programs.  Each runs over the process group of
``axes`` (``Mesh.group``) and is the identity where that group has one rank.
Chunks are taken and placed in the group's order (row-major over the axes in
mesh order, as JAX's tiled collectives do).

Differentiable (``autograd.Function``s, Megatron's conjugate pairs):

* ``all_gather(x, dim, grad="reduce_scatter")``: the backward reduce-
  scatters (sums) the gradient, for a gathered input whose consumers differ
  across the group (a tensor-parallel region, or FSDP over the batch axes);
  ``grad="split"`` keeps only this rank's chunk, for a consumer that every
  rank of the group runs alike;
* ``reduce_scatter(x, dim)`` (backward: all-gather);
* ``all_reduce_sum(x)`` (Megatron's *g*: backward identity);
* ``copy_to_region(x)`` (Megatron's *f*: forward identity, backward
  all-reduce);
* ``split(x, dim)`` (forward: this rank's chunk; backward: all-gather).

Not differentiable: ``all_reduce_max``, ``ppermute`` (a ring shift over
``batch_isend_irecv``) and ``softmax_combine``, the decode attention's
combine of the partial softmaxes of a KV cache split by position.

**Counted.**  Every raw collective (``all_reduce_``, ``all_reduce_max``,
``all_gather_raw``, ``reduce_scatter_raw``, ``ppermute``, and the two
all-reduces of ``softmax_combine``) adds to ``COLL`` what it moves, by
kind (XLA's names: ``all-reduce``, ``all-gather``, ``reduce-scatter``,
``collective-permute``) and group size, in the ring formulas of the JAX
package's HLO analysis: the bytes a rank contributes (its operand) and
those its links carry (an all-gather of an ``s``-byte chunk over ``g``
ranks ``s(g-1)``; a reduce-scatter of ``s`` bytes ``s(g-1)/g``; an
all-reduce ``2s(g-1)/g``; a permute ``s``).  A group of one rank moves
nothing and counts nothing.

**Meta tensors** (a dry run on ``launch.mesh.abstract_mesh``) never reach
``torch.distributed``: each collective is counted and returns a meta
tensor of the shape the group's size implies.

On a mesh whose ranks share one card over gloo (``Mesh.host_staged``), gloo
runs an f32 all-reduce, all-gather, reduce-scatter or broadcast on the card
where it lies; every other op there (another dtype, or a point-to-point
send: gloo's transport reads host memory) is copied to host memory, run, and
copied back, explicitly, here, and counted in ``HOST_STAGED``.  The set is a
table, checked on the card's torch (2.11) one op at a time; nothing is tried
and given way on.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

# ops that gloo runs on a CUDA tensor, by dtype
GLOO_CUDA_OPS = frozenset({
    ("all_reduce", torch.float32), ("all_gather", torch.float32),
    ("reduce_scatter", torch.float32), ("broadcast", torch.float32),
})
HOST_STAGED: Counter = Counter()  # host-staged collectives by op since the last reset
# since the last reset, by (kind, group size): [calls, operand bytes, wire bytes]
COLL: Dict[Tuple[str, int], List[float]] = {}


def reset_host_staged() -> None:
    HOST_STAGED.clear()


def reset_counters() -> None:
    COLL.clear()


def _count(kind: str, t: torch.Tensor, g: int) -> None:
    """One collective of ``kind`` over ``g`` ranks whose operand is ``t``."""
    s = t.numel() * t.element_size()
    wire = {"all-gather": s * (g - 1), "reduce-scatter": s * (g - 1) / g,
            "all-reduce": 2 * s * (g - 1) / g, "collective-permute": s}[kind]
    c = COLL.setdefault((kind, g), [0, 0.0, 0.0])
    c[0] += 1
    c[1] += s
    c[2] += wire


def counters() -> dict:
    """``COLL`` summed over group sizes: ``{"by_kind": {kind: operand bytes},
    "counts": {kind: calls}, "wire": bytes, "bytes": operand bytes}``."""
    by_kind: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for (kind, _), (n, s, _w) in COLL.items():
        by_kind[kind] = by_kind.get(kind, 0.0) + s
        counts[kind] = counts.get(kind, 0) + n
    return {"by_kind": by_kind, "counts": counts,
            "wire": sum(c[2] for c in COLL.values()), "bytes": sum(by_kind.values())}


def _staged(mesh, op: str, t: torch.Tensor) -> bool:
    if not mesh.host_staged or t.device.type != "cuda":
        return False
    if (op, t.dtype) in GLOO_CUDA_OPS:
        return False
    HOST_STAGED[op] += 1
    return True


# ---------------------------------------------------------------------------
# Raw collectives (no autograd)
# ---------------------------------------------------------------------------
def all_reduce_(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """All-reduce ``t`` in place over ``axes`` (``op`` sum or max); returns it."""
    group = mesh.group(axes)
    if group is None:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _count("all-reduce", t, mesh.size(axes))
    if t.device.type == "meta":
        if not t.is_contiguous():
            raise ValueError("all_reduce_ needs a contiguous tensor")
        return t
    if _staged(mesh, "all_reduce", t):
        host = t.cpu()
        dist.all_reduce(host, op=red, group=group)
        return t.copy_(host)
    if not t.is_contiguous():
        raise ValueError("all_reduce_ needs a contiguous tensor")
    dist.all_reduce(t, op=red, group=group)
    return t


def all_reduce_max(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    return all_reduce_(t.detach().contiguous().clone(), mesh, axes, "max")


def softmax_combine(o: torch.Tensor, lse: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``softmax(l) . v`` over every rank's positions of ``axes``, from each
    rank's own: ``o`` is ``softmax(l) . v`` (f32) over this rank's positions
    and ``lse`` (``o``'s shape less its last dim) the log-sum-exp of this
    rank's logits ``l`` (masked positions at a large negative value or
    ``-inf``); the result is the softmax over all of them.

    The largest ``lse`` is taken over the group (MAX); each rank's share of
    the sum under it is ``w = exp(lse - m)``; ``o * w`` and ``w`` add up over
    the group in one f32 all-reduce (SUM), and their quotient is the whole
    softmax's product.  A rank whose positions all lie past the row's
    ``cur`` has ``w = 0`` and adds nothing.  A group of one rank holds the
    whole softmax: ``o`` comes back as it is."""
    if mesh.size(axes) == 1:
        return o
    m = all_reduce_(lse.clone(memory_format=torch.contiguous_format), mesh, axes, "max")
    w = torch.exp(lse - m)[..., None]
    packed = all_reduce_(torch.cat([(o * w).flatten(), w.flatten()]), mesh, axes)
    num, den = packed[:o.numel()].view(o.shape), packed[o.numel():].view(w.shape)
    return num / den


def all_gather_raw(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The group's chunks concatenated along ``dim``, in the group's order."""
    group = mesh.group(axes)
    if group is None:
        return t
    n = mesh.size(axes)
    src = t.contiguous()
    _count("all-gather", src, n)
    if src.device.type == "meta":
        return torch.cat([src] * n, dim=dim)
    staged = _staged(mesh, "all_gather", src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def reduce_scatter_raw(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's chunk, along ``dim``, of the sum of ``t`` over the group."""
    group = mesh.group(axes)
    if group is None:
        return t
    n, idx = mesh.size(axes), mesh.index(axes)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {n} ranks")
    _count("reduce-scatter", t, n)
    if t.device.type == "meta":
        return torch.empty_like(t.chunk(n, dim=dim)[idx], memory_format=torch.contiguous_format)
    staged = _staged(mesh, "reduce_scatter", t)
    src = t.cpu() if staged else t
    chunks = [c.contiguous() for c in src.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[idx])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(t.device) if staged else out


def _chunk(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.size(axes)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {n} ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * size, size)


def ppermute(t: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Ring shift over ``axis``: rank ``i`` sends ``t`` to ``i + shift`` and
    returns what ``i - shift`` sent (``jax.lax.ppermute`` with
    ``perm=[(i, (i + shift) % n)]``)."""
    n = mesh.size(axis)
    if n == 1:
        return t
    idx = mesh.index(axis)
    src = t.contiguous()
    _count("collective-permute", src, n)
    if src.device.type == "meta":
        return torch.empty_like(src)
    staged = _staged(mesh, "ppermute", src)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    group = mesh.group(axis)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, mesh.peer(axis, (idx + shift) % n), group),
        dist.P2POp(dist.irecv, out, mesh.peer(axis, (idx - shift) % n), group),
    ])
    for r in reqs:
        r.wait()
    return out.to(t.device) if staged else out


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad):
        ctx.mesh, ctx.axes, ctx.dim, ctx.grad = mesh, axes, dim, grad
        return all_gather_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "split":
            g = _chunk(g, ctx.mesh, ctx.axes, ctx.dim).contiguous()
        else:
            g = reduce_scatter_raw(g, ctx.mesh, ctx.axes, ctx.dim)
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.axes), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _chunk(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def all_gather(x, mesh, axes, dim: int, grad: str = "reduce_scatter"):
    if grad not in ("reduce_scatter", "split"):
        raise ValueError(f"all_gather grad {grad!r}: reduce_scatter or split")
    return x if mesh.size(axes) == 1 else _AllGather.apply(x, mesh, axes, dim, grad)


def reduce_scatter(x, mesh, axes, dim: int):
    return x if mesh.size(axes) == 1 else _ReduceScatter.apply(x, mesh, axes, dim)


def all_reduce_sum(x, mesh, axes):
    return x if mesh.size(axes) == 1 else _AllReduceSum.apply(x, mesh, axes)


def copy_to_region(x, mesh, axes):
    return x if mesh.size(axes) == 1 else _CopyToRegion.apply(x, mesh, axes)


def split(x, mesh, axes, dim: int):
    return x if mesh.size(axes) == 1 else _Split.apply(x, mesh, axes, dim)

"""The parallel context a model runs under on a mesh: which shard of every
leaf a rank holds, how a leaf is brought to the layout its use needs, and
how activations enter and leave a tensor-parallel region.

The counterpart of the JAX package's ``shard`` callback and ``moe_dist``
argument (``transformer.forward``): there XLA's partitioner inserts the
collectives that the ``PartitionSpec`` constraints imply; here each rank
holds its shards and the model calls the collectives itself.

**Leaves.**  A rank holds, of a leaf whose spec is ``ShardingRules``',
the chunk at its index along each split dimension (``shard_leaf``); a
Mamba ``in_proj`` split over ``model`` is split per half, so that each rank
holds its own ``d_inner / tp`` columns of both x and z (a contiguous split
would give rank 0 all of x).  ``ParamView.w`` brings a leaf to the layout a
use needs: a dimension split over the batch axes (FSDP, ZeRO-3) is
all-gathered on use, its backward reduce-scattering the gradient; one split
over ``model`` stays split where the use wants it split there and is
gathered otherwise; a leaf not split over ``model`` whose use's gradient
differs across the model ranks (a tensor-parallel region, or a norm on
sequence-split rows) passes ``copy_to_region``, so that its gradient is
summed over them.

**Activations.**  The residual stream between blocks is replicated over
``model`` or, under ``seq_shard`` (Megatron sequence parallelism), split
over it by sequence.  ``enter`` / ``exit`` take a block's input to the full
sequence and its output back: in a tensor-parallel region (whose ranks
compute partial sums) ``copy_to_region`` / ``all_reduce_sum``, or under
``seq_shard`` ``all_gather`` (backward reduce-scatter) / ``reduce_scatter``;
in a region every model rank computes alike, nothing, or ``all_gather``
(backward: the own chunk) / ``split``.

Gradients over the batch axes: every rank takes the gradient of its own
rows; ``reduce_batch_grads`` sums a leaf's gradient over the batch axes it
is not split on (the FSDP leaves were summed by their gather's backward).

**Decode.**  ``for_decode(batch, max_len)`` fixes a decode cell's layout:
whether its rows split over the batch axes (a batch that does not divide
there, the batch-1 long-context layout, is replicated) and the KV cache's
spec (``ShardingRules``' ``kv_cache``: heads over ``model``, or positions
over ``model`` or over the whole mesh).  ``cache_spec`` gives any cache
leaf's spec, by which ``transformer.init_cache`` allocates a rank's shard.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from repro_torch.sharding import collectives as cc
from repro_torch.sharding.rules import PartitionSpec, axes_of


# ---------------------------------------------------------------------------
# Whole leaves <-> this rank's shard
# ---------------------------------------------------------------------------
def _halves(name: str, axes: Tuple[str, ...], dim_len: int, n: int) -> bool:
    """Whether this split is ``in_proj``'s per-half split over ``model``."""
    return name == "in_proj" and axes == ("model",) and (dim_len // 2) % n == 0


def shard_leaf(full: torch.Tensor, spec, mesh, name: str = "") -> torch.Tensor:
    """This rank's shard of a whole leaf under ``spec`` (a view where it can be)."""
    t = full
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        n, idx = mesh.size(axes), mesh.index(axes)
        if t.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(full.shape)} does not split over {n}")
        if _halves(name, axes, t.shape[dim], n):
            half = t.shape[dim] // 2
            size = half // n
            t = torch.cat([t.narrow(dim, idx * size, size), t.narrow(dim, half + idx * size, size)], dim)
        else:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


def gather_leaf(local: torch.Tensor, spec, mesh, name: str = "") -> torch.Tensor:
    """``shard_leaf`` backwards: the whole leaf, on every rank (collective)."""
    t = local
    for dim in reversed(range(len(spec))):
        axes = axes_of(spec[dim])
        if not axes:
            continue
        n = mesh.size(axes)
        t = cc.all_gather_raw(t, mesh, axes, dim)
        if _halves(name, axes, t.shape[dim], n):
            # [x0 z0 | x1 z1 | ...] -> [x0 x1 ... | z0 z1 ...]
            shape = t.shape
            t = t.reshape(shape[:dim] + (n, 2, shape[dim] // (2 * n)) + shape[dim + 1:])
            t = t.transpose(dim, dim + 1).reshape(shape)
    return t


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[Tuple[str, ...], object]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _param_name(path: Tuple[str, ...]) -> str:
    """The parameter a path names (an int8 moment's ``q``/``s`` are its parts)."""
    return path[-2] if path[-1] in ("q", "s") and len(path) > 1 else path[-1]


def shard_tree(full: dict, specs: dict, mesh, device=None) -> dict:
    """Each leaf of ``full`` (torch tensors or numpy arrays) as this rank's
    shard, a contiguous copy on ``device`` (the mesh's by default; never a
    view of ``full``, which may be shared with other processes); a leaf whose
    spec is not a tuple (the optimizer's step) passes through."""
    device = device or mesh.device
    flat_s = _flatten(specs)
    out = {}
    for path, leaf in _flatten(full).items():
        spec = flat_s[path]
        if not isinstance(spec, tuple) or not hasattr(leaf, "shape"):
            out[path] = leaf
            continue
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
        out[path] = shard_leaf(t, spec, mesh, _param_name(path)).to(device, copy=True).contiguous()
    return _unflatten(out)


def gather_tree(local: dict, specs: dict, mesh) -> dict:
    """``shard_tree`` backwards: whole leaves on every rank (collective; every
    rank must call it)."""
    flat_s = _flatten(specs)
    out = {}
    for path, leaf in _flatten(local).items():
        spec = flat_s[path]
        out[path] = (gather_leaf(leaf, spec, mesh, _param_name(path))
                     if isinstance(spec, tuple) and isinstance(leaf, torch.Tensor) else leaf)
    return _unflatten(out)


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = mesh.size(axes_of(entry)) if axes_of(entry) else 1
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {n}")
        out[dim] //= n
    return tuple(out)


# ---------------------------------------------------------------------------
# The context
# ---------------------------------------------------------------------------
class ParallelContext:
    """One rank's parallel context for a model on ``mesh``.

    ``specs`` is the parameter spec tree (``ShardingRules.param_pspecs`` of
    the global shapes), ``shapes`` the global shapes, both by the parameter
    tree's nesting.  ``batch_axes``: the mesh axes the batch is split over.
    ``seq_shard``: the plan holds the residual stream sequence-split; ``seq``
    is set per forward (``for_seq``).  ``moe_ep``: the MoE MLPs run
    expert-parallel (``train_step.moe_dist_for``).  One device is the
    context of ``local``: a mesh of size 1, every leaf whole."""

    def __init__(self, mesh, specs: dict, shapes: dict, *, batch_axes=("data",),
                 seq_shard: bool = False, moe_ep: bool = False, rules=None):
        self.mesh, self.specs, self.shapes, self.rules = mesh, specs, shapes, rules
        self.seq_shard, self.moe_ep, self.seq = seq_shard, moe_ep, False
        # a decode cell's layout (``for_decode``); one device's is trivial
        self.rows_split = True
        self.kv = None if rules is not None else PartitionSpec(None, None, None, None)
        self.tp = mesh.size("model")
        self.tp_rank = mesh.index("model")
        self.batch_axes = tuple(batch_axes)
        self.dp = mesh.size(self.batch_axes)
        self.flat_specs = {".".join(p): s for p, s in _flatten(specs).items()}
        self.flat_shapes = {".".join(p): s for p, s in _flatten(shapes).items()}

    @classmethod
    def local(cls, tree: dict, device=None) -> "ParallelContext":
        """One device's context (``launch.mesh.local_mesh``) for a tree of
        tensors or of shapes; ``device`` defaults to the first tensor's."""
        from repro_torch.launch.mesh import local_mesh

        flat = _flatten(tree)
        if device is None:
            device = next((t.device for t in flat.values() if isinstance(t, torch.Tensor)), "cpu")
        shapes = {path: tuple(getattr(v, "shape", v)) for path, v in flat.items()}
        specs = {path: PartitionSpec(*(None,) * len(s)) for path, s in shapes.items()}
        return cls(local_mesh(device), _unflatten(specs), _unflatten(shapes))

    def for_seq(self, seq_len: int) -> "ParallelContext":
        """This context for a forward of ``seq_len`` tokens: the residual
        stream sequence-split over ``model`` when the plan asks for it and
        the length divides (``act_btd``'s spec)."""
        seq = bool(self.seq_shard and self.tp > 1 and seq_len % self.tp == 0)
        if seq == self.seq:
            return self
        ctx = copy.copy(self)
        ctx.seq = seq
        return ctx

    # -- decode -----------------------------------------------------------------
    def cache_spec(self, name: str, shape) -> PartitionSpec:
        """The spec of a stacked cache leaf (``k``, ``v``, ``k_s``, ``v_s``,
        ``conv``, ``ssm``) of global ``shape`` (``ShardingRules.cache_pspecs``;
        whole on one device)."""
        if self.rules is None:
            return PartitionSpec(*(None,) * len(shape))
        return self.rules.cache_pspecs({name: tuple(shape)})[name]

    def cache_local_shape(self, name: str, shape, stacked: bool = True) -> Tuple[int, ...]:
        """This rank's shape of cache leaf ``name`` of global ``shape`` (the
        period axis first where ``stacked``)."""
        full = tuple(shape) if stacked else (1,) + tuple(shape)
        local = local_shape(full, self.cache_spec(name, full), self.mesh)
        return local if stacked else local[1:]

    def for_decode(self, batch: int, max_len: int) -> "ParallelContext":
        """This context for decode cells of ``batch`` global rows over a cache
        of ``max_len`` positions: ``rows_split`` (the rows split over the
        batch axes, else every rank takes them all) and ``kv``, the spec of
        a ``(B, Hkv, L, hd)`` KV cache period."""
        if self.rules is None:
            return self
        cfg = self.rules.cfg
        ctx = copy.copy(self)
        ctx.rows_split = batch % self.dp == 0
        ctx.kv = self.rules.act_spec("kv_cache", 4, (batch, cfg.n_kv_heads, max_len,
                                                     cfg.resolved_head_dim or 1))
        return ctx

    def kv_seq_axes(self) -> Tuple[str, ...]:
        """The mesh axes the KV cache's positions are split over."""
        if self.kv is None:
            raise ValueError("decode over a mesh needs the cell's layout: ParallelContext.for_decode")
        return axes_of(self.kv[2])

    def decode_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows (dim 0) of a decode batch's tensor."""
        if not self.rows_split or self.dp == 1:
            return t
        b = t.shape[0] // self.dp
        i = self.mesh.index(self.batch_axes)
        return t[i * b:(i + 1) * b]

    def view(self, *keys: str) -> "ParamView":
        node, stacked = self.specs, bool(keys) and keys[0] == "blocks"
        for k in keys:
            node = node[k]
        return ParamView(self, node, stacked)

    # -- activations ------------------------------------------------------------
    def enter(self, x: torch.Tensor, tp: bool) -> torch.Tensor:
        """A block input in the residual layout -> its whole sequence, as the
        region's compute reads it (``tp``: its ranks compute partial sums)."""
        if self.seq:
            return cc.all_gather(x, self.mesh, "model", 1, "reduce_scatter" if tp else "split")
        return cc.copy_to_region(x, self.mesh, "model") if tp else x

    def exit(self, y: torch.Tensor, tp: bool) -> torch.Tensor:
        """A block output over the whole sequence (partial sums when ``tp``)
        -> the residual layout."""
        if self.seq:
            return (cc.reduce_scatter if tp else cc.split)(y, self.mesh, "model", 1)
        return cc.all_reduce_sum(y, self.mesh, "model") if tp else y

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's sequence rows of a whole-sequence constant (no grad)."""
        return cc._chunk(x, self.mesh, "model", 1) if self.seq else x

    # -- gradients over the batch axes ----------------------------------------
    def reduce_batch_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum each gradient (dotted path -> f32 tensor, in place) over the
        batch axes its leaf is not split on."""
        for path, g in grads.items():
            held = {a for e in self.flat_specs[path] for a in axes_of(e)}
            axes = tuple(a for a in self.batch_axes if a not in held)
            if axes and self.mesh.size(axes) > 1:
                cc.all_reduce_(g, self.mesh, axes)

    def row_axes(self, path: str) -> Tuple[str, ...]:
        """The mesh axes a leaf's last dimension is split over (an int8 row's
        amax is taken over them)."""
        return axes_of(self.flat_specs[path][-1])

    def global_shape(self, path: str) -> Tuple[int, ...]:
        return tuple(self.flat_shapes[path])

    def norm_sq(self, sums: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum over leaves of each leaf's whole sum of squares, from the
        local ones (dotted path -> 0-dim f32): a split leaf's local sums add
        over its shard group; a replicated leaf counts once.  Summed in
        the leaves' order within each shard group (so one device's norm
        adds up as a plain sum over the leaves)."""
        by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
        for path in sums:
            axes = self.mesh.key({a for e in self.flat_specs[path] for a in axes_of(e)})
            by_axes[axes] = by_axes.get(axes, 0) + sums[path]
        total = None
        for axes in sorted(by_axes):
            s = by_axes[axes].reshape(1).clone()
            if axes:
                cc.all_reduce_(s, self.mesh, axes)
            total = s if total is None else total + s
        return total[0]


def local_view(p: dict) -> "ParamView":
    """One device's view of a parameter subtree (a period's slice)."""
    return ParallelContext.local(p).view()


class ParamView:
    """The specs of one subtree of the parameters (a block's ``attn``, an
    MLP ...) under a context; ``stacked``: its leaves carry the leading
    period axis, which a period's slice has dropped."""

    def __init__(self, ctx: ParallelContext, specs: dict, stacked: bool):
        self.ctx, self.specs, self.stacked = ctx, specs, stacked

    @property
    def mesh(self):
        return self.ctx.mesh

    def sub(self, key: str) -> "ParamView":
        return ParamView(self.ctx, self.specs[key], self.stacked)

    def spec(self, name: str):
        s = self.specs[name]
        return tuple(s[1:]) if self.stacked else tuple(s)

    def on_model(self, name: str, dim: int) -> bool:
        """Whether leaf ``name``'s dimension ``dim`` is split over ``model``."""
        return axes_of(self.spec(name)[dim]) == ("model",)

    def w(self, p: dict, name: str, *, want: Optional[int] = None, tp: bool = False) -> torch.Tensor:
        """Leaf ``name`` of ``p`` as its use needs it: whole, or split over
        ``model`` along ``want`` alone (it must be stored so).  ``tp``: the
        use's gradient differs across the model ranks."""
        t, spec = p[name], self.spec(name)
        if want is not None and not self.on_model(name, want):
            raise ValueError(f"{name} is wanted split over model along dim {want}, stored {spec}")
        on_model = False
        for dim, entry in enumerate(spec):
            axes = axes_of(entry)
            if not axes:
                continue
            if "model" in axes:
                on_model = True
                if dim == want:
                    continue
                if _halves(name, axes, t.shape[dim] * self.ctx.tp, self.ctx.tp):
                    raise ValueError(f"{name}'s per-half split is only used split")
                t = cc.all_gather(t, self.mesh, axes, dim, "reduce_scatter" if tp else "split")
            else:  # FSDP over the batch axes: every rank's gradient differs
                t = cc.all_gather(t, self.mesh, axes, dim, "reduce_scatter")
        if tp and not on_model:
            t = cc.copy_to_region(t, self.mesh, "model")
        return t

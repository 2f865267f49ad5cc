"""SchedulePlan -> PartitionSpec rules for params, optimizer state,
activations, inputs and caches.

A copy of the JAX package's ``sharding/rules.py`` over the port's own
``PartitionSpec``, a tuple of per-dimension entries (``None``, an axis name,
or a tuple of axis names), equal as a tuple to JAX's.  It is pure data: the
spec of every leaf by its tree path and global shape.  Semantics:

* TP is active for a family iff ``param_strategy`` permits TP
  (``tp``/``fsdp_tp``/``tp2d``) AND the family flag (``mixer_tp``/``ffn_tp``/
  ``vocab_shard``/``moe_mode``) asks for it.
* FSDP (ZeRO-3) shards every large weight's non-TP dim over the batch axes
  (``data`` or ``pod x data``).
* An axis is only assigned when the dim divides by the axis size;
  indivisible cases stay replicated on that axis (no padding).

How a rank holds and uses its shard is ``sharding/parallel.py``'s.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.space import MeshSpec, SchedulePlan


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array: ``PartitionSpec("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axes_size(mesh: MeshSpec, axes) -> int:
    n = 1
    for a in axes_of(axes):
        n *= mesh.axis(a)
    return n


def _is_tree(x) -> bool:
    return isinstance(x, dict)


def _map_with_path(fn, tree: dict, path=()) -> dict:
    return {k: _map_with_path(fn, v, path + (k,)) if _is_tree(v) else fn(path + (k,), v)
            for k, v in tree.items()}


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's or array's ``.shape``, or the shape itself."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


class ShardingRules:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: Optional[InputShape],
        plan: SchedulePlan,
        mesh: MeshSpec,
    ):
        self.cfg = cfg
        self.shape = shape
        self.plan = plan
        self.mesh = mesh
        if plan.batch_axes == "pod_data" and mesh.multi_pod:
            self.batch = ("pod", "data")
        else:
            self.batch = ("data",)
        tp_on = plan.param_strategy in ("tp", "fsdp_tp", "tp2d")
        self.tp_mixer = tp_on and plan.mixer_tp
        self.tp_ffn = tp_on and plan.ffn_tp
        self.tp_vocab = tp_on and plan.vocab_shard
        # tp2d: inference-only 2D weight sharding (gather-on-use over the
        # batch axes), the same layout as ZeRO-3 with no optimizer state
        self.fsdp = plan.param_strategy in ("fsdp", "fsdp_tp", "tp2d")
        self.fsdp_axes: Tuple[str, ...] = self.batch if self.fsdp else ()
        self.moe_mode = plan.moe_mode if tp_on or plan.moe_mode == "dense" else "dense"

    # -- helpers ---------------------------------------------------------------
    def _fit(self, axes, dim: int):
        """axes if dim divides by their product, else None (odd vocabs like
        49155 stay unsharded)."""
        if not axes:
            return None
        if dim % _axes_size(self.mesh, axes) == 0:
            return axes if isinstance(axes, str) or len(axes) > 1 else axes[0]
        return None

    def _weight_spec(self, dims: Tuple[int, ...], tp_dim: Optional[int]) -> P:
        """Spec for one weight (without the stacked period axis)."""
        entries = [None] * len(dims)
        if tp_dim is not None:
            entries[tp_dim] = self._fit("model", dims[tp_dim])
        if self.fsdp_axes:
            # the largest remaining divisible dim gets the ZeRO shard
            cand = sorted(
                (i for i in range(len(dims)) if entries[i] is None),
                key=lambda i: -dims[i],
            )
            for i in cand:
                fit = self._fit(self.fsdp_axes, dims[i])
                if fit is not None:
                    entries[i] = fit
                    break
        return P(*entries)

    # -- params ------------------------------------------------------------------
    def param_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> P:
        stacked = path[0] == "blocks"
        dims = tuple(shape[1:] if stacked else shape)
        name = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        tp_dim: Optional[int] = None

        if name in ("norm1", "norm2", "final_norm", "conv_b", "dt_b", "Dp",
                    "dt_norm", "B_norm", "C_norm"):
            spec = P(*([None] * len(dims)))
            if name in ("conv_b", "dt_b", "Dp") and self.tp_mixer:
                spec = P(self._fit("model", dims[0]))
        elif name == "embed":
            tp = self._fit("model", dims[0]) if self.tp_vocab else None
            fs = self._fit(self.fsdp_axes, dims[1])
            spec = P(tp, fs)
        elif name == "head":
            tp = self._fit("model", dims[1]) if self.tp_vocab else None
            fs = self._fit(self.fsdp_axes, dims[0])
            spec = P(fs, tp)
        elif parent == "attn":
            if self.tp_mixer:
                tp_dim = 0 if name == "wo" else 1
            spec = self._weight_spec(dims, tp_dim)
        elif parent == "mamba":
            if self.tp_mixer:
                tp_dim = {
                    "in_proj": 1,
                    "conv_w": 1,
                    "x_proj": 0,
                    "dt_w": 1,
                    "A_log": 0,
                    "out_proj": 0,
                }.get(name)
            spec = self._weight_spec(dims, tp_dim)
        elif parent == "mlp" and len(dims) == 3:  # MoE expert weights (E, d, f)
            if self.moe_mode == "ep":
                ep = self._fit("model", dims[0])
                fs = self._fit(self.fsdp_axes, dims[2] if name != "w_down" else dims[1])
                if name == "w_down":
                    spec = P(ep, fs, None)
                else:
                    spec = P(ep, None, fs)
            elif self.moe_mode == "tp":
                tp_dim = 1 if name == "w_down" else 2
                spec = self._weight_spec(dims, tp_dim)
            else:
                spec = self._weight_spec(dims, None)
        elif parent == "mlp":
            if name == "router":
                spec = P(*([None] * len(dims)))
            else:
                if self.tp_ffn:
                    tp_dim = 0 if name == "w_down" else 1
                spec = self._weight_spec(dims, tp_dim)
        else:
            spec = self._weight_spec(dims, None)

        if stacked:
            spec = P(None, *spec)
        return spec

    def param_pspecs(self, params: dict) -> dict:
        """The spec of every leaf of a parameter tree (leaves: anything with
        a ``.shape``, or shapes)."""
        return _map_with_path(lambda path, leaf: self.param_spec(path, _shape(leaf)), params)

    def _b(self, dim: int):
        """Batch-dim entry: only shard when the dim divides (batch-1 decode
        leaves the data axis for the sequence dim instead)."""
        return self._fit(self.batch, dim)

    # -- activations ----------------------------------------------------------------
    def act_spec(self, name: str, ndim: int, shape: Tuple[int, ...]) -> Optional[P]:
        b = self._b(shape[0])
        plan = self.plan
        if name == "act_btd":
            seq = "model" if plan.seq_shard else None
            return P(b, self._fit(seq, shape[1]) if seq else None, None)
        if name == "act_bhsd":
            h = self._fit("model", shape[1]) if self.tp_mixer else None
            return P(b, h, None, None)
        if name == "act_bkvsd":
            h = self._fit("model", shape[1]) if self.tp_mixer else None
            return P(b, h, None, None)
        if name == "act_btf":
            f = self._fit("model", shape[2]) if self.tp_ffn else None
            return P(b, None, f)
        if name == "act_bti":
            i = self._fit("model", shape[2]) if self.tp_mixer else None
            return P(b, None, i)
        if name == "moe_ecd":
            if self.moe_mode == "ep":
                return P(self._fit("model", shape[0]), None, None)
            return P(None, None, None)
        if name == "moe_ecf":
            if self.moe_mode == "ep":
                return P(self._fit("model", shape[0]), None, None)
            if self.moe_mode == "tp":
                return P(None, None, self._fit("model", shape[2]))
            return P(None, None, None)
        if name == "logits":
            v = self._fit("model", shape[-1]) if self.tp_vocab else None
            return P(*([b] + [None] * (ndim - 2) + [v]))
        if name == "kv_cache":
            h = self._fit("model", shape[1]) if self.tp_mixer else None
            if plan.seq_shard and b is None:
                # batch-1 long-context: the whole mesh shards the sequence
                axes = tuple(self.batch) + ("model",) if h is None else self.batch
                return P(None, h, self._fit(axes, shape[2]), None)
            if h is None and plan.seq_shard:
                return P(b, None, self._fit("model", shape[2]), None)
            return P(b, h, None, None)
        return None

    # -- inputs / cache ---------------------------------------------------------------
    def batch_spec(self, ndim: int, batch_dim: Optional[int] = None) -> P:
        b = self._b(batch_dim if batch_dim is not None else self.shape.global_batch)
        return P(*([b] + [None] * (ndim - 1)))

    def cache_pspecs(self, cache: dict) -> dict:
        """Stacked caches: leading period axis, then (B, ...)."""

        def f(path, leaf):
            shape = _shape(leaf)
            name = path[-1]
            if name in ("k", "v", "k_s", "v_s"):
                inner = self.act_spec("kv_cache", len(shape) - 1, shape[1:])
                return P(None, *inner)
            # mamba conv/ssm states: shard batch; d_inner over model if TP
            b = self._b(shape[1])
            if name == "ssm":
                di = self._fit("model", shape[2]) if self.tp_mixer else None
                return P(None, b, di, None)
            if name == "conv":
                di = self._fit("model", shape[3]) if self.tp_mixer else None
                return P(None, b, None, di)
            return P(*([None] * len(shape)))

        return _map_with_path(f, cache)

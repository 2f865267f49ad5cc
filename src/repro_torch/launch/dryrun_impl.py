"""The production-mesh dry run: one rank's step on the meta device, counted.

The counterpart of the JAX package's ``launch/dryrun_impl.py``.  There, a
cell's sharded train, prefill or decode step is lowered and compiled for
512 placeholder TPU devices and its roofline record read out of XLA's
cost analysis and HLO (``core/hlo_analysis.py``).  Here the port's own step
(``make_train_step`` / ``make_prefill_step`` / ``make_serve_step``) is
built for one rank of the mesh (``launch.mesh.abstract_mesh``: the rank's
coordinates, every axis set's size, no process group) and run once on the
``meta`` device: nothing is allocated and nothing launched, and torch's own
counters say what the rank would do:

* ``FlopCounterMode`` over the step: the aten products (``aten_flops``);
* each hand kernel's meta branch (``kernels/work.py``'s ``DRY``): its
  launches where the card would launch it, by ``ops.COUNTERS``' names, its
  work by the formulas of ``PERF.md`` section 6, and the products its plain
  version would run;
* ``sharding/collectives.COLL``: each collective's bytes by kind, in the
  ring formulas of the JAX package's HLO analysis;
* ``LiveBytes``, a ``TorchDispatchMode`` that follows each output's storage
  until it dies (saved tensors and those under ``checkpoint`` included),
  rounded to the caching allocator's 512-byte blocks, for the peak; and
  the operand and output bytes of every aten op that is not a view.

The record has the reference's fields, its terms from the port's
``core.measure.combine_terms`` at the mesh's size:

* ``flops_per_device``: what the card runs, the aten products and the
  kernels' own work; ``dot_flops_per_device``: the reference's count, the
  aten products and the kernels' plain products (its ``flops_per_device``
  counts XLA's ``dot``s, with no kernel inside);
* ``hbm_bytes_total``: the aten ops' operand and output bytes (what eager
  mode moves) and the kernels' bytes, over every chip;
* ``coll_bytes_per_chip``, ``coll_wire_bytes_per_chip``, ``coll_by_kind``
  and ``coll_counts``;
* ``memory``: the parameters', optimizer state's, cache's and batch's
  bytes (``resident_bytes``) and ``peak_bytes``; ``bytes_per_device`` (the
  peak) and ``fits_hbm``; ``launches`` by kernel;
* ``model_flops``, ``useful_flops_ratio``, ``mfu``, ``chips``, the terms,
  ``step_s`` and ``dominant``; ``source``: ``"dryrun"``.

A dry run is never a time reading: its ``step_s`` is the roofline of what
it counted, and a card's measurement (mesh ``card``, ``launch/measure.py``)
is never replaced by one.  It runs the full config at full depth (meta
costs nothing); a tile the card cannot launch raises here as it would
there, the counterpart of an XLA compile failure.
"""
from __future__ import annotations

import time
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.hardware import get_hardware
from repro_torch.core.measure import combine_terms
from repro_torch.core.space import MeshSpec, SchedulePlan, get_mesh
from repro_torch.kernels import ops, work
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import transformer
from repro_torch.sharding import collectives as cc
from repro_torch.training import optimizer as optim
from repro_torch.training.train_step import (
    make_positions, make_prefill_step, make_serve_step, make_train_step,
)

BLOCK = 512  # the caching allocator's rounding of a block
# ops that move no data: allocations of uninitialised memory and shape changes
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "_unsafe_view", "lift_fresh")


def _block_bytes(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LiveBytes(TorchDispatchMode):
    """The bytes held by live storages (each rounded up to ``BLOCK``) and their
    peak, and the bytes every aten op that is not a view reads and writes.

    ``hold`` registers tensors made before the mode (the resident state); an
    op's output whose storage is new is added until that storage dies."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.traffic = 0.0
        self._held: Dict[int, int] = {}

    def hold(self, tensors) -> None:
        for t in tensors:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = _block_bytes(st.nbytes())
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.__name__.split(".")[0] not in _NO_TRAFFIC:
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.traffic += _nbytes(t)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def _inputs(cfg: ModelConfig, rows: int, seq: int) -> torch.Tensor:
    """The step's ``inputs`` on meta: token ids, or an embeddings arch's
    ``(rows, seq, d)`` vectors in the model dtype."""
    if cfg.input_kind == "tokens":
        return torch.empty((rows, seq), dtype=torch.long, device="meta")
    return torch.empty((rows, seq, cfg.d_model), dtype=getattr(torch, cfg.dtype), device="meta")


def build(cfg: ModelConfig, shape: InputShape, plan: SchedulePlan, mesh=None):
    """``(run, state)`` of one rank's step on meta: ``run()`` takes the step
    once; ``state`` holds its resident trees (``params``, ``opt``,
    ``batch``, ``cache``).  ``mesh`` (``abstract_mesh``): that rank's step;
    None: one device's (mesh ``card``)."""
    kind, B, S = shape.kind, shape.global_batch, shape.seq_len
    state: Dict[str, object] = {"opt": {}, "batch": {}, "cache": {}}
    if kind == "train":
        oc = optim.OptimizerConfig(peak_lr=0.0, moment_dtype=plan.opt_dtype)
        step = make_train_step(cfg, shape, plan, oc, mesh=mesh, device="meta")
        params = transformer.meta_params(cfg, step.par if mesh is not None else None)
        state["opt"] = optim.init_opt_state(params, oc, step.par)
        state["batch"] = {"inputs": _inputs(cfg, B, S),
                          "labels": torch.empty((B, S), dtype=torch.long, device="meta"),
                          "positions": make_positions(cfg, B, S, device="meta")}

        def run():
            step(params, state["opt"], state["batch"])
    elif kind == "prefill":
        step = make_prefill_step(cfg, shape, plan, mesh=mesh, device="meta")
        params = transformer.meta_params(cfg, step.par if mesh is not None else None)
        state["batch"] = {"inputs": _inputs(cfg, B, S),
                          "positions": make_positions(cfg, B, S, device="meta")}

        def run():
            step(params, state["batch"])
    else:
        step = make_serve_step(cfg, shape, plan, mesh=mesh, device="meta")
        params = transformer.meta_params(cfg, step.par if mesh is not None else None)
        state["cache"] = transformer.init_cache(cfg, B, S, plan.kv_dtype, device="meta",
                                                par=step.par if mesh is not None else None)
        state["batch"] = {"inputs": _inputs(cfg, B, 1)}

        def run():
            step(params, state["cache"], state["batch"]["inputs"], S - 1)
    state["params"] = params
    return run, state


def count(run, state) -> dict:
    """Run ``run`` once under every counter (module docstring) and return
    what they read."""
    work.DRY.reset()
    cc.reset_counters()
    tracker = LiveBytes()
    flops = FlopCounterMode(display=False)
    tracker.hold(_tensors([state[k] for k in ("params", "opt", "batch", "cache")]))
    with tracker, flops:
        run()
    coll = cc.counters()
    return {
        "aten_flops": flops.get_total_flops(),
        "kernel_flops": sum(work.DRY.flops.values()),
        "kernel_bytes": sum(work.DRY.bytes.values()),
        "plain_flops": sum(work.DRY.plain_flops.values()),
        "aten_bytes": tracker.traffic,
        "peak_bytes": tracker.peak,
        "launches": {name: work.DRY.launches.get(name, 0) for name in ops.COUNTERS},
        "coll": coll,
    }


def dry_run(cfg: ModelConfig, shape: InputShape, plan: SchedulePlan, mspec: MeshSpec, *,
            hw="h100", rank: int = 0, local: bool = False) -> dict:
    """The record of rank ``rank``'s step of ``cfg`` x ``shape`` under
    ``plan`` on ``mspec`` (module docstring); ``local``: one device's step
    (mesh ``card``, no mesh), as the card's measurement runs it."""
    spec = get_hardware(hw)
    mesh = None if local else abstract_mesh(mspec, rank)
    chips = 1 if local else mspec.size
    t0 = time.perf_counter()
    run, state = build(cfg, shape, plan, mesh)
    c = count(run, state)
    seconds = time.perf_counter() - t0
    flops_dev = c["aten_flops"] + c["kernel_flops"]
    hbm_dev = c["aten_bytes"] + c["kernel_bytes"]
    coll = c["coll"]
    terms = combine_terms(flops_dev * chips, hbm_dev * chips, coll["bytes"], chips, plan.overlap,
                          hw=spec)
    n_active = cfg.active_param_count()
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * shape.tokens
    memory = {"params_bytes": _bytes(state["params"]), "opt_state_bytes": _bytes(state["opt"]),
              "cache_bytes": _bytes(state["cache"]), "batch_bytes": _bytes(state["batch"])}
    memory["resident_bytes"] = sum(memory.values())
    memory["peak_bytes"] = c["peak_bytes"]
    return {
        **terms,
        "dominant": max(("compute", "memory", "collective"), key=lambda k: terms[k + "_s"]),
        "flops_per_device": flops_dev,
        "dot_flops_per_device": c["aten_flops"] + c["plain_flops"],
        "aten_flops_per_device": c["aten_flops"],
        "kernel_flops_per_device": c["kernel_flops"],
        "flops_total": flops_dev * chips,
        "hbm_bytes_total": hbm_dev * chips,
        "coll_bytes_per_chip": coll["bytes"],
        "coll_wire_bytes_per_chip": coll["wire"],
        "coll_by_kind": coll["by_kind"],
        "coll_counts": coll["counts"],
        "memory": memory,
        "bytes_per_device": c["peak_bytes"],
        "fits_hbm": bool(c["peak_bytes"] <= spec.hbm_bytes),
        "launches": c["launches"],
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / (flops_dev * chips) if flops_dev else 0.0,
        "mfu": model_flops / (terms["step_s"] * chips * spec.peak_flops),
        "chips": chips,
        "rank": rank,
        "hw": spec.name,
        "source": "dryrun",
        "dryrun_s": seconds,
    }


def evaluate_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str = "single",
    plan: Optional[SchedulePlan] = None,
    *,
    hw: str = "h100",
    rank: int = 0,
    verbose: bool = True,
) -> dict:
    """The dry-run record of one (arch x shape x mesh) cell at the full config
    (mesh ``card``: one device's step), for ``plan`` or the space's
    default plan."""
    from repro_torch.launch.measure import default_plan

    cfg, shape = get_config(arch), get_shape(shape_name)
    spec = get_hardware(hw)
    mspec = get_mesh(spec, mesh_kind)
    if plan is None:
        plan = default_plan(cfg, shape, mspec, spec)
    record = dry_run(cfg, shape, plan, mspec, hw=spec, rank=rank, local=mesh_kind == "card")
    record.update(arch=arch, shape=shape_name, mesh=mesh_kind, plan=plan.to_dict())
    if verbose:
        mem = record["memory"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind} ({spec.name}, {record['chips']} chips, "
              f"rank {rank}) in {record['dryrun_s']:.1f} s | resident {mem['resident_bytes'] / 2**30:.2f} "
              f"GiB, peak {mem['peak_bytes'] / 2**30:.2f} GiB (fits: {record['fits_hbm']}) | "
              f"flops/device {record['flops_per_device']:.4g} | coll bytes/device "
              f"{record['coll_bytes_per_chip']:.4g}", flush=True)
        print(f"[dryrun]   terms: compute {record['compute_s'] * 1e3:.3f} ms, memory "
              f"{record['memory_s'] * 1e3:.3f} ms, collective {record['collective_s'] * 1e3:.3f} ms "
              f"-> step {record['step_s'] * 1e3:.3f} ms (dominant: {record['dominant']}, "
              f"MFU {record['mfu']:.3f})", flush=True)
    return record


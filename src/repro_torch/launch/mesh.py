"""Meshes over ``torch.distributed`` process groups.

The counterpart of the JAX package's ``launch/mesh.py``.  Where a JAX mesh
is an array of devices that one program partitions over, a port mesh is one
process per rank (explicit SPMD): each rank knows its coordinate on every
axis and holds one process group per axis and per axis tuple (``("pod",
"data")``), over which the collectives of ``sharding/collectives.py`` run.
Ranks are laid out row-major over the axes, as ``np.reshape`` lays devices
out for a JAX mesh, so a tuple's group orders its members as JAX's tiled
collectives do.

Backends: NCCL when each rank has a card of its own; ``gloo`` on the CPU;
and, only when the caller passes ``share_card=True``, ``gloo`` with every
rank on ``cuda:0`` (the ranks share the one card; ``sharding/collectives.py``
stages through host memory what gloo cannot run on the card).  With fewer
cards than ranks and no ``share_card``, ``make_mesh_from_spec`` raises.

``run_on_mesh`` spawns the ranks of a mesh on this machine and rendezvous
them through a ``file://`` store in a temporary directory (no TCP port to
contend for), playing the part of JAX's forced host devices.

``local_mesh`` is one device as a mesh of size 1 with no process group:
the one-device steps run the same code as a mesh's ranks, every collective
the identity.

``abstract_mesh`` is one rank of a mesh with no process group at all, on
the ``meta`` device: the dry run (``launch/dryrun_impl.py``) runs that
rank's step on it, each collective counted and shaped without being run
(``sharding/collectives.py``).

Nothing here initialises a device or a process group at import.
"""
from __future__ import annotations

import dataclasses
import itertools
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.space import H100_NODE, H100_TWO_NODES, ONE_CARD, MeshSpec
from repro_torch.device import resolve_device

TIMEOUT_S = 600  # a collective that waits longer than this raises


def mesh_spec(multi_pod: bool = False) -> MeshSpec:
    """The production mesh on the H100: one 8-card NVLink node (``single``),
    or two across InfiniBand (``multi``)."""
    return H100_TWO_NODES if multi_pod else H100_NODE


@dataclasses.dataclass
class Mesh:
    """This rank's view of a mesh: its coordinate, its device and one process
    group for every non-empty set of axes (``None`` where the set's size is
    1, where every collective is the identity)."""

    spec: MeshSpec
    rank: int
    device: torch.device
    backend: str
    groups: Dict[Tuple[str, ...], Optional[dist.ProcessGroup]]

    @property
    def coords(self) -> Tuple[int, ...]:
        out, r = [], self.rank
        for size in reversed(self.spec.shape):
            out.append(r % size)
            r //= size
        return tuple(reversed(out))

    def key(self, axes) -> Tuple[str, ...]:
        """An axis name or tuple as a tuple in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.spec.names)
        if unknown:
            raise KeyError(f"mesh {self.spec.names} has no axes {sorted(unknown)}")
        return tuple(a for a in self.spec.names if a in axes)

    def size(self, axes) -> int:
        n = 1
        for a in self.key(axes):
            n *= self.spec.axis(a)
        return n

    def index(self, axes) -> int:
        """This rank's index in the group over ``axes`` (row-major over them)."""
        idx, coords = 0, dict(zip(self.spec.names, self.coords))
        for a in self.key(axes):
            idx = idx * self.spec.axis(a) + coords[a]
        return idx

    def group(self, axes) -> Optional[dist.ProcessGroup]:
        return self.groups[self.key(axes)] if self.key(axes) else None

    def peer(self, axes, index: int) -> int:
        """The global rank at ``index`` of this rank's group over ``axes``."""
        names, coords = self.spec.names, list(self.coords)
        for a in reversed(self.key(axes)):
            coords[names.index(a)] = index % self.spec.axis(a)
            index //= self.spec.axis(a)
        rank = 0
        for c, size in zip(coords, self.spec.shape):
            rank = rank * size + c
        return rank

    @property
    def host_staged(self) -> bool:
        """Whether collectives over gloo see tensors on the card."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _backend(spec: MeshSpec, device: str, share_card: bool) -> str:
    if torch.device(device).type == "cpu":
        return "gloo"
    cards = torch.cuda.device_count()
    if cards >= spec.size:
        return "nccl"
    if not share_card:
        raise RuntimeError(
            f"mesh {spec.names}={spec.shape} needs {spec.size} cards, this machine has {cards}; "
            "pass share_card=True to run its ranks on one card over gloo"
        )
    return "gloo"


def _axis_sets(spec: MeshSpec):
    names = spec.names
    for n in range(1, len(names) + 1):
        yield from itertools.combinations(names, n)


def local_mesh(device="cuda") -> Mesh:
    """One device as a mesh of size 1 (``ONE_CARD``): no process group."""
    return Mesh(ONE_CARD, 0, torch.device(device), "local", {a: None for a in _axis_sets(ONE_CARD)})


class AbstractGroup:
    """The group of an axis set on an abstract mesh: no process behind it."""

    def __init__(self, axes: Tuple[str, ...], size: int):
        self.axes, self.size = axes, size

    def __repr__(self) -> str:
        return f"AbstractGroup({self.axes}, size={self.size})"


def abstract_mesh(spec: MeshSpec, rank: int = 0) -> Mesh:
    """Rank ``rank`` of ``spec`` with no process group, on the meta device:
    its coordinates and every axis set's size are the mesh's, and a set of
    more than one rank has an ``AbstractGroup``, which only a meta tensor's
    collective may meet."""
    if not 0 <= rank < spec.size:
        raise ValueError(f"rank {rank} of a mesh of {spec.size}")
    probe = Mesh(spec, rank, torch.device("meta"), "abstract", {})
    groups = {a: AbstractGroup(a, probe.size(a)) if probe.size(a) > 1 else None
              for a in _axis_sets(spec)}
    return Mesh(spec, rank, torch.device("meta"), "abstract", groups)


def make_mesh_from_spec(
    spec: MeshSpec,
    device="cuda",
    share_card: bool = False,
    *,
    rank: Optional[int] = None,
    init_method: Optional[str] = None,
) -> Mesh:
    """This rank's ``Mesh`` over ``spec``.  Initialises the default process
    group if it is not yet (``init_method`` and ``rank``, or the ``env://``
    variables a launcher such as ``torchrun`` sets), then makes every axis
    set's group; every rank must call it, in the same order."""
    backend = _backend(spec, device, share_card)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=-1 if rank is None else rank,
            world_size=spec.size, timeout=timedelta(seconds=TIMEOUT_S),
        )
    if dist.get_world_size() != spec.size:
        raise ValueError(f"mesh of {spec.size} ranks over a process group of {dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"process group backend {dist.get_backend()!r}, the mesh needs {backend!r}")
    me = dist.get_rank()
    if torch.device(device).type == "cpu":
        dev = resolve_device("cpu")
    else:
        dev = resolve_device(f"cuda:{0 if backend == 'gloo' else me % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
    probe = Mesh(spec, me, dev, backend, {})
    groups: Dict[Tuple[str, ...], Optional[dist.ProcessGroup]] = {}
    for axes in _axis_sets(spec):
        size = probe.size(axes)
        if size == 1:
            groups[axes] = None
            continue
        mine = None
        # every group of this axis set, in the same order on every rank
        others = [a for a in spec.names if a not in axes]
        for fixed in itertools.product(*(range(spec.axis(a)) for a in others)):
            base = dict(zip(others, fixed))
            ranks = []
            for free in itertools.product(*(range(spec.axis(a)) for a in axes)):
                coords = {**base, **dict(zip(axes, free))}
                r = 0
                for a in spec.names:
                    r = r * spec.axis(a) + coords[a]
                ranks.append(r)
            g = dist.new_group(ranks, timeout=timedelta(seconds=TIMEOUT_S))
            if me in ranks:
                mine = g
        groups[axes] = mine
    return Mesh(spec, me, dev, backend, groups)


def make_production_mesh(*, multi_pod: bool = False, device="cuda", share_card: bool = False) -> Mesh:
    return make_mesh_from_spec(mesh_spec(multi_pod), device=device, share_card=share_card)


# ---------------------------------------------------------------------------
# Spawning the ranks of a mesh on this machine
# ---------------------------------------------------------------------------
def _rank_main(rank, spec, device, share_card, init_method, fn, args, results) -> None:
    torch.set_num_threads(1)
    try:
        mesh = make_mesh_from_spec(spec, device, share_card, rank=rank, init_method=init_method)
        out = fn(mesh, *args)
        dist.barrier()
        # pickled whole here: a tensor put on the queue as it is would be
        # shared through this process's memory, which ends with it
        results.put((rank, "ok", pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_on_mesh(spec: MeshSpec, fn: Callable, *args, device="cuda", share_card: bool = False,
                timeout: float = TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on every rank of ``spec``, one spawned process
    each, and return the ranks' results in rank order.  ``fn`` and ``args``
    cross to the ranks by pickling (``fn`` by its import path).  A rank that
    raises, or a run longer than ``timeout`` seconds, stops every rank and
    raises here with the rank's traceback."""
    _backend(spec, device, share_card)  # refuse before spawning anything
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, spec, device, share_card, init, fn, args, results))
                 for r in range(spec.size)]
        for p in procs:
            p.start()
        out, deadline, ok = {}, time.monotonic() + timeout, False
        try:
            while len(out) < spec.size:
                try:
                    rank, status, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"mesh rank exited with code {dead[0].exitcode}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"mesh run passed {timeout} s") from None
                    continue
                if status == "error":
                    raise RuntimeError(f"mesh rank {rank} raised:\n{value}")
                out[rank] = pickle.loads(value)
            ok = True
        finally:
            for p in procs:  # a failed run's other ranks may wait in a collective: stop them
                p.join(timeout=30 if ok else 0.1)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [out[r] for r in range(spec.size)]

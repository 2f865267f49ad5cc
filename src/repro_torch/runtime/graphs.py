"""The one-card decode step as a CUDA graph: captured once, then replayed.

A decode step issues thousands of small launches, and issuing them takes the
host longer than the card takes to run them.  ``StepGraphs`` wraps a step
``(params, cache, inputs, cur, commit) -> logits`` whose tensors lie on one
CUDA device.  The first call with a new key runs the step as it is (which
builds the kernels and warms cuBLAS and the allocator); the second captures
it in a ``torch.cuda.CUDAGraph`` on a side stream and replays the graph once;
every later call copies ``inputs``, ``cur`` and ``commit`` into the graph's
static buffers and replays it.  A capture runs nothing, so every call
advances the cache, and any recurrent state in it, exactly once.  The logits
come back as a fresh tensor: the next replay does not overwrite them.

A graph's key is what its launches read as fixed: the shapes, dtypes and
devices of ``inputs``, ``cur`` and ``commit`` (or its absence), and the
address, shape and dtype of every tensor of ``params`` and ``cache``.  A
changed key captures again.  At most ``MAX_GRAPHS`` graphs are kept (the
serving engine's commit / no-commit pair, with room), the least recently
used dropped first.  They share one memory pool: a graph's temporaries may
overlay another's output, which is why each replay's logits are copied out
at once.

Launch counters (``kernels.ops.COUNTERS``): the launches a capture records
are kept as the graph's, not counted as run, and each replay adds them, so
a replayed call counts as the call it stands for.

Spans (``runtime.tracing``): ``serve_step.capture`` and ``serve_step.replay``
inside ``serve_step``.  During a replay the host runs none of the step's
code, so none of its own spans (``decode.*``, ``attn.*``, ``moe.*``,
``mamba.*``) is entered.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Iterator, Optional, Set, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.runtime import tracing

CAPTURE = tracing.ROOT + ".capture"
REPLAY = tracing.ROOT + ".replay"
MAX_GRAPHS = 4


def _tensors(tree: dict) -> Iterator[torch.Tensor]:
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def _signature(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


def key(params, cache, inputs, cur, commit) -> tuple:
    """What a graph of the step fixes at its capture (see the module's docstring)."""
    leaves = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                   for tree in (params, cache) for t in _tensors(tree))
    return _signature(inputs), _signature(cur), _signature(commit), leaves


def _keep(table: OrderedDict, k, v) -> None:
    table[k] = v
    table.move_to_end(k)
    while len(table) > MAX_GRAPHS:
        table.popitem(last=False)


class _Graph:
    """One captured step: its static inputs and output, and the launches it holds."""

    def __init__(self, fn: Callable, params, cache, inputs, cur, commit, pool):
        self.inputs, self.cur = inputs.clone(), cur.clone()
        self.commit = None if commit is None else commit.clone()
        self.graph = torch.cuda.CUDAGraph()
        outside = {name: (c.count, c.tiles) for name, c in ops.COUNTERS.items()}
        for c in ops.COUNTERS.values():
            c.count, c.tiles = 0, set()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.logits = fn(params, cache, self.inputs, self.cur, self.commit)
        finally:
            self.launches: Dict[str, Tuple[int, Set]] = {
                name: (c.count, c.tiles) for name, c in ops.COUNTERS.items() if c.count}
            for name, c in ops.COUNTERS.items():
                c.count, c.tiles = outside[name]

    def replay(self, inputs, cur, commit) -> torch.Tensor:
        self.inputs.copy_(inputs)
        self.cur.copy_(cur)
        if commit is not None:
            self.commit.copy_(commit)
        self.graph.replay()
        for name, (count, tiles) in self.launches.items():
            c = ops.COUNTERS[name]
            c.count += count
            c.tiles |= tiles
        return self.logits.clone()


class StepGraphs:
    """``fn`` called through CUDA graphs, one a key (see the module's docstring)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.seen: "OrderedDict[tuple, None]" = OrderedDict()  # run once, not captured yet
        self.pool = None

    def __call__(self, params, cache, inputs, cur, commit=None) -> torch.Tensor:
        k = key(params, cache, inputs, cur, commit)
        graph = self.graphs.get(k)
        if graph is None:
            if k not in self.seen:
                _keep(self.seen, k, None)
                return self.fn(params, cache, inputs, cur, commit)
            del self.seen[k]
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            with tracing.span(CAPTURE):
                graph = _Graph(self.fn, params, cache, inputs, cur, commit, self.pool)
            _keep(self.graphs, k, graph)
        else:
            self.graphs.move_to_end(k)
        with tracing.span(REPLAY):
            return graph.replay(inputs, cur, commit)

"""The traced window: ``torch.profiler`` over it, reduced to what the metrics read.

``profiled(fn)`` runs ``fn`` under the profiler (host and device activity)
and returns a ``Summary``: the window's length on the host clock, the
seconds in which some operation ran on the device (the union of the device
events' intervals), each device operation's total seconds by name, and the
``breakdown`` the result line carries: the ten device operations that took
the most time, and the idle gaps of the device summed by what the host was
doing then -- the innermost of the benchmark's own spans (``step``,
``tokens_to_host`` ...) with the innermost host operation beneath it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

TOP = 10
GAPS_NAMED = 500  # the longest gaps looked up by host activity


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: Dict[str, float]  # name -> seconds
    idle_gaps: List[Tuple[str, float]]  # by host activity, longest first
    n_device_events: int

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [list(g) for g in self.idle_gaps[:TOP]]}


def merge(spans: np.ndarray) -> np.ndarray:
    """The union of ``(start, end)`` intervals, sorted, as disjoint intervals."""
    if not len(spans):
        return spans.reshape(0, 2)
    spans = spans[np.argsort(spans[:, 0])]
    ends = np.maximum.accumulate(spans[:, 1])
    new = np.ones(len(spans), dtype=bool)
    new[1:] = spans[1:, 0] > ends[:-1]
    starts = spans[new, 0]
    last = np.append(np.nonzero(new)[0][1:] - 1, len(spans) - 1)
    return np.stack([starts, ends[last]], axis=1)


def summarize(device: List[Tuple[str, int, int]], host: List[Tuple[str, int, int, bool]],
              window_s: float) -> Summary:
    """``device``: (name, start ns, end ns) of every device event;
    ``host``: (name, start ns, end ns, is one of the benchmark's spans)."""
    if not device:
        raise RuntimeError("the profiler recorded no device activity in the traced window")
    ops: Dict[str, float] = defaultdict(float)
    for name, s, e in device:
        ops[name] += (e - s) * 1e-9
    busy = merge(np.array([(s, e) for _, s, e in device], dtype=np.int64))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
    gaps = np.stack([busy[:-1, 1], busy[1:, 0]], axis=1) if len(busy) > 1 else np.zeros((0, 2), np.int64)
    if host:
        first = min(s for _, s, _, _ in host)
        if first < busy[0, 0]:
            gaps = np.concatenate([[[first, busy[0, 0]]], gaps])
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:GAPS_NAMED]
    named: Dict[str, float] = defaultdict(float)
    hs = np.array([s for _, s, _, _ in host], dtype=np.int64)
    he = np.array([e for _, _, e, _ in host], dtype=np.int64)
    span = np.array([u for _, _, _, u in host], dtype=bool)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        active = np.nonzero((hs <= mid) & (he >= mid))[0]
        outer = [i for i in active if span[i]]
        inner = [i for i in active if not span[i]]
        parts = [host[min(ix, key=lambda i: he[i] - hs[i])][0] for ix in (outer, inner) if ix]
        named["/".join(parts) or "no host operation"] += (g1 - g0) * 1e-9
    return Summary(window_s=window_s, busy_s=busy_s, device_ops=dict(ops),
                   idle_gaps=sorted(named.items(), key=lambda kv: -kv[1]), n_device_events=len(device))


def profiled(fn: Callable[[], None]) -> Summary:
    """Run ``fn`` (which ends in a device synchronize) under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        window_s = time.perf_counter() - t0
    device, host = [], []
    # the profiler's raw events: ``prof.events()`` builds a Python object an
    # operation first, which costs seconds over a long window
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append((e.name(), e.start_ns(), e.end_ns(), e.is_user_annotation()))
        elif not e.is_user_annotation():  # a span's copy on the device's timeline is no operation
            device.append((e.name(), e.start_ns(), e.end_ns()))
    return summarize(device, host, window_s)

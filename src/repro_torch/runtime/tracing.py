"""Spans of the port's own layers, recorded into ``torch.profiler``'s trace.

``span(name)`` marks one call of a layer.  While ``torch.profiler`` records,
and only then, it enters ``torch.profiler.record_function(name)``, so the
span lands in the profiler's trace beside the device's operations, and it
keeps a ``Span`` in this module's list.  The list's times are
``time.time_ns()``, the epoch nanoseconds that the profiler's events carry,
so a span here and its copy in the trace share one clock; its stamps are
taken just outside its ``record_function``, so they enclose the copy.  While the
profiler is off, ``span`` returns one shared no-op context: a flag read, no
allocation and no ``record_function`` call (which costs microseconds even
with the profiler off).

A span named ``sync.<site>`` marks a place where the host waits for the
device, and carries as ``waits`` how many times it waits there (a read of a
device value to the host each).  ``serve_step`` is the root of a decode
step: the spans inside one carry its sequence number as ``step``.

``spans()`` returns the list, ``summary()`` each name's count, total and
self time, and ``reset()`` empties it (``kernels.ops.reset_counters`` calls
it with the launch counters, between steps: a span open across a reset
would write into the emptied list).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch.autograd import profiler as _profiler

ROOT = "serve_step"
SYNC = "sync."


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns()
    end_ns: Optional[int]  # None while the span is open
    parent: Optional[int]  # index in the list of the enclosing span
    step: Optional[int]  # sequence number of the enclosing ``serve_step``
    waits: int = 0  # times the host waits for the device inside (``sync.*`` spans)


class Stat(NamedTuple):
    count: int
    total_ns: int
    self_ns: int  # total less the union of the direct children's intervals


_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_spans: List[Span] = []  # in order of start
_roots = 0  # ``serve_step`` spans begun since the last reset
_open = threading.local()  # each thread's open spans, innermost last


def recording() -> bool:
    """Whether ``torch.profiler`` records now (the flag its ``profile`` sets
    on entry and clears on exit)."""
    return _profiler._is_profiler_enabled


class _Recorded:
    __slots__ = ("name", "waits", "index", "step", "annotation")

    def __init__(self, name: str, waits: int):
        self.name, self.waits = name, waits

    def __enter__(self):
        global _roots
        stack = _open.__dict__.setdefault("stack", [])
        with _lock:
            outer = stack[-1] if stack else None
            step = outer.step if outer else None
            if self.name == ROOT:
                step, _roots = _roots, _roots + 1
            self.index, self.step = len(_spans), step
            parent = outer.index if outer else None
            _spans.append(Span(self.name, time.time_ns(), None, parent, step, self.waits))
        stack.append(self)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        end = time.time_ns()
        _open.stack.pop()
        with _lock:
            _spans[self.index] = _spans[self.index]._replace(end_ns=end)
        return False


def span(name: str, waits: int = 0):
    """A context that records ``name`` while the profiler records; ``waits``
    is how many times the host waits for the device inside it."""
    if not recording():
        return _NOOP
    return _Recorded(name, waits)


def spans() -> List[Span]:
    """The spans since the last reset, in order of start."""
    return list(_spans)


def reset() -> None:
    global _roots
    with _lock:
        _spans.clear()
        _roots = 0


def summary(recorded: Optional[Sequence[Span]] = None) -> Dict[str, Stat]:
    """Count, total and self nanoseconds of each span name over the closed
    spans of ``recorded`` (a list whose ``parent`` fields index it; this
    module's list by default)."""
    recorded = spans() if recorded is None else recorded
    children: Dict[int, List[Span]] = {}
    for s in recorded:
        if s.parent is not None and s.end_ns is not None:
            children.setdefault(s.parent, []).append(s)
    out: Dict[str, Stat] = {}
    for i, s in enumerate(recorded):
        if s.end_ns is None:
            continue
        covered, reach = 0, s.start_ns
        for c in sorted(children.get(i, ()), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, reach), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                reach = hi
        n, total, own = out.get(s.name, (0, 0, 0))
        out[s.name] = Stat(n + 1, total + s.end_ns - s.start_ns, own + s.end_ns - s.start_ns - covered)
    return out

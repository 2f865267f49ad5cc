"""Shared-memory transposition-cache log: cross-process cache hits with
zero export traffic.

The ``TranspositionCache`` hot tables are insertion-ordered, append-only
dicts in analytic mode — every entry is an exact pure-memo value keyed by
an action-index tuple.  The pinned-worker pool (``engine/workers.py``)
used to ship each worker "everything since your last watermark" as a
pickled dict every round (``export_since``/``apply_export``).  This module
replaces that transport for the pure-analytic path with a
``multiprocessing.shared_memory`` segment holding the same entries as
FLAT ARRAYS — fixed-width int32 key rows (action tuples, length column
alongside), a table-kind column (terminal vs partial), and a float64
value column — behind an append-only write cursor:

* the MASTER owns the segment (``ShmCacheLog``): it appends the round's
  new entries after merging worker returns and publishes the new row
  count; resizes happen by publish-new-then-swap (create the bigger
  segment, copy the row prefix, unlink the old one — readers keep their
  row cursors, because row indices are preserved);
* each WORKER maps the segment read-only (``ShmCacheReader``) and, at
  every round start, folds the rows between its local cursor and the
  cursor the master put in the round message into its local cache dicts
  — an O(new rows) numpy slice walk, no pickled payload on the wire.

Values round-trip exactly (float64 in, float64 out), so the worker's
cache serves the same bits the master's does and the parallel
bit-identity guarantee is untouched.  The write cursor is only ever
advanced while all workers are idle (the master appends between
collecting one round and submitting the next), so readers never observe
a torn row.

The watermark/``export_since`` delta protocol stays as the fallback: for
platforms without POSIX shared memory, for learned-cost runs (tag
evictions and exact-wins rewrites mutate tables in place — the mutation
``epoch`` machinery degrades those to a resync, which the append-only log
cannot express), and for any run that disables shm explicitly.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import numpy as np

try:  # POSIX shared memory; absent/broken on some exotic platforms
    from multiprocessing import shared_memory as _shm_mod

    import inspect as _inspect
    import os as _os

    # readers need a tracker-free attach: either 3.13+'s ``track=False``
    # or a raw mmap of the shm file (Linux /dev/shm) — see ``_Mapping``
    HAVE_SHM = (
        "track" in _inspect.signature(_shm_mod.SharedMemory).parameters
        or _os.path.isdir("/dev/shm")
    )
except ImportError:  # pragma: no cover - platform without shm
    _shm_mod = None
    HAVE_SHM = False

State = Tuple[int, ...]

# segment names are namespaced per pool instance so two pools in one
# process (or two daemons on one box) can never collide: the pid plus a
# module-level sequence number
_POOL_SEQ = itertools.count()

_HEADER_SLOTS = 8  # int64: [count, capacity, width]; rest reserved
_HEADER_BYTES = _HEADER_SLOTS * 8


def pool_uid() -> str:
    """A per-pool namespace component, unique within this process."""
    import os

    return f"{os.getpid()}-{next(_POOL_SEQ)}"


class _Mapping:
    """Reader-side attachment to an existing segment WITHOUT touching the
    resource tracker: the master owns unlinking, and under forkserver the
    workers SHARE the master's tracker process — a tracked attach (or a
    compensating ``unregister``) in a worker would corrupt the master's
    registration and misfire unlinks/warnings at exit.  Python 3.13+ has
    ``track=False`` for exactly this; earlier versions get a raw read-only
    mmap of the POSIX shm file (Linux: ``/dev/shm/<name>``), which never
    enters the tracker at all."""

    __slots__ = ("buf", "_shm", "_mm")

    def __init__(self, name: str):
        self._shm = self._mm = None
        try:  # Python >= 3.13
            self._shm = _shm_mod.SharedMemory(name=name, track=False)
            self.buf = self._shm.buf
            return
        except TypeError:
            pass
        import mmap
        import os

        fd = os.open("/dev/shm/" + name.lstrip("/"), os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            self._mm = mmap.mmap(fd, size, access=mmap.ACCESS_READ)
        finally:
            os.close(fd)
        self.buf = memoryview(self._mm)

    def close(self) -> None:
        if self._shm is not None:
            self._shm.close()
        else:
            try:
                self.buf.release()
                self._mm.close()
            except BufferError:  # numpy views still alive; GC finishes it
                pass


def _nbytes(capacity: int, width: int) -> int:
    # header + keys(int32) + lens(int16) + kinds(uint8) + values(float64)
    return _HEADER_BYTES + capacity * (width * 4 + 2 + 1 + 8)


class _Views:
    """Numpy views over one mapped segment (shared by writer and reader;
    layout is fully determined by the header's capacity/width)."""

    __slots__ = ("header", "keys", "lens", "kinds", "vals")

    def __init__(self, buf, capacity: int, width: int):
        self.header = np.ndarray(
            (_HEADER_SLOTS,), dtype=np.int64, buffer=buf)
        off = _HEADER_BYTES
        self.keys = np.ndarray(
            (capacity, width), dtype=np.int32, buffer=buf, offset=off)
        off += capacity * width * 4
        self.lens = np.ndarray(
            (capacity,), dtype=np.int16, buffer=buf, offset=off)
        off += capacity * 2
        self.kinds = np.ndarray(
            (capacity,), dtype=np.uint8, buffer=buf, offset=off)
        off += capacity
        self.vals = np.ndarray(
            (capacity,), dtype=np.float64, buffer=buf, offset=off)


class ShmCacheLog:
    """Master-side append-only writer over one shared segment.

    Lifecycle is owned by the pinned pool: created at init-snapshot time,
    swapped (new segment, rows copied, old one unlinked) on resize and on
    worker-death resync, unlinked on ``shutdown()``."""

    def __init__(self, uid: Optional[str] = None, *, capacity: int = 4096,
                 width: int = 16):
        if not HAVE_SHM:  # pragma: no cover - guarded by callers
            raise RuntimeError("multiprocessing.shared_memory unavailable")
        self.uid = uid if uid is not None else pool_uid()
        self.gen = 0
        self.count = 0
        self.capacity = capacity
        self.width = width
        # superseded generations, unlinked by ``drain_retired()`` once no
        # in-flight round message can still name them (end of the round
        # that swapped, or shutdown) — a reader attaches by NAME, so the
        # old file must outlive any message that carries it
        self.retired = []
        self._seg = self._create(capacity, width)
        self._views = _Views(self._seg.buf, capacity, width)
        self._publish()

    # -- segment management --------------------------------------------
    @property
    def name(self) -> str:
        return self._seg.name

    def _create(self, capacity: int, width: int):
        name = f"repro-cache-{self.uid}-g{self.gen}"
        return _shm_mod.SharedMemory(
            name=name, create=True, size=_nbytes(capacity, width))

    def _publish(self) -> None:
        h = self._views.header
        h[1] = self.capacity
        h[2] = self.width
        h[0] = self.count  # count last: a reader never sees rows > count

    def _migrate(self, capacity: int, width: int) -> None:
        """Publish-new-then-swap: bigger (or fresh same-size) segment,
        row prefix copied so reader cursors stay valid, old segment
        unlinked — attached readers keep their mapping until they switch
        to the new name (the round message carries it)."""
        self.gen += 1
        seg = self._create(capacity, width)
        views = _Views(seg.buf, capacity, width)
        n = self.count
        if n:
            views.keys[:n, : self.width] = self._views.keys[:n]
            views.lens[:n] = self._views.lens[:n]
            views.kinds[:n] = self._views.kinds[:n]
            views.vals[:n] = self._views.vals[:n]
        old = self._seg
        self._seg, self._views = seg, views
        self.capacity, self.width = capacity, width
        self._publish()
        self.retired.append(old)

    def swap(self) -> None:
        """Same-content generation bump (worker-death resync): the old
        segment is retired (unlinked at the next ``drain_retired``) and
        live readers move over on the next round message."""
        self._migrate(self.capacity, self.width)

    def drain_retired(self) -> None:
        """Unlink every superseded generation (round boundary/shutdown)."""
        for seg in self.retired:
            seg.close()
            try:
                seg.unlink()
            except FileNotFoundError:  # pragma: no cover - already gone
                pass
        self.retired = []

    # -- appends --------------------------------------------------------
    def append(self, entries) -> int:
        """Append an ``export_since`` payload ``(terminal, partial,
        terminal_version, partial_version)``; learned-tagged entries are
        rejected (the log is exact-only — callers fall back to the export
        protocol before any tag exists).  Returns rows appended."""
        t, p, tv, pv = entries
        if tv or pv:
            raise ValueError("shm cache log holds exact entries only")
        items = [(s, v, 0) for s, v in t.items()]
        items += [(s, v, 1) for s, v in p.items()]
        if not items:
            return 0
        need_w = max((len(s) for s, _, _ in items), default=0)
        cap, width = self.capacity, self.width
        while self.count + len(items) > cap:
            cap *= 2
        while need_w > width:
            width *= 2
        if (cap, width) != (self.capacity, self.width):
            self._migrate(cap, width)
        v = self._views
        i = self.count
        for s, val, kind in items:
            n = len(s)
            v.keys[i, :n] = s
            v.lens[i] = n
            v.kinds[i] = kind
            v.vals[i] = val
            i += 1
        self.count = i
        v.header[0] = i
        return len(items)

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        self._seg.close()

    def unlink(self) -> None:
        self.drain_retired()
        try:
            self._seg.unlink()
        except FileNotFoundError:  # pragma: no cover - already gone
            pass


class ShmCacheReader:
    """Worker-side read-only cursor over the master's log.

    ``fold(cache, name, cursor)`` attaches ``name`` if it is new (segment
    swaps ride the round message), reads the rows between the local
    cursor and ``cursor``, and inserts them into the worker cache's
    tables — plain dict stores of exact values, so re-folding the
    worker's own entries is a no-op and the cache's mutation ``epoch``
    never moves."""

    def __init__(self):
        self.name: Optional[str] = None
        self._seg = None
        self._views: Optional[_Views] = None
        self.cursor = 0
        self.folded = 0  # rows folded lifetime (the shm serving counter)

    def attach(self, name: str, cursor: int) -> None:
        """Point at a segment at ``cursor`` WITHOUT folding — used at
        init time, when the snapshot already contains every entry up to
        the cursor."""
        self._switch(name)
        self.cursor = cursor

    def _switch(self, name: str) -> None:
        if name == self.name:
            return
        if self._seg is not None:
            self._views = None  # drop numpy views before unmapping
            self._seg.close()
        self._seg = _Mapping(name)
        h = np.ndarray((_HEADER_SLOTS,), dtype=np.int64, buffer=self._seg.buf)
        self._views = _Views(self._seg.buf, int(h[1]), int(h[2]))
        self.name = name

    def fold(self, cache, name: str, cursor: int) -> int:
        """Fold rows ``[self.cursor, cursor)`` of segment ``name`` into
        ``cache``; returns the number of rows folded."""
        self._switch(name)
        lo, hi = self.cursor, cursor
        if hi <= lo:
            return 0
        v = self._views
        keys = v.keys[lo:hi]
        lens = v.lens[lo:hi]
        kinds = v.kinds[lo:hi]
        vals = v.vals[lo:hi]
        term, part = cache.terminal, cache.partial
        for i in range(hi - lo):
            s = tuple(int(a) for a in keys[i, : lens[i]])
            if kinds[i]:
                part[s] = vals[i]
            else:
                term[s] = vals[i]
        n = hi - lo
        self.cursor = hi
        self.folded += n
        return n

    def close(self) -> None:
        if self._seg is not None:
            self._views = None  # drop numpy views before unmapping
            self._seg.close()
            self._seg = None
            self.name = None

"""Persistent pinned process-pool workers for the parallel ensemble.

The pre-pinning pool (`ProcessPoolExecutor.submit(fn, tree)`) made the
worker→master *return* trip a true per-round delta (PR 2/4), but every
submit still pickled each whole ``ArrayMCTS`` — flat node arrays that grow
every round — plus the shared ``CachedMDP`` (the full transposition cache
and the serve-only cost backend).  The submit payload therefore grew with
the tree, not the round, and the pool kept losing to sequential below ~4
cores.

This module makes the submit side a per-round delta too.  Each worker
process is PINNED: it holds its subset of the ensemble's trees (keyed by
tree index) and one serve-only ``CachedMDP`` for the whole run, installed
once by an ``init`` snapshot.  Every subsequent round the master submits
only a FORWARD DELTA:

* ``advance`` — the previous round's root-synchronization action (the
  worker applies it to each pinned tree with ``advance_root``, exactly as
  the master did to its canonical copies);
* ``shm`` — on pure-analytic runs with POSIX shared memory available
  (the default), the sibling cache entries do not ride the pipe at all:
  the master appends every round's new entries to a shared-memory log
  (``engine/shm_cache.ShmCacheLog``) and the forward delta carries only
  the segment name and write cursor; the worker maps the segment
  read-only and folds the unseen rows into its local cache
  (``ShmCacheReader.fold``) — cross-process cache hits with O(1) submit
  payload.  The segment's lifecycle is owned by this pool: created at
  init-snapshot time, resized by publish-new-then-swap, swapped (and the
  old generation unlinked) on worker-death ``_resync``, unlinked on
  ``shutdown()``;
* ``cache`` — the export fallback: the sibling trees' new entries since
  this worker's last submit, exported incrementally from the master's
  merged cache (``TranspositionCache.export_since`` against a per-worker
  watermark).  Engages when shm is unavailable or disabled, and whenever
  the cache stops being append-only (a learned-tag eviction or
  exact-wins rewrite bumps the mutation ``epoch``) — the pool then
  unlinks the log and degrades every worker to one full-export resync,
  exactly as the epoch machinery already degrades stale watermarks;
* ``params`` — learned-model parameters, ONLY when the master's fit
  generation changed (``HybridCostBackend.params_delta``); workers keep
  serving the old generation until a new one arrives.

The worker applies the forward delta, runs each pinned tree's decision
round — scalar ``run_decision`` per tree, or ONE lockstep
``run_decision_batch`` over its whole pinned subset when the pool was
built with ``worker_batch=True`` (batched leaf pricing and the pool then
compose: each worker prices one deduplicated miss batch per step through
the columnar kernel instead of K scalar walks) — and returns the
existing reverse delta (``ArrayMCTS.begin_delta``/``collect_delta``)
plus its round's new cache entries and counter diffs — so the numeric
payload in BOTH directions scales with the round, not the tree.  Payload
sizes are measured at the pickle boundary
(``submit_bytes``/``return_bytes``/``snapshot_bytes``, surfaced on
``TuneResult``), so the O(round) claim is a number CI can gate, not an
assertion; per-worker hit/miss/dedup counters and the shm-vs-export
serving split are surfaced the same way (``PinnedWorkerPool.stats()``),
as is the round's cross-worker duplicate-eval count (distinct states
priced by two or more workers in the same round — the quantity the
shared cache exists to crush).

Determinism and fault tolerance: the master keeps the CANONICAL trees —
every reverse delta is applied to its copy (``apply_delta`` reproduces
the worker's post-round tree exactly), so when a pinned worker dies the
master respawns it and reseeds it from a snapshot of those trees plus the
current merged cache; the replacement re-runs the round from the identical
pre-round state (same pickled RNG), so results — plans, costs, decision
sequences — are unchanged by any number of worker deaths.  Merges happen
in worker/tree-index order regardless of completion order, preserving the
sequential-bit-identity guarantee of the analytic path.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.engine.cache import CachedMDP
from repro_torch.core.engine.shm_cache import HAVE_SHM, ShmCacheLog, ShmCacheReader

_PROTO = pickle.HIGHEST_PROTOCOL


def pick_mp_context():
    """forkserver where available (workers start from a clean process —
    forking a parent that has initialised CUDA or OpenMP threads is
    unsafe), fork otherwise; schedule pricing is deliberately torch-free so
    workers stay cheap to spawn.

    The forkserver preloads the engine module chain (numpy, the MDP and
    cost-model modules — everything a pickled ``CachedMDP``/``ArrayMCTS``
    needs, none of it torch): children then FORK with the imports already
    done, so after the first pool of a process, worker spawn cost drops
    from an import chain to a fork."""
    methods = multiprocessing.get_all_start_methods()
    method = next((m for m in ("forkserver", "fork") if m in methods), None)
    ctx = multiprocessing.get_context(method)
    if method == "forkserver":
        # a no-op once the server is running; effective when called (as
        # here) before the first worker process ever starts
        ctx.set_forkserver_preload(["repro_torch.core.ensemble"])
    return ctx


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------
def _apply_forward(mdp, trees: Dict[int, object], fwd: dict,
                   reader: Optional[ShmCacheReader] = None) -> None:
    """Apply a round's forward delta: params first (a new fit generation
    evicts the local copies of predictions the master already evicted),
    then the sibling cache entries (folded from the shared-memory log
    when the round message carries a cursor, applied from the pickled
    export otherwise), then the root advance (which prices nothing —
    ``advance_root`` only steps the MDP structure)."""
    cached = isinstance(mdp, CachedMDP)
    params = fwd.get("params")
    if params is not None and cached and mdp.cost_backend is not None:
        mdp.cost_backend.apply_params(params)
    shm = fwd.get("shm")
    if shm is not None and reader is not None and cached:
        if isinstance(shm, tuple):  # generation changed: new segment name
            reader.fold(mdp.cache, shm[0], shm[1])
        else:  # steady round: bare cursor over the current segment
            reader.fold(mdp.cache, reader.name, shm)
    cache = fwd.get("cache")
    if cache is not None and cached:
        entries, full = cache
        mdp.cache.apply_export(entries, full)
    advance = fwd.get("advance")
    if advance is not None:
        for tid in sorted(trees):
            trees[tid].advance_root(advance)


def _run_round(mdp, trees: Dict[int, object], fwd: dict,
               reader: Optional[ShmCacheReader] = None,
               batch: bool = False):
    _apply_forward(mdp, trees, fwd, reader)
    cached = isinstance(mdp, CachedMDP)
    backend = mdp.cost_backend if cached else None
    if cached:
        cache = mdp.cache
        h0, m0, d0 = cache.hits, cache.misses, cache.dedup
        wm = cache.watermark()
    serve0 = backend.counters() if backend is not None else None
    evals0 = getattr(mdp.cost_model, "n_evals", None)
    results = {}
    tids = sorted(trees)  # deterministic within-worker order
    if batch and tids:
        # in-worker lockstep: ONE batched decision round over the whole
        # pinned subset — delta recording is cursor-aware (engine/batch),
        # so the reverse transport is unchanged
        from repro_torch.core.engine.batch import run_decision_batch

        for tid in tids:
            trees[tid].begin_delta()
        ress = run_decision_batch([trees[tid] for tid in tids], mdp)
        for tid, res in zip(tids, ress):
            results[tid] = (trees[tid].collect_delta(), res)
    else:
        for tid in tids:
            tree = trees[tid]
            tree.begin_delta()
            res = tree.run_decision()
            results[tid] = (tree.collect_delta(), res)
    stats = cache_new = serving = evals = None
    if cached:
        stats = {
            "hits": cache.hits - h0,
            "misses": cache.misses - m0,
            "dedup": cache.dedup - d0,
        }
        # this round's new entries: everything past the round-start
        # watermark (the worker never refits/evicts, so its tables are
        # append-only within a round and the islice export is exact)
        cache_new, _full = cache.export_since(wm)
    if serve0 is not None:
        s1 = backend.counters()
        serving = tuple(a - b for a, b in zip(s1, serve0))
    if evals0 is not None:
        evals = getattr(mdp.cost_model, "n_evals") - evals0
    # what this worker priced on (its device and CUDA context), learned runs only
    report = backend.worker_report() if backend is not None else None
    return ("round", results, stats, cache_new, evals, serving, report)


def _worker_main(conn) -> None:
    """Pinned-worker loop: hold the init snapshot's trees + serve-only
    MDP for the whole run, answer one ``round`` message at a time."""
    mdp = None
    trees: Dict[int, object] = {}
    reader: Optional[ShmCacheReader] = None
    batch = False
    try:
        while True:
            try:
                msg = pickle.loads(conn.recv_bytes())
            except EOFError:
                return
            kind = msg[0]
            if kind == "init":
                # (mdp, trees) unpickle from ONE message, so the trees'
                # shared mdp reference dedups to a single object
                mdp, trees = msg[1], msg[2]
                opts = msg[3] if len(msg) > 3 else {}
                batch = bool(opts.get("batch"))
                if reader is not None:
                    reader.close()
                    reader = None
                shm_info = opts.get("shm")
                if shm_info is not None and HAVE_SHM:
                    # attach at the snapshot-time cursor: the pickled
                    # cache already holds every row up to it
                    reader = ShmCacheReader()
                    reader.attach(*shm_info)
                conn.send_bytes(pickle.dumps(("ok",), _PROTO))
            elif kind == "round":
                try:
                    out = _run_round(mdp, trees, msg[1], reader, batch)
                except Exception:  # deterministic errors surface master-side
                    out = ("err", traceback.format_exc())
                conn.send_bytes(pickle.dumps(out, _PROTO))
            elif kind == "stop":
                if reader is not None:
                    reader.close()
                return
    except (BrokenPipeError, ConnectionResetError, KeyboardInterrupt, OSError):
        return


# ---------------------------------------------------------------------------
# Master side
# ---------------------------------------------------------------------------
@dataclass
class _Worker:
    proc: object
    conn: object
    tids: List[int]
    watermark: Optional[tuple] = None
    known_version: int = 0
    just_synced: bool = True  # init snapshot already holds the advance/cache
    submitted: bool = False   # a round message is in flight
    # keys this worker itself returned last round (pure-analytic runs
    # only): its own entries land in the master cache past its submit-time
    # watermark, so without this they would be echoed straight back next
    # round — ~1/n_workers of every incremental export, pure waste
    echo: Optional[tuple] = None
    # shm-log cursor and segment name as of the last message this worker
    # was sent (steady rounds ship the bare cursor int; the name rides
    # along only when the generation changed)
    shm_count: int = 0
    shm_name: Optional[str] = None
    # cumulative counters (hits/misses/dedup from round returns,
    # shm_entries/export_entries accounted master-side at submit) —
    # carried across death-resyncs, surfaced by ``PinnedWorkerPool.stats``
    stats: Dict[str, int] = field(default_factory=dict)
    # the cost backend's ``worker_report`` from the last round (learned
    # runs): the device this worker priced on and its CUDA context
    pricing: Optional[dict] = None


class PinnedWorkerPool:
    """Master-side handle over the pinned workers.

    ``trees`` is the ensemble's canonical (master) tree list — this pool
    mutates it: reverse deltas are applied to these objects every round,
    which is both what the winner selection reads and what worker-death
    resync snapshots.  ``mdp`` is the shared (usually ``CachedMDP``) the
    trees search over.
    """

    def __init__(self, trees: List[object], mdp, *,
                 n_workers: Optional[int] = None, mp_context=None,
                 shm: Optional[bool] = None, worker_batch: bool = False):
        self.trees = trees
        self.mdp = mdp
        self.cached = isinstance(mdp, CachedMDP)
        self.backend = mdp.cost_backend if self.cached else None
        self.shm_opt = shm  # None = auto (on for pure-analytic runs)
        self.worker_batch = worker_batch
        ctx = mp_context if mp_context is not None else pick_mp_context()
        self._ctx = ctx
        n = n_workers or os.cpu_count() or 2
        if trees:  # never more workers than trees — but an EMPTY pool
            n = min(n, len(trees))  # (service pre-spawn before any run)
        n = max(n, 1)  # keeps the requested width for a later rebind()
        # payload accounting (pickled bytes crossing the pool boundary)
        self.submit_bytes = 0
        self.return_bytes = 0
        self.snapshot_bytes = 0  # init + death-resync whole-state shipments
        self.submit_bytes_rounds: List[int] = []
        self.return_bytes_rounds: List[int] = []
        self.n_worker_restarts = 0
        # restarts attributable to the CURRENT binding (reset by rebind():
        # the daemon's health watchdog reads this to tell "one bad run"
        # from "the pool is repeatedly dying")
        self.restarts_since_rebind = 0
        self.extra_evals = 0  # worker-side cost-model evals (per-round diffs)
        # cross-worker duplicate evals: per round, the number of (state,
        # table) keys that TWO OR MORE workers priced independently —
        # deterministic (derived from the returned exports, which depend
        # only on search trajectories), so CI can gate on it
        self.dup_evals = 0
        self.dup_evals_rounds: List[int] = []
        self._shm: Optional[ShmCacheLog] = None
        self._shm_wm = None
        self.shm_used = False  # log existed for this run (survives shutdown)
        if self._shm_eligible():
            self._shm = ShmCacheLog()
            self._shm_wm = mdp.cache.watermark()
            self.shm_used = True
        # round-robin pinning: tree i lives on worker i % n for the run.
        # Spawn + init overlap across workers: all processes launch and
        # receive their snapshots before the first (blocking) ack read.
        self._workers = [
            self._launch([t for t in range(len(trees)) if t % n == w])
            for w in range(n)
        ]
        for w in self._workers:
            self._await_init(w)

    # -- lifecycle -----------------------------------------------------
    def _shm_eligible(self) -> bool:
        """shm serves the append-only pure-analytic path only: a mounted
        cost backend can evict/rewrite entries, which the log cannot
        express (the export/epoch protocol handles those runs)."""
        return (HAVE_SHM and self.shm_opt is not False and self.cached
                and self.backend is None)

    @property
    def shm_enabled(self) -> bool:
        return self._shm is not None

    def _launch(self, tids: List[int]) -> _Worker:
        """Start a worker process and ship its init snapshot: this
        worker's canonical trees plus the shared MDP (cache counters and
        serving counters pickle zeroed; the backend pickles serve-only).
        Paid once at startup and once per worker death — never per
        round."""
        parent, child = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=_worker_main, args=(child,), daemon=True)
        proc.start()
        child.close()
        w = _Worker(proc, parent, tids)
        opts = {"batch": self.worker_batch}
        if self._shm is not None:
            # attach-at-cursor: the snapshot cache below already holds
            # every row up to the current count
            opts["shm"] = (self._shm.name, self._shm.count)
            w.shm_count = self._shm.count
            w.shm_name = self._shm.name
        payload = pickle.dumps(
            ("init", self.mdp, {tid: self.trees[tid] for tid in w.tids},
             opts),
            _PROTO,
        )
        w.conn.send_bytes(payload)
        self.snapshot_bytes += len(payload)
        if self.cached:
            w.watermark = self.mdp.cache.watermark()
        if self.backend is not None:
            w.known_version = self.backend.trainer.version
        return w

    def _await_init(self, w: _Worker) -> None:
        ack = pickle.loads(w.conn.recv_bytes())
        if ack != ("ok",):
            raise RuntimeError(f"pinned worker failed to initialize: {ack!r}")

    def _spawn(self, tids: List[int]) -> _Worker:
        w = self._launch(tids)
        self._await_init(w)
        return w

    def _resync(self, w: _Worker) -> _Worker:
        """Worker-death recovery: respawn and reseed from the master's
        canonical trees + merged cache.  The snapshot is exactly the
        worker's lost pre-round state (same pickled RNG), so re-running
        the round reproduces the lost results bit-for-bit."""
        self.n_worker_restarts += 1
        self.restarts_since_rebind += 1
        try:
            w.conn.close()
        except OSError:
            pass
        if w.proc.is_alive():
            w.proc.terminate()
        w.proc.join(timeout=5)
        if self._shm is not None:
            # generation bump: the dead worker can never have the retiring
            # segment mapped again; live workers and the respawn get the
            # new name, and the old file is unlinked at the round boundary
            self._shm.swap()
        fresh = self._spawn(w.tids)
        fresh.stats = w.stats  # counters survive the death
        self._workers[self._workers.index(w)] = fresh
        return fresh

    def rebind(self, trees: List[object], mdp, *,
               shm: Optional[bool] = None,
               worker_batch: Optional[bool] = None) -> None:
        """Re-point the LIVE worker processes at a new run's canonical
        trees + MDP (the daemon reuses one pool across tuning runs, so
        worker spawn cost is paid once per process, not once per request).

        Ships a fresh ``init`` snapshot to every worker — the worker loop
        already accepts repeated inits — and resets all per-worker cursors
        (cache watermark, model generation, echo set, shm cursor) to the
        new run's state; the previous run's shm segment is unlinked and a
        fresh log created if the new run is shm-eligible.  A worker that
        died between runs is respawned here."""
        self.trees = trees
        self.mdp = mdp
        self.cached = isinstance(mdp, CachedMDP)
        self.backend = mdp.cost_backend if self.cached else None
        if worker_batch is not None:
            self.worker_batch = worker_batch
        self.shm_opt = shm  # new run's preference (None = auto)
        if self._shm is not None:
            self._shm.close()
            self._shm.unlink()
            self._shm = None
            self._shm_wm = None
        self.shm_used = False
        if self._shm_eligible():
            self._shm = ShmCacheLog()
            self._shm_wm = mdp.cache.watermark()
            self.shm_used = True
        # per-run counters restart with the new run's trees
        # (n_worker_restarts stays cumulative over the pool's lifetime)
        self.restarts_since_rebind = 0
        self.dup_evals = 0
        self.dup_evals_rounds = []
        self.submit_bytes_rounds = []
        self.return_bytes_rounds = []
        n = len(self._workers)
        pending = []
        for wi, w in enumerate(list(self._workers)):
            w.tids = [t for t in range(len(trees)) if t % n == wi]
            opts = {"batch": self.worker_batch}
            if self._shm is not None:
                opts["shm"] = (self._shm.name, self._shm.count)
                w.shm_count = self._shm.count
                w.shm_name = self._shm.name
            else:
                w.shm_count = 0
                w.shm_name = None
            payload = pickle.dumps(
                ("init", mdp, {tid: trees[tid] for tid in w.tids}, opts),
                _PROTO)
            try:
                w.conn.send_bytes(payload)
            except (BrokenPipeError, ConnectionResetError, OSError):
                w.stats = {}  # new run: counters restart even on respawn
                self._resync(w)  # respawn ships the same snapshot
                continue
            self.snapshot_bytes += len(payload)
            if self.cached:
                w.watermark = mdp.cache.watermark()
            if self.backend is not None:
                w.known_version = self.backend.trainer.version
            w.just_synced = True
            w.submitted = False
            w.echo = None
            w.stats = {}
            pending.append(wi)
        for wi in pending:
            w = self._workers[wi]
            try:
                self._await_init(w)
            except (EOFError, ConnectionResetError, OSError):
                self._resync(w)

    def shutdown(self) -> None:
        for w in self._workers:
            try:
                w.conn.send_bytes(pickle.dumps(("stop",), _PROTO))
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass
        for w in self._workers:
            w.proc.join(timeout=5)
            if w.proc.is_alive():
                w.proc.terminate()
            try:
                w.conn.close()
            except OSError:
                pass
        if self._shm is not None:
            self._shm.close()
            self._shm.unlink()
            self._shm = None

    # -- the per-round protocol ----------------------------------------
    def _forward(self, w: _Worker, advance: Optional[int]) -> dict:
        """Build this worker's forward delta and move its cursors.  A
        just-(re)synced worker's snapshot already contains the advance,
        the full cache, and the current model — everything ships empty.
        With the shm log live, sibling cache entries ship as an O(1)
        (segment name, cursor) pair instead of a pickled export."""
        fwd: dict = {"advance": None if w.just_synced else advance}
        w.just_synced = False
        if self._shm is not None:
            if w.shm_name == self._shm.name:
                fwd["shm"] = self._shm.count  # steady: bare cursor int
            else:
                fwd["shm"] = (self._shm.name, self._shm.count)
                w.shm_name = self._shm.name
            s = w.stats
            s["shm_entries"] = (
                s.get("shm_entries", 0) + self._shm.count - w.shm_count)
            w.shm_count = self._shm.count
            # the per-worker export watermark idles while shm serves; it
            # is re-armed (set to None → one full export) on shm disable
        elif self.cached:
            if w.watermark != (wm := self.mdp.cache.watermark()):
                entries, full = self.mdp.cache.export_since(w.watermark)
                if not full and w.echo is not None:
                    # drop the worker's own last-round entries: a pure
                    # memo maps a key to one exact value, so the worker's
                    # copy is already the merged value (learned runs never
                    # set ``echo`` — a sibling's exact audit can overwrite
                    # a prediction, and the worker must see that)
                    t, p, tv, pv = entries
                    et, ep = w.echo
                    entries = (
                        {k: v for k, v in t.items() if k not in et},
                        {k: v for k, v in p.items() if k not in ep},
                        tv, pv,
                    )
                fwd["cache"] = (entries, full)
                w.watermark = wm
                s = w.stats
                s["export_entries"] = (
                    s.get("export_entries", 0)
                    + len(entries[0]) + len(entries[1]))
            else:
                fwd["cache"] = None
            w.echo = None
        if self.backend is not None:
            fwd["params"] = self.backend.params_delta(w.known_version)
            w.known_version = self.backend.trainer.version
        return fwd

    def _submit(self, w: _Worker, advance: Optional[int]) -> None:
        buf = pickle.dumps(("round", self._forward(w, advance)), _PROTO)
        w.conn.send_bytes(buf)
        self.submit_bytes += len(buf)
        self._round_submit += len(buf)
        w.submitted = True

    def _collect(self, w: _Worker, advance: Optional[int]):
        """One worker's round result; on a dead pipe, resync and re-run
        the round once before giving up."""
        for attempt in (0, 1):
            try:
                if not w.submitted:
                    self._submit(w, advance)
                buf = w.conn.recv_bytes()
            except (BrokenPipeError, ConnectionResetError, EOFError, OSError):
                if attempt:
                    raise RuntimeError(
                        f"pinned worker for trees {w.tids} died twice in "
                        f"one round") from None
                w = self._resync(w)
                continue
            w.submitted = False
            self.return_bytes += len(buf)
            self._round_return += len(buf)
            msg = pickle.loads(buf)
            if msg[0] == "err":
                raise RuntimeError(f"pinned worker raised:\n{msg[1]}")
            return msg[1:]
        raise AssertionError("unreachable")

    def round(self, advance: Optional[int] = None) -> List[object]:
        """One decision round across all pinned workers.

        Submits every worker's forward delta, then collects and merges in
        worker order (each worker's trees in index order) — deterministic
        regardless of completion order.  Returns the per-tree
        ``DecisionResult``s in tree-index order."""
        self._round_submit = 0
        self._round_return = 0
        for w in list(self._workers):
            try:
                self._submit(w, advance)
            except (BrokenPipeError, ConnectionResetError, OSError):
                self._resync(w)  # snapshot embeds the advance; collect submits
        results: Dict[int, object] = {}
        exports: List[tuple] = []  # per-worker returned key sets (dup count)
        for i in range(len(self._workers)):
            # re-read: _collect may have replaced the worker via resync
            got = self._collect(self._workers[i], advance)
            tree_out, stats, cache_new, evals, serving, report = got
            if report is not None:
                self._workers[i].pricing = report
            for tid in sorted(tree_out):
                delta, res = tree_out[tid]
                self.trees[tid].apply_delta(delta)
                results[tid] = res
            if self.cached and cache_new is not None:
                self.mdp.cache.apply_export(cache_new)
                if stats is not None:
                    self.mdp.cache.hits += stats["hits"]
                    self.mdp.cache.misses += stats["misses"]
                    self.mdp.cache.dedup += stats["dedup"]
                    ws = self._workers[i].stats
                    for k, v in stats.items():
                        ws[k] = ws.get(k, 0) + v
                keys = (set(cache_new[0]), set(cache_new[1]))
                exports.append(keys)
                if self.backend is None and self._shm is None:
                    # pure-analytic export mode: remember what this worker
                    # just sent so next round's export skips echoing it
                    # back (the shm log has no echo problem — re-folding
                    # your own exact entry is a no-op dict insert)
                    self._workers[i].echo = keys
            if serving is not None and self.backend is not None:
                self.backend.merge_counters(serving)
            if evals is not None:
                self.extra_evals += evals
        # cross-worker duplicate evals: a key in >=2 workers' returns was
        # priced that many times this round — the re-pricing the shared
        # cache exists to eliminate (deterministic: a pure function of
        # the search trajectories, not of timing)
        dup = 0
        if len(exports) > 1:
            for k in (0, 1):
                counts: Dict[object, int] = {}
                for keys in exports:
                    for s in keys[k]:
                        counts[s] = counts.get(s, 0) + 1
                dup += sum(c - 1 for c in counts.values() if c > 1)
        self.dup_evals += dup
        self.dup_evals_rounds.append(dup)
        if self._shm is not None:
            self._shm_append()
        self.submit_bytes_rounds.append(self._round_submit)
        self.return_bytes_rounds.append(self._round_return)
        return [results[tid] for tid in range(len(self.trees))]

    def _shm_append(self) -> None:
        """Publish the round's new master-cache entries to the shm log.
        Any sign the tables stopped being append-only (an epoch bump, a
        learned tag) disables shm for the rest of the run: the log is
        unlinked and every worker degrades to one full-export resync —
        the same path a stale watermark already takes."""
        cache = self.mdp.cache
        entries, full = cache.export_since(self._shm_wm)
        if full or entries[2] or entries[3]:
            self._shm_disable()
            return
        self._shm.append(entries)
        self._shm_wm = cache.watermark()
        self._shm.drain_retired()  # no round message names old gens now

    def _shm_disable(self) -> None:
        if self._shm is None:
            return
        self._shm.close()
        self._shm.unlink()
        self._shm = None
        self._shm_wm = None
        for w in self._workers:
            w.watermark = None  # next forward: full export resync
            w.echo = None

    # -- introspection --------------------------------------------------
    def stats(self) -> dict:
        """Per-worker counters and pool-level dedup/dup-eval totals, in
        worker-slot order (surfaced on ``TuneResult.stats``)."""
        return {
            "shm": self.shm_used,
            "worker_batch": self.worker_batch,
            "n_worker_restarts": self.n_worker_restarts,
            "restarts_since_rebind": self.restarts_since_rebind,
            "dup_evals": self.dup_evals,
            "dup_evals_rounds": list(self.dup_evals_rounds),
            "workers": [dict(w.stats, **({"pricing": w.pricing} if w.pricing else {}))
                        for w in self._workers],
        }

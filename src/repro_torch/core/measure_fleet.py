"""Fault-tolerant measurement fleet: persistent worker processes fanning
out ``measure_fn`` requests, sharing the content-hash on-disk cache as the
dedup store.

The counterpart of the JAX package's ``core/measure_fleet.py``, kept as it
is.  Real measurement (a step run on the card, seconds each) is the one
layer of the cost stack that cannot hide inside the search loop's ~100 µs
budget.  This module moves it off the critical path: the master batches
every plan it wants priced into one ``measure_many`` call, the fleet fans
the cache misses out over persistent workers, and the search only ever
blocks at root synchronizations — exactly where the paper's
``mcts_cost+real_*`` configurations re-rank candidates.

**On the card the fleet runs one worker** (``bind(device="cuda")`` refuses
more): two processes timing on one GPU spoil each other's times.  That one
persistent worker is also the fast path: the card target
(``repro_torch.launch.measure.CardTarget()``) keeps its CUDA context and
the model's weights resident across requests, since the weights do not
depend on the plan, and rebuilds only the step and the optimizer state
for each program.  Workers start from a clean process
(``pick_mp_context``: forkserver or spawn, never a fork of a parent that
has touched CUDA); a caller that has used the card empties its allocator's
cache (``torch.cuda.empty_cache()``) before the fleet starts, and gives a
watchdog deadline above a cold worker's first request (CUDA start-up and
the weights' build; the kernels are already built).

Request lifecycle:

1. **cache** — each request is keyed by ``measure.request_key`` (content
   hash of version, arch, shape, mesh, devices, hw, device kind, cut and
   the plan, or for a card measurement the program it runs); a valid
   on-disk record resolves the request without touching a worker.
2. **single-flight** — concurrent misses for the same key are grouped
   into one in-flight job; the program runs once and every requester
   shares the record.
3. **dispatch** — jobs go to idle workers over the same pipe protocol as
   ``PinnedWorkerPool`` (spawn via ``pick_mp_context``'s forkserver).
4. **watchdog** — every in-flight job has a master-side deadline
   (request timeout + ``grace_s``); a worker that blows it is SIGKILLed
   and respawned, and the job re-queues.
5. **retry** — failures (worker death, watchdog timeout, or an error the
   target raised) re-queue with exponential backoff
   (``backoff_s * backoff_factor**(retries-1)``) up to ``max_retries``;
   every re-dispatch, whatever its cause, consumes the same budget.
6. **publish** — a successful record is written atomically
   (``measure.write_record``) so a fleet cache file is byte-identical to
   the serial ``measure_cell`` path's.

A request that exhausts its retries resolves to a failed
``MeasureOutcome`` (``record=None``, ``error`` set) — the fleet never
raises from ``measure_many``; callers choose strictness.  ``FleetMeasure``
(from ``bind``) is the ``measure_fn``-shaped adapter the ensemble
threads through ``measure_backend=``.
"""
from __future__ import annotations

import heapq
import os
import pickle
import time
import traceback
from dataclasses import dataclass, field
from multiprocessing.connection import wait as _conn_wait
from typing import Dict, List, Optional

from repro_torch.core.engine.workers import _PROTO, pick_mp_context
from repro_torch.core.measure import (
    CACHE_DIR,
    load_record,
    make_request,
    measure_request,
    request_key,
    write_record,
)


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------
def _fleet_worker_main(conn, target) -> None:
    """One-request-at-a-time measurement loop.  ``target`` is the
    measurement function, pickled once at spawn (a module-level function,
    or an object such as ``launch.measure.CardTarget()`` whose state then
    lives in this worker): the card target or the subprocess
    ``measure_request`` in production, the analytic stub in tests."""
    try:
        while True:
            try:
                msg = pickle.loads(conn.recv_bytes())
            except EOFError:
                return
            if msg[0] == "stop":
                return
            _, rid, req = msg
            try:
                out = ("ok", rid, target(req))
            except Exception:  # surfaced master-side; retry policy decides
                out = ("err", rid, traceback.format_exc())
            conn.send_bytes(pickle.dumps(out, _PROTO))
    except (BrokenPipeError, ConnectionResetError, KeyboardInterrupt, OSError):
        return


# ---------------------------------------------------------------------------
# Master side
# ---------------------------------------------------------------------------
@dataclass
class MeasureOutcome:
    """Per-request provenance — stamped onto sweep artifact rows."""

    key: str
    record: Optional[dict] = None
    from_cache: bool = False
    attempts: int = 0
    retries: int = 0
    timeouts: int = 0
    worker_deaths: int = 0
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.record is not None

    def provenance(self) -> dict:
        return {
            "key": self.key,
            "from_cache": self.from_cache,
            "attempts": self.attempts,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "worker_deaths": self.worker_deaths,
            "failed": not self.ok,
        }


@dataclass
class _Job:
    """One in-flight cache key (single-flight: N requests, one run)."""

    key: str
    req: dict
    slots: List[int] = field(default_factory=list)  # output positions
    outcome: MeasureOutcome = None  # type: ignore[assignment]
    ready_at: float = 0.0


@dataclass
class _FleetWorker:
    proc: object
    conn: object
    job: Optional[_Job] = None
    deadline: float = 0.0


class MeasurementFleet:
    """Master-side handle over the measurement workers.

    Workers spawn lazily on the first cache miss and persist across
    ``measure_many`` calls; ``shutdown()`` (or the context manager) stops
    them.  All counters are cumulative over the fleet's lifetime.
    """

    def __init__(
        self,
        n_workers: int = 4,
        *,
        cache_dir: Optional[str] = None,
        target=None,
        timeout: float = 1800.0,
        grace_s: float = 60.0,
        max_retries: int = 2,
        backoff_s: float = 0.5,
        backoff_factor: float = 2.0,
        mp_context=None,
    ):
        self.n_workers = max(int(n_workers), 1)
        self.cache_dir = cache_dir or CACHE_DIR
        self.target = target or measure_request
        self.timeout = timeout
        self.grace_s = grace_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        self._ctx = mp_context
        self._workers: List[_FleetWorker] = []
        self._rid = 0
        self._seq = 0
        # lifetime counters
        self.n_requests = 0
        self.n_cache_hits = 0
        self.n_deduped = 0
        self.n_measured = 0
        self.n_retries = 0
        self.n_timeouts = 0
        self.n_failures = 0
        self.n_worker_restarts = 0

    # -- lifecycle -----------------------------------------------------
    def _ensure_workers(self) -> None:
        if self._ctx is None:
            self._ctx = pick_mp_context()
        while len(self._workers) < self.n_workers:
            self._workers.append(self._spawn())

    def _spawn(self) -> _FleetWorker:
        parent, child = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=_fleet_worker_main, args=(child, self.target), daemon=True
        )
        proc.start()
        child.close()
        return _FleetWorker(proc, parent)

    def _respawn(self, w: _FleetWorker) -> None:
        """SIGKILL-survivable replacement (same recovery shape as
        ``PinnedWorkerPool._resync``): the dead worker's job re-queues
        through the normal retry budget."""
        self.n_worker_restarts += 1
        try:
            w.conn.close()
        except OSError:
            pass
        if w.proc.is_alive():
            w.proc.kill()
        w.proc.join(timeout=5)
        self._workers[self._workers.index(w)] = self._spawn()

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
        self._workers = []

    def __enter__(self) -> "MeasurementFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- scheduling ----------------------------------------------------
    def _requeue(self, job: _Job, pending: List, retries: List) -> None:
        """Failed attempt: back off and retry, or fail permanently."""
        o = job.outcome
        if o.retries >= self.max_retries:
            self.n_failures += 1
            if o.error is None:
                o.error = "retries exhausted"
            job.ready_at = -1.0  # terminal marker
            return
        o.retries += 1
        self.n_retries += 1
        delay = self.backoff_s * self.backoff_factor ** (o.retries - 1)
        job.ready_at = time.monotonic() + delay
        self._seq += 1
        heapq.heappush(retries, (job.ready_at, self._seq, job))

    def _dispatch(self, w: _FleetWorker, job: _Job) -> bool:
        self._rid += 1
        job.outcome.attempts += 1
        payload = pickle.dumps(("req", self._rid, job.req), _PROTO)
        try:
            w.conn.send_bytes(payload)
        except (BrokenPipeError, ConnectionResetError, OSError):
            return False  # caller respawns; attempt not charged to retries
        w.job = job
        timeout = job.req.get("timeout") or self.timeout
        w.deadline = time.monotonic() + timeout + self.grace_s
        return True

    # -- the fan-out ---------------------------------------------------
    def measure_many(self, requests: List[dict]) -> List[MeasureOutcome]:
        """Resolve every request: cache hit, deduped join on an in-flight
        key, or a fleet measurement.  Never raises — inspect
        ``MeasureOutcome.ok`` / ``.error`` per request."""
        os.makedirs(self.cache_dir, exist_ok=True)
        self.n_requests += len(requests)
        outcomes: List[Optional[MeasureOutcome]] = [None] * len(requests)
        jobs: Dict[str, _Job] = {}
        for i, req in enumerate(requests):
            key = request_key(req)
            if key in jobs:  # single-flight: join the in-flight job
                jobs[key].slots.append(i)
                self.n_deduped += 1
                continue
            rec = load_record(os.path.join(self.cache_dir, key + ".json"))
            if rec is not None:
                self.n_cache_hits += 1
                outcomes[i] = MeasureOutcome(key, rec, from_cache=True)
                continue
            job = _Job(key, req, [i])
            job.outcome = MeasureOutcome(key)
            jobs[key] = job
        if jobs:
            self._run(list(jobs.values()))
        for job in jobs.values():
            for i in job.slots:
                outcomes[i] = job.outcome
        return outcomes  # type: ignore[return-value]

    def _run(self, todo: List[_Job]) -> None:
        self._ensure_workers()
        pending: List[_Job] = list(todo)
        retries: List = []  # (ready_at, seq, job) heap
        done = 0
        total = len(todo)
        while done < total:
            now = time.monotonic()
            # promote due retries
            while retries and retries[0][0] <= now:
                pending.append(heapq.heappop(retries)[2])
            # dispatch to idle workers (an idle worker found dead at send
            # time is replaced in place; the attempt is not charged)
            for wi in range(len(self._workers)):
                if not pending:
                    break
                if self._workers[wi].job is not None:
                    continue
                job = pending.pop(0)
                while not self._dispatch(self._workers[wi], job):
                    job.outcome.attempts -= 1
                    self._respawn(self._workers[wi])
            busy = [w for w in self._workers if w.job is not None]
            if not busy:
                if retries:
                    time.sleep(max(0.0, retries[0][0] - time.monotonic()))
                    continue
                if pending:
                    continue
                break  # every remaining job failed terminally
            # wait for the first result or the nearest deadline
            horizon = min(w.deadline for w in busy)
            if retries:
                horizon = min(horizon, retries[0][0])
            wait_s = max(0.0, min(horizon - time.monotonic(), 1.0))
            ready = _conn_wait([w.conn for w in busy], timeout=wait_s)
            for conn in ready:
                w = next(x for x in busy if x.conn is conn)
                job = w.job
                try:
                    msg = pickle.loads(conn.recv_bytes())
                except (BrokenPipeError, ConnectionResetError, EOFError, OSError):
                    # worker died mid-request (e.g. SIGKILL)
                    w.job = None
                    self._respawn(w)
                    job.outcome.worker_deaths += 1
                    self._requeue(job, pending, retries)
                    if job.ready_at < 0:
                        done += 1
                    continue
                w.job = None
                if msg[0] == "ok":
                    path = os.path.join(self.cache_dir, job.key + ".json")
                    write_record(path, msg[2])
                    # serve the JSON round-trip, exactly like a cache hit
                    job.outcome.record = load_record(path)
                    self.n_measured += 1
                    done += 1
                else:
                    job.outcome.error = msg[2]
                    self._requeue(job, pending, retries)
                    if job.ready_at < 0:
                        done += 1
            # watchdog: kill workers past their deadline
            now = time.monotonic()
            for w in [x for x in self._workers if x.job is not None]:
                if now < w.deadline:
                    continue
                job = w.job
                w.job = None
                self._respawn(w)
                timeout = job.req.get("timeout") or self.timeout
                self.n_timeouts += 1
                job.outcome.timeouts += 1
                job.outcome.error = (
                    f"watchdog: no result within {timeout:.1f}s"
                    f"+{self.grace_s:.1f}s grace"
                )
                self._requeue(job, pending, retries)
                if job.ready_at < 0:
                    done += 1

    # -- conveniences ---------------------------------------------------
    def measure_cell(
        self,
        arch: str,
        shape: str,
        mesh: str = "single",
        plan=None,
        devices: Optional[int] = None,
        extras: Optional[dict] = None,
        *,
        hw: str = "h100",
        device: Optional[str] = None,
        cut: Optional[dict] = None,
    ) -> dict:
        """Strict single-request measurement (raises on failure) —
        fleet-backed drop-in for ``measure.measure_cell``."""
        req = make_request(
            arch, shape, mesh, plan, devices, self.timeout, extras=extras,
            hw=hw, device=device, cut=cut,
        )
        out = self.measure_many([req])[0]
        if not out.ok:
            raise RuntimeError(
                f"fleet measurement failed for {arch}×{shape}×{mesh} "
                f"after {out.attempts} attempt(s): {out.error}"
            )
        return out.record

    def bind(
        self,
        arch: str,
        shape: str,
        mesh: str = "single",
        devices: Optional[int] = None,
        *,
        hw: str = "h100",
        device: Optional[str] = None,
        cut: Optional[dict] = None,
    ) -> "FleetMeasure":
        """A ``FleetMeasure`` of one cell on hardware ``hw``; ``device`` and
        ``cut`` go into every request (a card target reads them).  Card
        measurements take a one-worker fleet."""
        if device == "cuda" and self.n_workers != 1:
            raise ValueError(
                f"card measurements take a one-worker fleet, not {self.n_workers}: "
                "two processes timing on one GPU spoil each other's times"
            )
        return FleetMeasure(self, arch, shape, mesh, devices, hw=hw, device=device, cut=cut)

    def stats(self) -> dict:
        return {
            "n_workers": self.n_workers,
            "n_requests": self.n_requests,
            "n_cache_hits": self.n_cache_hits,
            "n_deduped": self.n_deduped,
            "n_measured": self.n_measured,
            "n_retries": self.n_retries,
            "n_timeouts": self.n_timeouts,
            "n_failures": self.n_failures,
            "n_worker_restarts": self.n_worker_restarts,
        }


class FleetMeasure:
    """``measure_fn``-shaped adapter over a fleet, bound to one cell.

    ``__call__`` is the strict scalar interface existing callers expect
    (plan → step seconds, raises on failure); ``measure_plans`` is the
    batch interface the ensemble's re-rank prefetch uses — one
    ``measure_many`` fan-out, ``None`` per failed plan so the caller can
    degrade that candidate to its analytic estimate.
    """

    def __init__(self, fleet: MeasurementFleet, arch, shape, mesh, devices, *,
                 hw: str = "h100", device: Optional[str] = None,
                 cut: Optional[dict] = None):
        self.fleet = fleet
        self.arch, self.shape = arch, shape
        self.mesh, self.devices = mesh, devices
        self.hw, self.device, self.cut = hw, device, cut

    def _request(self, plan) -> dict:
        return make_request(
            self.arch, self.shape, self.mesh, plan, self.devices,
            self.fleet.timeout, hw=self.hw, device=self.device, cut=self.cut,
        )

    def __call__(self, plan) -> float:
        out = self.fleet.measure_many([self._request(plan)])[0]
        if not out.ok:
            raise RuntimeError(
                f"fleet measurement failed for {self.arch}×{self.shape}"
                f"×{self.mesh}: {out.error}"
            )
        return float(out.record["step_s"])

    def measure_plans(self, plans) -> List[Optional[float]]:
        outs = self.fleet.measure_many([self._request(p) for p in plans])
        return [
            float(o.record["step_s"]) if o.ok else None for o in outs
        ]

    def stats(self) -> dict:
        return self.fleet.stats()

"""Tuner-as-a-service: the long-lived daemon loop (the port of the JAX
package's ``service/daemon.py``).

``TunerService`` is the in-process core (directly usable from tests and
benchmarks, no socket): requests arrive as plain dicts, the plan store
answers repeats instantly, and cold requests run the normal search — but
against *persistent* shared machinery instead of one-shot copies:

* one ``PinnedWorkerPool`` across ALL runs — worker processes spawn once
  per daemon, each run rebinds them to its trees
  (``PinnedWorkerPool.rebind``) and ships per-round deltas as usual;
* one ``MeasurementFleet`` across all measuring runs;
* one in-memory ``TranspositionCache`` per cell, warm-started from the
  store's cell tier and synced back after every run (exact-wins both
  ways, see ``service/store.py``).

Cold-path results are bit-identical to one-shot ``autotune()`` — the
warm cache is a pure memo of exact values, so plan/cost/decisions match
and only eval counts drop.

Each request is priced for the hardware it names (``hw``, default
``"h100"``; it is part of every store key, so an H100 request is never
answered with a TPU plan).  Where the daemon computes with torch — a
learned cost model, ``pricing="jit"``, and ``measure="real"``'s card
measurements — it does so on its ``device``; ``cut`` is the depth/size cut
of its card measurements (``launch/measure.py``).  Both are daemon
settings, not request fields, and neither enters a store key: daemons that
share a store root must share them (the operator's responsibility, as the
measurement target is in the JAX package).

Crash safety and deadlines ride on the round-boundary ``RunController``
seam (``repro_torch.core.run_control``):

* every search is **journaled** before it starts and released after its
  result lands (``store.journal_begin``/``journal_release``), and
  **checkpointed** every ``checkpoint_every`` decision rounds
  (``store.save_checkpoint`` — pickled ``ProTuner.snapshot()``s,
  atomically published).  ``recover()`` replays pending journal entries
  on restart, resuming from the checkpoint — the recovered result is
  bit-identical to an uninterrupted run (SIGKILL-tested);
* a per-request ``deadline_s`` execution knob interrupts the search at
  the next round boundary: the caller gets best-so-far with
  ``result["stats"]["interrupted"]`` provenance, the checkpoint is KEPT
  (a retry resumes and completes), and the partial result is never
  recorded as the stored plan;
* a failed search syncs the warm cell cache (the progress it DID make),
  releases its journal/checkpoint state, and returns structured error
  provenance (``error_info``) instead of a bare ``{"ok": false}``;
* a health watchdog **degrades** a repeatedly-restarting pinned pool
  (``degrade_after`` cumulative worker restarts) to the bit-identical
  sequential engine, counted on ``stats()``.

``serve_forever`` wraps the service in a Unix-domain-socket JSON-lines
protocol (one request object per line, one response object per line):

    {"op": "tune", "arch": ..., "shape": ..., "algo": ..., ...}
    {"op": "stats"} | {"op": "ping"} | {"op": "shutdown"}

The front end is concurrent and supervised: a threaded accept loop, a
read timeout per accepted connection (a silent client is closed, never
blocking the daemon), and a bounded request queue drained by ONE search
worker (the pool/cells/fleet are single-run state) — a full queue
answers ``{"ok": false, "error": "overloaded", "retry_after_s": ...}``
immediately.  Shutdown cancels the in-flight search (it checkpoints and
returns best-so-far to its waiting client) and answers queued requests
with ``shutting_down``.

``repro_torch.launch.tune_serve`` is the CLI for both ends.
"""
from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.autotuner import autotune, make_mdp
from repro_torch.core.engine.cache import CachedMDP, TranspositionCache
from repro_torch.core.engine.workers import PinnedWorkerPool
from repro_torch.core.run_control import RunController
from repro_torch.service.store import (
    PlanStore,
    canonical_request,
    cell_key,
    request_hw,
    request_key,
)

_EXEC_KEYS = ("engine", "parallel", "n_workers", "shm", "worker_batch",
              "deadline_s")


class _CellState:
    """Daemon-lifetime state for one cell: the shared in-memory cache and
    the store-sync cursor (``None`` until the first sync → full export)."""

    __slots__ = ("cache", "store_wm")

    def __init__(self):
        self.cache = TranspositionCache()
        self.store_wm = None


class _LatencyRing:
    """Fixed-size ring of recent per-request latencies with running
    aggregates — a long-lived daemon must not grow per-request state.
    ``append``/``len`` keep the old list surface; ``summary`` feeds
    ``stats()`` (running count/mean over ALL requests, p50/p99 over the
    retained window)."""

    __slots__ = ("cap", "buf", "_idx", "count", "total")

    def __init__(self, cap: int = 256):
        self.cap = max(int(cap), 1)
        self.buf: List[float] = []
        self._idx = 0
        self.count = 0
        self.total = 0.0

    def append(self, dt: float) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(dt)
        else:
            self.buf[self._idx] = dt
            self._idx = (self._idx + 1) % self.cap
        self.count += 1
        self.total += dt

    def __len__(self) -> int:
        return self.count

    def percentile(self, q: float) -> Optional[float]:
        if not self.buf:
            return None
        s = sorted(self.buf)
        return s[min(int(q * len(s)), len(s) - 1)]

    def summary(self) -> dict:
        return {
            "count": self.count,
            "window": len(self.buf),
            "mean_s": self.total / self.count if self.count else 0.0,
            "p50_s": self.percentile(0.50),
            "p99_s": self.percentile(0.99),
        }


class TunerService:
    def __init__(
        self,
        store_dir: str,
        *,
        parallel: bool = False,
        n_workers: Optional[int] = None,
        measure: str = "none",
        fleet_kwargs: Optional[dict] = None,
        log=print,
        checkpoint_every: int = 4,
        deadline_s: Optional[float] = None,
        round_delay_s: float = 0.0,
        degrade_after: int = 5,
        latency_window: int = 256,
        device: str = "cuda",
        cut: Optional[dict] = None,
    ):
        assert measure in ("none", "stub", "real"), measure
        self.store = PlanStore(store_dir)
        self.parallel = parallel
        self.n_workers = n_workers
        self.measure = measure
        self.fleet_kwargs = dict(fleet_kwargs or {})
        # where learned models, pricing="jit" and card measurements run,
        # and the cut of a card measurement (launch/measure.py)
        self.device = device
        self.cut = dict(cut) if cut else None
        self.log = log
        # crash-safety / deadline knobs: checkpoint cadence in decision
        # rounds (0 disables checkpoints AND journal resume), the default
        # per-request deadline (None = unbounded; requests override with
        # the ``deadline_s`` exec knob), the deterministic per-round
        # fault-injection delay (tests/benchmarks only), and the watchdog
        # threshold on cumulative pool worker restarts
        self.checkpoint_every = checkpoint_every
        self.deadline_s = deadline_s
        self.round_delay_s = round_delay_s
        self.degrade_after = degrade_after
        self.cells: Dict[str, _CellState] = {}
        self.pool: Optional[PinnedWorkerPool] = None
        self.fleet = None
        self.n_requests = 0
        self.n_searches = 0
        self.n_errors = 0
        self.n_interrupted = 0
        self.n_recovered = 0
        self.degraded = False  # watchdog tripped: sequential engine only
        self.n_pool_restarts = 0  # last observed cumulative restart count
        self.time_to_plan = _LatencyRing(latency_window)
        self._active_controller: Optional[RunController] = None

    # -- shared machinery (lazy, daemon-lifetime) ----------------------
    def _shared_pool(self, mdp) -> Optional[PinnedWorkerPool]:
        if not self.parallel or self.degraded:
            return None
        if self.pool is None:
            # pre-spawn at the requested width with no trees; every run
            # rebinds (workers.py keeps the width for empty trees)
            self.pool = PinnedWorkerPool([], mdp, n_workers=self.n_workers)
        return self.pool

    def _shared_fleet(self):
        if self.measure == "none":
            return None
        if self.fleet is None:
            from repro_torch.core.measure_fleet import MeasurementFleet

            fkw = dict(self.fleet_kwargs)
            if self.measure == "stub":
                from repro_torch.core.measure_stub import stub_measure

                fkw.setdefault("target", stub_measure)
            else:
                # the card's one timing process, its weights resident
                # across requests (launch/measure.CardTarget)
                from repro_torch.launch.measure import CardTarget

                fkw.setdefault("target", CardTarget())
                fkw.setdefault("n_workers", 1)
            fkw.setdefault(
                "cache_dir", os.path.join(self.store.root, "measure_cache"))
            self.fleet = MeasurementFleet(**fkw)
        return self.fleet

    # -- request handling ----------------------------------------------
    def handle(self, request: dict) -> dict:
        """One tuning request → one response dict.  ``request`` carries
        the ``canonical_request`` settings plus optional execution knobs
        (engine/parallel/n_workers/shm/worker_batch/deadline_s), which
        never enter the store key.  Never raises: a failed request
        returns ``ok=False`` with the legacy ``error`` string plus
        structured ``error_info`` provenance."""
        t0 = time.perf_counter()
        self.n_requests += 1
        req = None
        try:
            exec_knobs = {k: request[k] for k in _EXEC_KEYS if k in request}
            req = canonical_request(**{
                k: v for k, v in request.items() if k not in _EXEC_KEYS})
            res = self.store.lookup(req)
            served = "store"
            if res is None:
                res = self._tune(req, exec_knobs)
                served = "search"
        except Exception as e:  # noqa: BLE001 - a bad request never kills the daemon
            dt = time.perf_counter() - t0
            self.n_errors += 1
            self.time_to_plan.append(dt)
            return {
                "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "error_info": {
                    "type": type(e).__name__,
                    "message": str(e),
                    "phase": "request" if req is None else "search",
                    "request": req if req is not None else request,
                },
                "time_to_plan_s": dt,
            }
        dt = time.perf_counter() - t0
        self.time_to_plan.append(dt)
        return {
            "ok": True,
            "served": served,
            "request": req,
            "time_to_plan_s": dt,
            "result": res.to_dict(),
        }

    def _tune(self, req: dict, exec_knobs: dict):
        ckey = cell_key(req)
        cell = self.cells.setdefault(ckey, _CellState())
        if not cell.cache.n_entries:
            n = self.store.warm_cell(
                ckey, cell.cache, include_learned=req["cost"] != "analytic")
            if n:
                self.log(f"[tuner-service] cell {ckey[:8]}: warmed "
                         f"{n} entries from store")
        # a "pricing" entry in the canonical request is the versioned jit
        # kernel tag (store.canonical_request); absent means exact
        hw = request_hw(req)
        mdp = CachedMDP(make_mdp(
            req["arch"], req["shape"], req["mesh"],
            req["noise_sigma"], req["noise_seed"],
            pricing="jit" if req.get("pricing") else None, hw=hw,
            device=self.device,
        ), cache=cell.cache)
        fleet = self._shared_fleet()
        measure_backend = None
        if fleet is not None and "real" in req["algo"]:
            card = self.measure == "real"
            measure_backend = fleet.bind(
                req["arch"], req["shape"], req["mesh"], hw=hw,
                device=self.device if card else None,
                cut=self.cut if card else None)
        parallel = exec_knobs.get("parallel", self.parallel)
        if self.degraded:
            # watchdog tripped: the sequential engine is certified
            # bit-identical to the pool, so degrading changes nothing but
            # wall clock
            parallel = False
        controller = RunController(
            deadline_s=exec_knobs.get("deadline_s", self.deadline_s),
            checkpoint_every=self.checkpoint_every,
            checkpoint_fn=(
                (lambda snap: self.store.save_checkpoint(req, snap))
                if self.checkpoint_every else None
            ),
            round_delay_s=self.round_delay_s,
        )
        resume = (
            self.store.load_checkpoint(req) if self.checkpoint_every else None
        )
        # write-ahead journal: the request is on record BEFORE the search
        # starts, so a crash anywhere below leaves a pending entry for
        # recover() to replay
        self.store.journal_begin(req)
        self._active_controller = controller
        self.n_searches += 1
        try:
            res = autotune(
                req["arch"], req["shape"],
                algo=req["algo"], mesh=req["mesh"], seed=req["seed"],
                n_standard=req["n_standard"], n_greedy=req["n_greedy"],
                time_budget_s=req["time_budget_s"],
                noise_sigma=req["noise_sigma"], cost=req["cost"],
                mdp=mdp,
                engine=exec_knobs.get("engine", "array"),
                parallel=parallel,
                n_workers=exec_knobs.get("n_workers", self.n_workers),
                worker_pool=self._shared_pool(mdp) if parallel else None,
                shm=exec_knobs.get("shm"),
                worker_batch=exec_knobs.get("worker_batch"),
                measure_backend=measure_backend,
                controller=controller,
                resume=resume,
                hw=hw,
                device=self.device,
            )
        except Exception:
            # the search's progress lives in the warm cell cache — persist
            # it before surfacing the error, then release the journal and
            # checkpoint so a poisoned request is not replayed forever on
            # every restart (the caller gets structured provenance and
            # decides whether to retry)
            cell.store_wm = self.store.sync_cell(
                ckey, cell.cache, cell.store_wm)
            self.store.journal_release(req)
            self.store.clear_checkpoint(req)
            raise
        finally:
            self._active_controller = None
            self._watchdog()
        if (res.stats or {}).get("interrupted"):
            # deadline/cancel best-so-far: answer the caller, KEEP the
            # checkpoint (a retry resumes and completes), never record the
            # partial plan (store.record also guards)
            self.n_interrupted += 1
        else:
            self.store.record(req, res)
            self.store.clear_checkpoint(req)
        cell.store_wm = self.store.sync_cell(ckey, cell.cache, cell.store_wm)
        self.store.journal_release(req)
        return res

    # -- crash recovery ------------------------------------------------
    def recover(self) -> int:
        """Replay the write-ahead journal: every pending entry is a
        request that was accepted but never released (the daemon died
        mid-search).  An entry whose plan actually landed (death between
        ``record`` and ``journal_release``) is just released; the rest
        re-run through ``_tune``, which picks the round-boundary
        checkpoint up automatically — the replay RESUMES rather than
        starting over, and its result is bit-identical to an
        uninterrupted run.  Returns the number of requests re-run."""
        n = 0
        swept = self.store.sweep_tmp()
        if swept:
            self.log(f"[tuner-service] swept {swept} orphaned tmp file(s) "
                     f"from a crashed writer")
        for req in self.store.pending_requests():
            key = request_key(req)
            if self.store.lookup(req) is not None:
                self.store.journal_release(req)
                self.store.clear_checkpoint(req)
                continue
            self.log(f"[tuner-service] recovering journaled request {key}")
            self.n_requests += 1
            try:
                self._tune(req, {})
            except Exception as e:  # noqa: BLE001 - recovery must not kill startup
                self.n_errors += 1
                self.log(f"[tuner-service] recovery of {key} failed: "
                         f"{type(e).__name__}: {e}")
                continue
            n += 1
            self.n_recovered += 1
        return n

    # -- supervision ---------------------------------------------------
    def cancel_active(self) -> None:
        """Cancel the in-flight search, if any (thread-safe; called by
        the socket front end on shutdown).  The search finishes its
        current round, checkpoints, and returns best-so-far to whoever
        is waiting on it."""
        controller = self._active_controller
        if controller is not None:
            controller.cancel()

    def _watchdog(self) -> None:
        """Health check after every search: a pool whose workers keep
        dying gets shut down and the daemon degrades to the sequential
        engine (certified bit-identical — same plans, no worker
        processes to babysit)."""
        if self.pool is None or self.degraded:
            return
        restarts = self.pool.n_worker_restarts
        self.n_pool_restarts = restarts
        if restarts >= self.degrade_after:
            self.log(
                f"[tuner-service] pool hit {restarts} worker restarts "
                f"(threshold {self.degrade_after}); degrading to the "
                f"sequential engine")
            pool, self.pool = self.pool, None
            self.degraded = True
            try:
                pool.shutdown()
            except Exception:  # noqa: BLE001 - a dying pool must not block degrade
                pass

    def stats(self) -> dict:
        out = {
            "n_requests": self.n_requests,
            "n_searches": self.n_searches,
            "n_errors": self.n_errors,
            "n_interrupted": self.n_interrupted,
            "n_recovered": self.n_recovered,
            "degraded": self.degraded,
            "pool_restarts": self.n_pool_restarts,
            "time_to_plan": self.time_to_plan.summary(),
            "store": self.store.stats(),
            "cells": {k: v.cache.stats() for k, v in self.cells.items()},
        }
        if self.fleet is not None:
            out["fleet"] = self.fleet.stats()
        if self.pool is not None:
            out["pool"] = {
                "submit_bytes": self.pool.submit_bytes,
                "return_bytes": self.pool.return_bytes,
                "snapshot_bytes": self.pool.snapshot_bytes,
                # last run's serving split + cross-worker duplicate evals
                # (per-worker hit/miss/dedup counters) + restart counts,
                # cumulative and since the last rebind
                **self.pool.stats(),
            }
        return out

    def shutdown(self) -> None:
        if self.pool is not None:
            self.pool.shutdown()
            self.pool = None
        if self.fleet is not None:
            self.fleet.shutdown()
            self.fleet = None


# ---------------------------------------------------------------------------
# Socket front end (JSON lines over a Unix domain socket)
# ---------------------------------------------------------------------------
class _Job:
    """One queued tune request: the message, a slot for the response, and
    the event its connection thread waits on."""

    __slots__ = ("msg", "result", "done")

    def __init__(self, msg: dict):
        self.msg = msg
        self.result: Optional[dict] = None
        self.done = threading.Event()

    def finish(self, out: dict) -> None:
        self.result = out
        self.done.set()


class _Server:
    """Threaded front end state: the accept loop spawns one reader
    thread per connection; tune requests flow through a bounded queue
    into ONE search-worker thread (the pool/cells/fleet are single-run
    state, so searches serialize); ping/stats/shutdown answer inline on
    the connection thread, so they work while a search is running."""

    def __init__(self, service: TunerService, *, max_requests: Optional[int],
                 queue_size: int, read_timeout_s: float):
        self.service = service
        self.max_requests = max_requests
        self.read_timeout_s = read_timeout_s
        self.q: "queue.Queue[_Job]" = queue.Queue(maxsize=max(queue_size, 1))
        self.stop = threading.Event()
        self.served = 0  # successful tune responses (max_requests counts these)
        self.n_overloaded = 0
        self.n_idle_closed = 0

    # -- search worker -------------------------------------------------
    def worker_loop(self) -> None:
        while True:
            try:
                job = self.q.get(timeout=0.05)
            except queue.Empty:
                if self.stop.is_set():
                    return
                continue
            if self.stop.is_set():
                job.finish({"ok": False, "error": "shutting_down"})
                continue
            try:
                out = self.service.handle(job.msg)
            except Exception as e:  # noqa: BLE001 - handle() shouldn't raise; belt & braces
                out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            if out.get("ok"):
                self.served += 1
            job.finish(out)
            if (self.max_requests is not None
                    and self.served >= self.max_requests):
                self.stop.set()
                return

    def drain(self) -> None:
        """Answer every still-queued job after stop — no client is left
        waiting on a dead queue."""
        while True:
            try:
                job = self.q.get_nowait()
            except queue.Empty:
                return
            job.finish({"ok": False, "error": "shutting_down"})

    # -- per-connection reader -----------------------------------------
    def client_loop(self, conn: socket.socket) -> None:
        conn.settimeout(self.read_timeout_s)
        try:
            with conn, conn.makefile("rwb") as f:
                while not self.stop.is_set():
                    try:
                        line = f.readline()
                    except socket.timeout:
                        # a silent client no longer wedges the daemon:
                        # close the idle connection and move on
                        self.n_idle_closed += 1
                        self.service.log(
                            "[tuner-service] closing idle connection")
                        return
                    except OSError:
                        return
                    if not line:
                        return  # clean client close
                    line = line.strip()
                    if not line:
                        continue
                    out = self.dispatch(line)
                    try:
                        f.write((json.dumps(out) + "\n").encode())
                        f.flush()
                    except OSError:
                        return
        except Exception as e:  # noqa: BLE001 - one bad connection never kills the daemon
            self.service.log(f"[tuner-service] connection error: {e!r}")

    def _retry_after(self) -> float:
        """Back-off hint for overloaded clients: the recent p50 search
        latency times the queue they'd be behind."""
        p50 = self.service.time_to_plan.summary().get("p50_s") or 1.0
        return round(p50 * (self.q.qsize() + 1), 3)

    def dispatch(self, line: bytes) -> dict:
        try:
            msg = json.loads(line)
            op = msg.pop("op", "tune")
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if op == "ping":
            return {"ok": True, "pong": True}
        if op == "stats":
            try:
                stats = self.service.stats()
            except Exception as e:  # noqa: BLE001
                return {"ok": False, "error": f"{type(e).__name__}: {e}"}
            stats["serve"] = {
                "served": self.served,
                "queue_depth": self.q.qsize(),
                "n_overloaded": self.n_overloaded,
                "n_idle_closed": self.n_idle_closed,
            }
            return {"ok": True, "stats": stats}
        if op == "shutdown":
            self.stop.set()
            # graceful drain-and-checkpoint: the in-flight search stops at
            # its next round boundary, checkpoints, and answers its client
            # with best-so-far; queued jobs get "shutting_down"
            self.service.cancel_active()
            return {"ok": True, "stopping": True}
        if op != "tune":
            return {"ok": False, "error": f"unknown op {op!r}"}
        if self.stop.is_set():
            return {"ok": False, "error": "shutting_down"}
        job = _Job(msg)
        try:
            self.q.put_nowait(job)
        except queue.Full:
            # bounded-queue backpressure: an explicit, immediate response
            # beats an unbounded queue growing until the box dies
            self.n_overloaded += 1
            return {"ok": False, "error": "overloaded",
                    "retry_after_s": self._retry_after()}
        job.done.wait()
        return job.result


def serve_forever(service: TunerService, socket_path: str,
                  *, max_requests: Optional[int] = None,
                  read_timeout_s: float = 30.0,
                  queue_size: int = 16,
                  recover: bool = True) -> int:
    """Supervised accept loop: one JSON object per line in, one per line
    out, concurrent connections, bounded tune queue (see ``_Server``).
    ``max_requests`` bounds the loop for tests/CI smoke (counting
    SUCCESSFUL tune responses, as before).  ``recover=True`` replays the
    write-ahead journal before accepting — clients connecting during
    recovery queue in the listen backlog.  Returns the number of
    requests served."""
    if os.path.exists(socket_path):
        os.remove(socket_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server = _Server(service, max_requests=max_requests,
                     queue_size=queue_size, read_timeout_s=read_timeout_s)
    worker = threading.Thread(
        target=server.worker_loop, name="tune-worker", daemon=True)
    conn_threads: List[threading.Thread] = []
    try:
        srv.bind(socket_path)
        srv.listen(16)
        srv.settimeout(0.1)  # poll the stop flag between accepts
        worker.start()
        if recover:
            try:
                n = service.recover()
                if n:
                    service.log(
                        f"[tuner-service] recovered {n} journaled request(s)")
            except Exception as e:  # noqa: BLE001 - never refuse to start
                service.log(f"[tuner-service] journal recovery failed: {e!r}")
        service.log(f"[tuner-service] listening on {socket_path}")
        while not server.stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(
                target=server.client_loop, args=(conn,), daemon=True)
            t.start()
            conn_threads.append(t)
    finally:
        server.stop.set()
        service.cancel_active()
        worker.join(timeout=60.0)
        server.drain()
        for t in conn_threads:
            t.join(timeout=5.0)
        srv.close()
        if os.path.exists(socket_path):
            os.remove(socket_path)
        service.shutdown()
    return server.served

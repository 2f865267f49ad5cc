"""The port's tuner service (``repro_torch.service``): the counterpart of
each behaviour of the JAX package's ``tests/test_tuner_service.py`` (plan
store durability, quarantine, exact-wins, warm starts that never change
results, plan-tier hits with zero search, the socket protocol, the shared
pool, crash safety with the SIGKILL resume, deadlines, backpressure and the
watchdog), on the port's default hardware ``hw="h100"``; and the store's
keys against the JAX package's: equal for a ``"tpu-v5e"`` request, never
equal for an ``"h100"`` one, so a shared store root never answers an H100
request with a TPU plan.  Everything here is analytic: no torch runs."""
import json
import os
import threading

import pytest
import torch

from repro.service import TunerService as JaxTunerService
from repro.service.store import (
    PlanStore as JaxPlanStore, canonical_request as jax_canonical_request,
    cell_key as jax_cell_key, request_key as jax_request_key,
)
from repro_torch.core.autotuner import autotune
from repro_torch.core.engine.cache import TranspositionCache
from repro_torch.service import (
    PlanStore,
    TunerService,
    canonical_request,
    cell_key,
    serve_forever,
)
from repro_torch.service.store import request_key

from conftest import TRAIN_CELL as CELL

torch.set_num_threads(1)

REQ = dict(arch=CELL[0], shape=CELL[1], algo="mcts_1s", seed=0,
           n_standard=2, n_greedy=1)


def _service(tmp_path, **kw):
    kw.setdefault("log", lambda *a: None)
    return TunerService(str(tmp_path / "store"), **kw)


# ---------------------------------------------------------------------------
# Store tier: round-trip, quarantine, exact-wins
# ---------------------------------------------------------------------------
def test_plan_roundtrip_bit_identical(tmp_path):
    store = PlanStore(str(tmp_path / "store"))
    req = canonical_request(**REQ)
    assert store.lookup(req) is None
    res = autotune(CELL[0], CELL[1], algo="mcts_1s", seed=0,
                   n_standard=2, n_greedy=1)
    store.record(req, res)
    hit = store.lookup(req)
    assert hit is not None and hit.from_store
    # JSON float round-trip is exact (shortest repr), so the stored
    # result is the original bit-for-bit
    assert hit.plan == res.plan
    assert hit.cost == res.cost
    assert hit.decisions == res.decisions


def test_request_key_excludes_execution_knobs():
    # engine/parallel/n_workers never reach the canonical request — the
    # engines are certified bit-identical, so one stored plan answers all
    a = canonical_request(**REQ)
    b = canonical_request(**REQ, engine="reference", parallel=True,
                          n_workers=7)
    assert request_key(a) == request_key(b)
    c = canonical_request(**dict(REQ, seed=1))
    assert request_key(a) != request_key(c)


def test_corrupt_plan_entry_quarantined(tmp_path):
    store = PlanStore(str(tmp_path / "store"))
    req = canonical_request(**REQ)
    path = store._plan_path(req)
    with open(path, "w") as f:
        f.write('{"version": 1, "result": {"cost"')  # torn write
    assert store.lookup(req) is None
    assert not os.path.exists(path)  # quarantined, not served forever
    # schema-violating but valid JSON is quarantined too
    with open(path, "w") as f:
        json.dump({"version": 1, "result": {}}, f)
    assert store.lookup(req) is None
    assert not os.path.exists(path)


def test_corrupt_cell_entry_quarantined(tmp_path):
    store = PlanStore(str(tmp_path / "store"))
    ckey = cell_key(canonical_request(**REQ))
    cache = TranspositionCache()
    cache.terminal[(1, 2, 3)] = 0.5
    store.sync_cell(ckey, cache, None)
    path = store._cell_path(ckey)
    with open(path, "w") as f:
        f.write('{"version": 1, "terminal": [[')  # truncated
    fresh = TranspositionCache()
    assert store.warm_cell(ckey, fresh) == 0
    assert fresh.n_entries == 0
    assert not os.path.exists(path)
    # and the next sync republishes cleanly from the in-memory cache
    store.sync_cell(ckey, cache, None)
    assert store.warm_cell(ckey, fresh) == 1
    assert fresh.terminal[(1, 2, 3)] == 0.5


def test_two_writers_converge_exact_wins(tmp_path):
    """Two daemons race on one cell: whatever the sync order, a learned
    prediction never shadows an exact analytic entry on disk."""
    store = PlanStore(str(tmp_path / "store"))
    ckey = "cafecafecafecafecafe"
    exact = TranspositionCache()
    exact.terminal[(0, 1)] = 0.5
    learned = TranspositionCache()
    learned.terminal[(0, 1)] = 0.9
    learned.terminal_version[(0, 1)] = 3
    learned.terminal[(0, 2)] = 0.7  # untagged entry unique to this writer

    for first, second in ((exact, learned), (learned, exact)):
        for f in os.listdir(store.cells_dir):
            os.remove(os.path.join(store.cells_dir, f))
        store.sync_cell(ckey, first, None)
        store.sync_cell(ckey, second, None)
        merged = TranspositionCache()
        store.warm_cell(ckey, merged, include_learned=True)
        assert merged.terminal[(0, 1)] == 0.5, "learned shadowed exact"
        assert (0, 1) not in merged.terminal_version
        assert merged.terminal[(0, 2)] == 0.7  # both writers' entries kept


def test_warm_start_excludes_learned_by_default(tmp_path):
    store = PlanStore(str(tmp_path / "store"))
    cache = TranspositionCache()
    cache.terminal[(0, 1)] = 0.5
    cache.terminal[(0, 2)] = 0.9
    cache.terminal_version[(0, 2)] = 4  # a model prediction
    store.sync_cell("k" * 20, cache, None)
    fresh = TranspositionCache()
    # an analytic run must only see exact entries (values change nothing,
    # so plan/cost/decisions stay bit-identical to a cold run)
    assert store.warm_cell("k" * 20, fresh) == 1
    assert fresh.terminal == {(0, 1): 0.5}
    both = TranspositionCache()
    assert store.warm_cell("k" * 20, both, include_learned=True) == 2
    assert both.terminal_version == {(0, 2): 4}


def test_sync_cell_is_incremental(tmp_path):
    store = PlanStore(str(tmp_path / "store"))
    cache = TranspositionCache()
    cache.terminal[(0,)] = 1.0
    wm = store.sync_cell("a" * 20, cache, None)
    cache.terminal[(1,)] = 2.0
    # second sync ships only the delta but the stored state keeps both
    store.sync_cell("a" * 20, cache, wm)
    fresh = TranspositionCache()
    assert store.warm_cell("a" * 20, fresh) == 2


# ---------------------------------------------------------------------------
# Daemon: plan-tier hits, warm cells, restart persistence
# ---------------------------------------------------------------------------
def test_repeat_request_is_store_hit_zero_search(tmp_path):
    svc = _service(tmp_path)
    out1 = svc.handle(dict(REQ))
    out2 = svc.handle(dict(REQ))
    assert out1["served"] == "search" and out2["served"] == "store"
    assert svc.n_searches == 1  # the repeat ran no search
    assert out2["result"]["from_store"]
    assert out2["result"]["plan"] == out1["result"]["plan"]
    assert out2["result"]["cost"] == out1["result"]["cost"]
    svc.shutdown()


def test_store_warm_starts_fresh_process(tmp_path):
    """A store populated by one service answers a FRESH service's repeat
    request with no search at all, and warm-starts the cell cache for a
    new (different-seed) request without changing its result."""
    svc1 = _service(tmp_path)
    out1 = svc1.handle(dict(REQ))
    svc1.shutdown()

    svc2 = _service(tmp_path)
    out2 = svc2.handle(dict(REQ))
    assert out2["served"] == "store" and svc2.n_searches == 0
    assert out2["result"]["plan"] == out1["result"]["plan"]

    # new seed on the same cell: searches, but from a warmed cache —
    # and the result matches a from-scratch run bit-for-bit
    out3 = svc2.handle(dict(REQ, seed=1))
    assert out3["served"] == "search"
    ckey = cell_key(canonical_request(**REQ))
    assert svc2.cells[ckey].cache.hits > 0  # the warm entries were used
    ref = autotune(CELL[0], CELL[1], algo="mcts_1s", seed=1,
                   n_standard=2, n_greedy=1)
    assert out3["result"]["plan"] == ref.plan.to_dict()
    assert out3["result"]["cost"] == ref.cost
    assert out3["result"]["decisions"] == ref.decisions
    svc2.shutdown()


def test_socket_protocol_roundtrip(tmp_path):
    from repro_torch.launch.tune_serve import TuneClient

    svc = _service(tmp_path)
    sock = str(tmp_path / "tuner.sock")
    t = threading.Thread(
        target=serve_forever, args=(svc, sock), kwargs={"max_requests": 2},
        daemon=True,
    )
    t.start()
    deadline = 50
    while not os.path.exists(sock) and deadline:
        deadline -= 1
        threading.Event().wait(0.1)
    client = TuneClient(sock)
    assert client.ping() == {"ok": True, "pong": True}
    out1 = client.tune(CELL[0], CELL[1], algo="mcts_1s", seed=0,
                       n_standard=2, n_greedy=1)
    assert out1["ok"] and out1["served"] == "search"
    out2 = client.tune(CELL[0], CELL[1], algo="mcts_1s", seed=0,
                       n_standard=2, n_greedy=1)
    assert out2["ok"] and out2["served"] == "store"
    assert out2["result"]["plan"] == out1["result"]["plan"]
    t.join(timeout=30)
    assert not t.is_alive()


def test_bad_request_never_kills_daemon(tmp_path):
    from repro_torch.launch.tune_serve import TuneClient

    svc = _service(tmp_path)
    sock = str(tmp_path / "tuner.sock")
    t = threading.Thread(
        target=serve_forever, args=(svc, sock), kwargs={"max_requests": 1},
        daemon=True,
    )
    t.start()
    deadline = 50
    while not os.path.exists(sock) and deadline:
        deadline -= 1
        threading.Event().wait(0.1)
    client = TuneClient(sock)
    bad = client.call({"op": "tune", "arch": "no-such-arch", "shape": "x"})
    assert not bad["ok"] and "no-such-arch" in bad["error"]
    good = client.tune(CELL[0], CELL[1], algo="mcts_1s", seed=0,
                       n_standard=2, n_greedy=1)
    assert good["ok"]
    t.join(timeout=30)


# ---------------------------------------------------------------------------
# Shared pinned pool across runs
# ---------------------------------------------------------------------------
def test_shared_pool_reused_across_runs(tmp_path):
    svc = _service(tmp_path, parallel=True, n_workers=2)
    out1 = svc.handle(dict(REQ))
    pids = {w.proc.pid for w in svc.pool._workers}
    out2 = svc.handle(dict(REQ, seed=1))
    assert {w.proc.pid for w in svc.pool._workers} == pids
    assert svc.pool.n_worker_restarts == 0
    # parallel shared-pool results == sequential one-shot results
    for out, seed in ((out1, 0), (out2, 1)):
        ref = autotune(CELL[0], CELL[1], algo="mcts_1s", seed=seed,
                       n_standard=2, n_greedy=1)
        assert out["result"]["plan"] == ref.plan.to_dict()
        assert out["result"]["cost"] == ref.cost
        assert out["result"]["decisions"] == ref.decisions
    svc.shutdown()
    assert svc.pool is None


def test_pool_rebind_direct():
    """PinnedWorkerPool.rebind repoints live workers at a new run's trees:
    same processes, same results as a fresh pool."""
    from repro_torch.core.autotuner import make_mdp
    from repro_torch.core.engine.cache import CachedMDP
    from repro_torch.core.ensemble import ProTuner
    from repro_torch.core.engine.workers import PinnedWorkerPool
    from repro_torch.core.mcts import MCTSConfig

    mc = MCTSConfig(iters_per_decision=4)
    pool = PinnedWorkerPool([], CachedMDP(make_mdp(*CELL)), n_workers=2)
    assert len(pool._workers) == 2  # empty trees keep the requested width
    try:
        pids = {w.proc.pid for w in pool._workers}
        results = []
        for seed in (0, 1):
            tuner = ProTuner(CachedMDP(make_mdp(*CELL)), n_standard=2,
                             n_greedy=1, mcts_config=mc, seed=seed,
                             worker_pool=pool)
            results.append(tuner.run())
        assert {w.proc.pid for w in pool._workers} == pids
        for seed, res in zip((0, 1), results):
            ref = ProTuner(CachedMDP(make_mdp(*CELL)), n_standard=2,
                           n_greedy=1, mcts_config=mc, seed=seed).run()
            assert res.plan == ref.plan and res.cost == ref.cost
            assert [d["action"] for d in res.decisions] == [
                d["action"] for d in ref.decisions]
    finally:
        pool.shutdown()


# ---------------------------------------------------------------------------
# autotune(plan_store=) one-shot convenience
# ---------------------------------------------------------------------------
def test_autotune_plan_store_kwarg(tmp_path):
    store = PlanStore(str(tmp_path / "store"))
    res1 = autotune(CELL[0], CELL[1], algo="mcts_1s", seed=0,
                    n_standard=2, n_greedy=1, plan_store=store)
    assert not res1.from_store
    res2 = autotune(CELL[0], CELL[1], algo="mcts_1s", seed=0,
                    n_standard=2, n_greedy=1, plan_store=store)
    assert res2.from_store
    assert res2.plan == res1.plan and res2.cost == res1.cost
    assert store.stats()["hits"] == 1


# ---------------------------------------------------------------------------
# Crash safety, deadlines, backpressure, degradation
# ---------------------------------------------------------------------------
def _ref(seed=0):
    return autotune(CELL[0], CELL[1], algo="mcts_1s", seed=seed,
                    n_standard=2, n_greedy=1)


def test_tune_error_path_syncs_cache_and_releases_journal(tmp_path, monkeypatch):
    """An exception mid-search must not drop the cell cache's progress or
    leave journal/checkpoint state behind, and the response carries
    structured provenance, not a bare ok=False."""
    svc = _service(tmp_path)
    req = canonical_request(**REQ)
    ckey = cell_key(req)

    def boom(*a, **kw):
        kw["mdp"].cache.terminal[(1, 2, 3)] = 0.125  # progress before dying
        raise RuntimeError("search exploded")

    monkeypatch.setattr("repro_torch.service.daemon.autotune", boom)
    out = svc.handle(dict(REQ))
    assert not out["ok"]
    assert "RuntimeError: search exploded" in out["error"]
    info = out["error_info"]
    assert info["type"] == "RuntimeError" and info["phase"] == "search"
    assert info["request"] == req
    assert svc.n_errors == 1
    # the progress the search DID make was synced to the store's cell tier
    fresh = TranspositionCache()
    assert svc.store.warm_cell(ckey, fresh) >= 1
    assert fresh.terminal[(1, 2, 3)] == 0.125
    # journal + checkpoint released: the failed request won't replay forever
    assert svc.store.pending_requests() == []
    assert svc.store.load_checkpoint(req) is None
    svc.shutdown()


def test_latency_ring_bounded_with_percentiles(tmp_path):
    from repro_torch.service.daemon import _LatencyRing

    ring = _LatencyRing(cap=8)
    for i in range(100):
        ring.append(float(i))
    assert len(ring.buf) == 8  # bounded, not 100
    assert ring.count == 100 and ring.total == sum(range(100))
    assert ring.percentile(0.5) in ring.buf
    s = ring.summary()
    assert s["count"] == 100 and s["window"] == 8
    assert s["p50_s"] is not None and s["p99_s"] is not None

    svc = _service(tmp_path, latency_window=4)
    for _ in range(6):
        svc.handle(dict(REQ))
    assert len(svc.time_to_plan.buf) == 4
    tp = svc.stats()["time_to_plan"]
    assert tp["count"] == 6 and tp["window"] == 4
    assert tp["p50_s"] > 0 and tp["p99_s"] > 0
    svc.shutdown()


def test_deadline_interrupt_then_resume_bit_identical(tmp_path):
    """A deadlined request returns best-so-far with provenance and keeps
    its checkpoint; the retry resumes and lands the full result — plan,
    cost, and decisions bit-identical to an uninterrupted run."""
    svc = _service(tmp_path, checkpoint_every=1, round_delay_s=0.05)
    req = canonical_request(**REQ)
    out = svc.handle(dict(REQ, deadline_s=0.12))
    assert out["ok"] and out["served"] == "search"
    info = out["result"]["stats"]["interrupted"]
    assert info["reason"] == "deadline"
    assert 0 < info["rounds_done"] < info["rounds_total"]
    assert svc.n_interrupted == 1
    # partial result never recorded; checkpoint kept; journal released
    assert svc.store.lookup(req) is None
    assert svc.store.load_checkpoint(req) is not None
    assert svc.store.pending_requests() == []

    out2 = svc.handle(dict(REQ))  # no deadline: resumes and completes
    assert out2["ok"] and out2["served"] == "search"
    assert "interrupted" not in out2["result"]["stats"]
    ref = _ref()
    assert out2["result"]["plan"] == ref.plan.to_dict()
    assert out2["result"]["cost"] == ref.cost
    assert out2["result"]["decisions"] == ref.decisions
    # completion cleared the checkpoint and recorded the plan
    assert svc.store.load_checkpoint(req) is None
    assert svc.store.lookup(req) is not None
    svc.shutdown()


def test_sweep_tmp_removes_dead_writer_debris_only(tmp_path):
    """A writer SIGKILLed between open(tmp) and os.replace orphans its
    tmp sibling; recover()'s sweep removes exactly that debris — never a
    live writer's in-flight tmp, never a published tier file."""
    store = PlanStore(str(tmp_path / "store"))
    req = canonical_request(**REQ)
    store.journal_begin(req)  # a real published tier file

    dead = os.path.join(store.checkpoints_dir, "abc.pkl.tmp.999999.deadbeef")
    live = os.path.join(store.journal_dir,
                        f"def.json.tmp.{os.getpid()}.cafe0123")
    junk = os.path.join(store.plans_dir, "ghi.json.tmp.notapid.f00d")
    for p in (dead, live, junk):
        with open(p, "w") as f:
            f.write("partial write")

    assert store.sweep_tmp() == 2  # the dead pid and the malformed pid
    assert not os.path.exists(dead) and not os.path.exists(junk)
    assert os.path.exists(live)  # this process is alive: in-flight
    assert store.pending_requests() == [req]  # tier files untouched
    os.remove(live)
    assert store.sweep_tmp() == 0  # idempotent once clean


def test_recover_replays_pending_journal(tmp_path):
    """A pending journal entry (daemon died mid-search) is replayed on
    recover(), resuming from the checkpoint, and the landed plan is
    bit-identical to an uninterrupted run."""
    svc1 = _service(tmp_path, checkpoint_every=1, round_delay_s=0.05)
    req = canonical_request(**REQ)
    svc1.handle(dict(REQ, deadline_s=0.12))  # leaves a checkpoint behind
    assert svc1.store.load_checkpoint(req) is not None
    svc1.store.journal_begin(req)  # simulate dying before journal_release
    svc1.shutdown()

    svc2 = _service(tmp_path)
    assert svc2.store.pending_requests() == [req]
    assert svc2.recover() == 1
    assert svc2.n_recovered == 1
    assert svc2.store.pending_requests() == []
    assert svc2.store.load_checkpoint(req) is None
    hit = svc2.store.lookup(req)
    ref = _ref()
    assert hit is not None
    assert hit.plan == ref.plan and hit.cost == ref.cost
    assert hit.decisions == ref.decisions
    # an entry whose plan already landed is released without re-running
    svc2.store.journal_begin(req)
    assert svc2.recover() == 0
    assert svc2.store.pending_requests() == []
    svc2.shutdown()


def test_watchdog_degrades_repeatedly_restarting_pool(tmp_path):
    """Past the restart threshold the pool is shut down and later runs go
    sequential — same results (the engines are certified bit-identical),
    no more worker processes to babysit."""
    svc = _service(tmp_path, parallel=True, n_workers=2, degrade_after=3)
    out1 = svc.handle(dict(REQ))
    assert svc.pool is not None and not svc.degraded
    svc.pool.n_worker_restarts = 3  # the pool has been dying repeatedly
    out2 = svc.handle(dict(REQ, seed=1))  # this run's watchdog trips
    assert svc.degraded and svc.pool is None
    st = svc.stats()
    assert st["degraded"] and st["pool_restarts"] == 3
    out3 = svc.handle(dict(REQ, seed=2))  # served by the sequential engine
    assert out3["ok"] and out3["served"] == "search"
    for out, seed in ((out1, 0), (out2, 1), (out3, 2)):
        ref = _ref(seed)
        assert out["result"]["plan"] == ref.plan.to_dict()
        assert out["result"]["cost"] == ref.cost
        assert out["result"]["decisions"] == ref.decisions
    svc.shutdown()


def _start_server(svc, sock, **kw):
    t = threading.Thread(target=serve_forever, args=(svc, sock), kwargs=kw,
                         daemon=True)
    t.start()
    deadline = 50
    while not os.path.exists(sock) and deadline:
        deadline -= 1
        threading.Event().wait(0.1)
    return t


def test_idle_connection_closed_not_wedging_daemon(tmp_path):
    """A client that connects and sends nothing is closed after the read
    timeout, and the daemon keeps serving other clients throughout."""
    import socket as socketlib

    from repro_torch.launch.tune_serve import TuneClient

    svc = _service(tmp_path)
    sock = str(tmp_path / "tuner.sock")
    t = _start_server(svc, sock, read_timeout_s=0.3)
    client = TuneClient(sock)
    silent = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    silent.connect(sock)  # ... and says nothing
    # the daemon answers OTHER clients while the silent one sits there
    assert client.ping() == {"ok": True, "pong": True}
    silent.settimeout(2.0)
    assert silent.recv(1) == b""  # closed by the read timeout, not hung
    silent.close()
    assert client.ping() == {"ok": True, "pong": True}
    out = client.call({"op": "shutdown"})
    assert out["ok"] and out["stopping"]
    t.join(timeout=10)
    assert not t.is_alive()


def test_overload_backpressure_and_graceful_shutdown(tmp_path):
    """With a bounded queue of 1: one request in flight, one queued, and
    every further request gets an immediate structured 'overloaded'
    response with a retry hint — nobody hangs, nobody is dropped."""
    from repro_torch.launch.tune_serve import TuneClient

    svc = _service(tmp_path, round_delay_s=0.08)
    sock = str(tmp_path / "tuner.sock")
    t = _start_server(svc, sock, queue_size=1)
    client = TuneClient(sock)

    results = {}

    def submit(name, seed):
        results[name] = client.tune(CELL[0], CELL[1], algo="mcts_1s",
                                    seed=seed, n_standard=2, n_greedy=1)

    t1 = threading.Thread(target=submit, args=("inflight", 0), daemon=True)
    t1.start()
    deadline = 100
    while svc.n_requests < 1 and deadline:  # until the search is IN handle
        deadline -= 1
        threading.Event().wait(0.05)
    t2 = threading.Thread(target=submit, args=("queued", 0), daemon=True)
    t2.start()
    deadline = 100
    while client.stats()["stats"]["serve"]["queue_depth"] < 1 and deadline:
        deadline -= 1
        threading.Event().wait(0.05)
    over1 = client.tune(CELL[0], CELL[1], algo="mcts_1s", seed=0,
                        n_standard=2, n_greedy=1)
    over2 = client.tune(CELL[0], CELL[1], algo="mcts_1s", seed=0,
                        n_standard=2, n_greedy=1)
    for over in (over1, over2):
        assert not over["ok"] and over["error"] == "overloaded"
        assert over["retry_after_s"] > 0
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert results["inflight"]["ok"] and results["inflight"]["served"] == "search"
    assert results["queued"]["ok"] and results["queued"]["served"] == "store"
    st = client.stats()["stats"]["serve"]
    assert st["n_overloaded"] == 2 and st["served"] == 2
    out = client.call({"op": "shutdown"})
    assert out["ok"]
    t.join(timeout=10)
    assert not t.is_alive()


def test_sigkill_daemon_resumes_bit_identical(tmp_path):
    """The headline crash-safety claim: SIGKILL the daemon subprocess
    mid-search, restart it on the same store dir, and the journaled
    request resumes from its round-boundary checkpoint — the final
    plan/cost/decisions are bit-identical to an uninterrupted run."""
    import signal
    import subprocess
    import sys
    import time as timelib

    from repro_torch.launch.tune_serve import TuneClient

    store = str(tmp_path / "store")
    sock = str(tmp_path / "tuner.sock")
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        "src" + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH") else "src"
    )

    def spawn(*extra):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.tune_serve", "serve",
             "--store", store, "--socket", sock,
             "--checkpoint-every", "1", "--round-delay", "0.15", *extra],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    proc = spawn()
    try:
        deadline = timelib.time() + 60
        while not os.path.exists(sock) and timelib.time() < deadline:
            timelib.sleep(0.05)
        assert os.path.exists(sock), "daemon never came up"

        def fire():
            try:
                TuneClient(sock).tune(CELL[0], CELL[1], algo="mcts_1s",
                                      seed=0, n_standard=2, n_greedy=1)
            except Exception:
                pass  # the daemon dies mid-request by design

        t = threading.Thread(target=fire, daemon=True)
        t.start()

        ckpt_dir = os.path.join(store, "checkpoints")
        journal_dir = os.path.join(store, "journal")
        deadline = timelib.time() + 60
        while timelib.time() < deadline:
            if os.path.exists(ckpt_dir) and os.listdir(ckpt_dir):
                break
            timelib.sleep(0.02)
        assert os.listdir(ckpt_dir), "no checkpoint appeared mid-search"
        proc.send_signal(signal.SIGKILL)  # mid-search, rounds left to go
        proc.wait(timeout=10)
        t.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()

    # the crash left the write-ahead journal entry pending and no plan
    assert len(os.listdir(journal_dir)) == 1
    assert os.listdir(os.path.join(store, "plans")) == []

    # restart on the same store: recovery replays the journal (resuming
    # from the checkpoint) before accepting, so the repeat request is a
    # store hit answered with the COMPLETE result
    os.remove(sock)  # the SIGKILLed daemon left a stale socket file
    proc = spawn("--max-requests", "1")
    try:
        deadline = timelib.time() + 60
        while not os.path.exists(sock) and timelib.time() < deadline:
            timelib.sleep(0.05)
        out = TuneClient(sock, timeout=120.0).tune(
            CELL[0], CELL[1], algo="mcts_1s", seed=0,
            n_standard=2, n_greedy=1)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)

    assert out["ok"] and out["served"] == "store"
    ref = _ref()
    # the socket hop JSON-serializes the plan (tuples -> lists); decode
    # back before the bit-identity comparison
    from repro_torch.core.space import SchedulePlan

    assert SchedulePlan.from_dict(out["result"]["plan"]) == ref.plan
    assert out["result"]["cost"] == ref.cost
    assert out["result"]["decisions"] == ref.decisions
    # recovery released the journal and cleared the checkpoint
    assert os.listdir(journal_dir) == []
    assert os.listdir(ckpt_dir) == []


# ---------------------------------------------------------------------------
# The hardware in the keys, against the JAX package's store
# ---------------------------------------------------------------------------
KEY_CASES = [
    dict(REQ),
    dict(REQ, mesh="multi", seed=3, cost="hybrid"),
    dict(REQ, pricing="jit", noise_sigma=0.1),
    dict(arch="falcon-mamba-7b", shape="decode_32k", algo="evolve", time_budget_s=2.0),
]


@pytest.mark.parametrize("case", range(len(KEY_CASES)))
def test_tpu_keys_equal_the_jax_keys_and_h100_keys_differ(case):
    req = KEY_CASES[case]
    jax_req = jax_canonical_request(**req)
    tpu = canonical_request(**req, hw="tpu-v5e")
    assert tpu == jax_req and "hw" not in tpu
    assert request_key(tpu) == jax_request_key(jax_req)
    assert cell_key(tpu) == jax_cell_key(jax_req)
    h100 = canonical_request(**req)  # no hw: the port's default
    assert h100 == canonical_request(**req, hw="h100") and h100["hw"] == "h100"
    assert request_key(h100) != request_key(tpu) and cell_key(h100) != cell_key(tpu)
    from repro_torch.core.hardware import H100

    assert canonical_request(**req, hw=H100) == h100  # a spec keys by its hw= name


def test_port_and_jax_services_give_the_same_tpu_result(tmp_path):
    """One ``tpu-v5e`` ``mcts_1s`` request through each package's
    ``TunerService.handle``: the same plan, exact cost and decisions."""
    jax_svc = JaxTunerService(str(tmp_path / "jax"), log=lambda *a: None)
    ref = jax_svc.handle(dict(REQ))
    jax_svc.shutdown()
    svc = _service(tmp_path)
    got = svc.handle(dict(REQ, hw="tpu-v5e"))
    svc.shutdown()
    assert ref["ok"] and got["ok"] and got["served"] == ref["served"] == "search"
    assert got["request"] == ref["request"]
    assert got["result"]["plan"] == ref["result"]["plan"]
    assert got["result"]["cost"] == ref["result"]["cost"]
    assert got["result"]["n_evals"] == ref["result"]["n_evals"]
    strip = lambda ds: [{k: v for k, v in d.items() if k != "wall_time_s"} for d in ds]  # noqa: E731
    assert strip(got["result"]["decisions"]) == strip(ref["result"]["decisions"])
    assert got["result"]["hw"] == "tpu-v5e"


def test_h100_request_never_served_from_a_tpu_entry_in_a_shared_root(tmp_path):
    """A store root the JAX package's daemon filled: the port answers the
    ``tpu-v5e`` request from it, and searches afresh for the ``h100`` one
    (whose plan differs), which never overwrites the TPU entry."""
    root = str(tmp_path / "shared")
    jax_svc = JaxTunerService(root, log=lambda *a: None)
    tpu_ref = jax_svc.handle(dict(REQ))
    jax_svc.shutdown()
    svc = TunerService(root, log=lambda *a: None)
    tpu = svc.handle(dict(REQ, hw="tpu-v5e"))
    assert tpu["served"] == "store" and tpu["result"]["plan"] == tpu_ref["result"]["plan"]
    h100 = svc.handle(dict(REQ, hw="h100"))
    assert h100["served"] == "search" and h100["result"]["hw"] == "h100"
    assert h100["result"]["plan"] != tpu_ref["result"]["plan"]
    assert h100["result"]["cost"] == autotune(CELL[0], CELL[1], algo="mcts_1s", seed=0,
                                              n_standard=2, n_greedy=1).cost
    # the two cells' caches are separate files, and each stored plan names its hw
    assert len(os.listdir(svc.store.cells_dir)) == 2
    store = PlanStore(root)
    with open(store._plan_path(canonical_request(**REQ))) as f:
        assert json.load(f)["result"]["hw"] == "h100"
    assert store.lookup(canonical_request(**REQ, hw="tpu-v5e")).plan.to_dict() == \
        tpu_ref["result"]["plan"]
    assert len(store.seed_plans(arch=CELL[0], hw="h100")) == 1
    assert len(store.seed_plans(arch=CELL[0], hw="tpu-v5e")) == 1
    assert len(store.seed_plans(arch=CELL[0])) == 2
    assert JaxPlanStore(root).lookup(jax_canonical_request(**REQ)) is not None
    svc.shutdown()


def test_autotune_cli_learned_on_the_cpu_and_repeats_from_the_store(tmp_path, capsys):
    """``python -m repro_torch.launch.autotune``: a hybrid run with the MLP on
    the CPU, recorded in ``--store``; the repeat is answered from it."""
    from repro_torch.launch import autotune as cli

    argv = ["--arch", "granite-moe-1b-a400m", "--shape", "train_4k", "--algo", "mcts_1s",
            "--mesh", "card", "--cost", "hybrid", "--device", "cpu",
            "--store", str(tmp_path / "store")]
    assert cli.main(argv) == 0
    first = capsys.readouterr().out
    assert "hw=h100 mesh=card" in first and "cost serving: hybrid on cpu" in first
    assert "(from store)" not in first
    assert cli.main(argv) == 0
    again = capsys.readouterr().out
    assert "(from store)" in again
    plan = [line for line in first.splitlines() if line.startswith("[autotune] plan:")]
    assert plan and plan == [line for line in again.splitlines()
                             if line.startswith("[autotune] plan:")]

"""ProTuner ensemble: N standard + M greedy MCTSes with synchronized roots
(paper §4.1/§4.2, pseudocode Fig. 6).

Every decision round each tree spends its budget from the shared current
root; the winning next root is the tree whose subtree found the best
complete schedule — by cost model, or by **real measurement** of each
tree's best candidate when ``measure_fn`` is given (``mcts_cost+real_*``).
All trees then advance to the same child (keeping their subtrees).

Engine layer: trees are built by ``repro_torch.core.engine.make_tree`` —
``engine="array"`` (the default: flat-array ``ArrayMCTS``, identical
results, batched UCB) or ``engine="reference"`` (the paper-faithful
``Node`` trees, kept as the oracle).  With ``cache=True`` (the default for
the array engine) all trees share one ``TranspositionCache`` so a schedule
any tree has ever priced is never re-evaluated — across trees *and* across
decision rounds.  With ``batch=True`` (also the array default) sequential
decision rounds run the trees in LOCKSTEP: each step's K concurrent
simulations queue their pending leaves into one ``terminal_cost_batch``
call (``repro_torch.core.engine.batch``) — results are identical to the
per-tree loop, and with the cache on so are the aggregate cache/eval
counters (uncached, in-batch dedup can only lower ``n_evals``).
``parallel=True`` runs each tree's decision round in PERSISTENT PINNED
workers (``engine/workers.py``): each worker process holds its subset of
the trees plus one serve-only ``CachedMDP`` for the whole run, and the
per-round traffic is a delta in BOTH directions — the master submits only
the root-advance action, the siblings' new cache entries since the
worker's last submit, and model params when the fit generation changed;
the worker returns the per-round tree delta (new/updated node slices +
this round's new cache entries).  Payload bytes at the pickle boundary
are counted and surfaced on ``TuneResult``
(``submit_bytes``/``return_bytes``/``snapshot_bytes`` + per-round lists).
Reference trees keep the stateless whole-tree ``ProcessPoolExecutor``
round trip.  Search results — plan, cost, and the decision sequence — are
identical to the sequential path for a fixed seed, and survive worker
deaths (the master reseeds a replacement from its canonical trees); the
``n_evals``/``cache_*`` counters can differ slightly when the cache is
on, because workers run against round-start cache snapshots and may
re-evaluate states a sibling priced in the same round.

Cost serving layer: ``cost="learned"|"hybrid"`` mounts a
``HybridCostBackend`` (``engine/serving.py``) inside the shared
``CachedMDP`` — the online trainer refits the §3 MLP on the cache's
analytic terminal entries at round boundaries, and the trained (confident)
model prices each miss batch in one forward pass on ``device``.  In
parallel mode workers serve but never refit (pickled backends are
serve-only); the master refits on the merged cache after each round and
ships the new model with the next round's submissions.
``cost="analytic"`` (the default) mounts nothing and stays bit-identical
to the JAX package's search.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.engine import (
    CachedMDP,
    TranspositionCache,
    make_cost_backend,
    make_tree,
)
from repro_torch.core.engine.array_mcts import ArrayMCTS
from repro_torch.core.engine.batch import run_decision_batch
from repro_torch.core.engine.workers import PinnedWorkerPool, pick_mp_context
from repro_torch.core.mcts import MCTSConfig
from repro_torch.core.mdp import ScheduleMDP, State
from repro_torch.core.space import SchedulePlan

INF = float("inf")

# ProTuner.snapshot() schema version (round-boundary checkpoints; bump on
# any change to the snapshot dict's shape so stale checkpoints are ignored
# instead of mis-restored)
SNAPSHOT_VERSION = 1

logger = logging.getLogger(__name__)


@dataclass
class TuneResult:
    plan: SchedulePlan
    cost: float  # EXACT analytic cost of the final schedule (all cost modes)
    measured: Optional[float]  # real-measured step time (if measuring)
    n_evals: int  # cost-model evaluations
    n_measurements: int
    wall_time_s: float
    decisions: List[dict] = field(default_factory=list)
    algo: str = ""
    engine: str = "reference"
    cache_hits: int = 0
    cache_misses: int = 0
    # learned-cost serving (engine/serving.py); analytic runs keep defaults
    cost_mode: str = "analytic"
    model_version: int = 0  # serving model's fit generation at run end
    n_fits: int = 0
    learned_evals: int = 0  # plans priced by the learned model
    # pinned process-pool payload accounting (parallel array runs; zeros
    # otherwise): pickled bytes crossing the pool boundary, so the
    # O(round) transport claim is a measured number (engine/workers.py)
    submit_bytes: int = 0    # master -> workers, per-round forward deltas
    return_bytes: int = 0    # workers -> master, per-round reverse deltas
    snapshot_bytes: int = 0  # init + worker-death resync shipments
    submit_bytes_rounds: List[int] = field(default_factory=list)
    return_bytes_rounds: List[int] = field(default_factory=list)
    n_worker_restarts: int = 0
    # pinned-pool serving stats (engine/workers.PinnedWorkerPool.stats):
    # per-worker hit/miss/dedup counters, the shm-vs-export serving split,
    # and the per-round cross-worker duplicate-eval counts; empty for
    # non-pool runs
    stats: dict = field(default_factory=dict)
    # candidates whose real measurement failed and were re-ranked by their
    # exact analytic cost instead (mcts_cost+real_* graceful degradation)
    n_measure_failures: int = 0
    # served from the persistent PlanStore (repro_torch.service) without a
    # search — n_evals is 0 and decisions are the stored run's
    from_store: bool = False
    # the hardware the plan was priced for (``autotune``'s ``hw``); the
    # plan store keys on it
    hw: Optional[str] = None

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["plan"] = self.plan.to_dict()
        return d


def _tree_decision(tree):
    """Worker task (reference engine): run one tree's per-decision budget;
    ship the mutated tree back so its subtree (and cache entries) survive
    the round.  Cache counters travel as plain ints —
    ``TranspositionCache.__getstate__`` zeroes them on every pickle, so the
    worker's counts are exactly this round's activity but would be lost on
    the return trip otherwise.  Serving-backend pricing counters travel the
    same way (``HybridCostBackend.__getstate__`` zeroes them)."""
    res = tree.run_decision()
    stats = serving = None
    if isinstance(tree.mdp, CachedMDP):
        stats = (tree.mdp.cache.hits, tree.mdp.cache.misses)
        if tree.mdp.cost_backend is not None:
            serving = tree.mdp.cost_backend.counters()
    return tree, res, stats, serving


class ProTuner:
    def __init__(
        self,
        mdp: ScheduleMDP,
        *,
        n_standard: int = 15,
        n_greedy: int = 1,
        mcts_config: MCTSConfig = MCTSConfig(),
        measure_fn: Optional[Callable[[SchedulePlan], float]] = None,
        measure_backend=None,
        parallel: bool = False,
        seed: int = 0,
        engine: str = "array",
        cache: Optional[bool] = None,
        batch: Optional[bool] = None,
        cost: str = "analytic",
        n_workers: Optional[int] = None,
        worker_pool: Optional[PinnedWorkerPool] = None,
        shm: Optional[bool] = None,
        worker_batch: Optional[bool] = None,
        controller=None,
        resume: Optional[dict] = None,
        device: str = "cuda",
    ):
        # parallel-transport levers (engine/workers.py): ``shm`` backs the
        # forward cache delta with a shared-memory log (None = auto: on
        # for pure-analytic runs where shared memory exists);
        # ``worker_batch`` runs each worker's pinned subset through ONE
        # lockstep run_decision_batch per round (None = follow ``batch``,
        # so the two batching levers compose by default on the array
        # engine)
        self.shm = shm
        # measure_backend: a fleet-bound FleetMeasure (core/measure_fleet).
        # It is callable with the same plan -> seconds contract, so it can
        # stand in for measure_fn wholesale; when present, candidate
        # batches additionally prefetch through its measure_plans fan-out
        # so the re-rank blocks on ONE round trip instead of N serial
        # compiles.
        self.measure_backend = measure_backend
        if measure_fn is None and measure_backend is not None:
            measure_fn = measure_backend
        self.measure_fn = measure_fn
        self.parallel = parallel or worker_pool is not None
        self.n_workers = n_workers
        # an externally owned PinnedWorkerPool (the tuner daemon shares one
        # pool across runs): rebind it to this run's trees instead of
        # spawning, and never shut it down
        self._ext_pool = worker_pool
        self.engine = engine
        # learned-cost serving: cost="learned"|"hybrid" (or a ready-made
        # HybridCostBackend) mounts the serving layer inside CachedMDP;
        # "analytic" mounts nothing — the PR-2 bit-identical path.  A
        # backend already mounted on a passed-in CachedMDP wins whatever
        # ``cost`` says: it IS pricing misses, so reporting/exact-repricing
        # must see it.
        if isinstance(mdp, CachedMDP) and mdp.cost_backend is not None:
            backend = mdp.cost_backend  # mounted backend wins over cost=
        else:
            # ``device``: where a learned backend fits and prices
            backend = make_cost_backend(cost, mdp.space, device=device)
        self.cost_backend = backend
        self.cost_mode = backend.mode if backend is not None else "analytic"
        if cache is None:
            # the cache is the serving seam AND the training set, so a
            # cost backend turns it on for any engine
            cache = engine == "array" or backend is not None
        if batch is None:
            batch = engine == "array"
        self.batch = batch
        self.worker_batch = batch if worker_batch is None else worker_batch
        if backend is not None and not cache and not isinstance(mdp, CachedMDP):
            raise ValueError(
                "cost='learned'/'hybrid' requires the transposition cache "
                "(it is both the training set and the serving seam); "
                "drop the explicit cache=False or use cost='analytic'"
            )
        if (cache or backend is not None) and not isinstance(mdp, CachedMDP):
            mdp = CachedMDP(mdp, cost_backend=backend)
        elif (backend is not None and isinstance(mdp, CachedMDP)
              and mdp.cost_backend is None):
            mdp.cost_backend = backend
            backend.bind(mdp.cache)
        self.mdp = mdp
        self.cache: Optional[TranspositionCache] = (
            mdp.cache if isinstance(mdp, CachedMDP) else None
        )
        self.trees = []
        self.greedy_flags: List[bool] = []
        for i in range(n_standard):
            cfg = dataclasses.replace(mcts_config, simulation="random", seed=seed * 1000 + i)
            self.trees.append(make_tree(mdp, cfg, engine))
            self.greedy_flags.append(False)
        for i in range(n_greedy):
            cfg = dataclasses.replace(
                mcts_config, simulation="greedy", seed=seed * 1000 + 500 + i
            )
            self.trees.append(make_tree(mdp, cfg, engine))
            self.greedy_flags.append(True)
        self._measure_cache: Dict[State, float] = {}
        self._measure_failed: set = set()  # states re-ranked by analytic cost
        self.n_measurements = 0
        self.n_measure_failures = 0
        self._extra_evals = 0  # worker-side evals (parallel mode)
        self._pool: Optional[PinnedWorkerPool] = None
        self._pending_advance: Optional[int] = None  # last root-sync action
        # per-tree counter baseline at submission time; -1 = the tree was
        # reattached to the shared mdp, so next round's baseline is the
        # master counter (uncached trees keep private mdp copies whose
        # counters accumulate across rounds)
        self._sent_evals: Optional[List[int]] = None
        # round-boundary run control (core/run_control.py): deadline /
        # cancel / checkpoint hooks.  ``decisions`` lives on the instance
        # so snapshot()/restore round-trip the full decision trace.
        self.controller = controller
        self.decisions: List[dict] = []
        if resume is not None:
            self._restore(resume)

    # -- round-boundary checkpointing (core/run_control.py) ------------
    def snapshot(self) -> dict:
        """Everything a fresh ``ProTuner`` (built from the same request)
        needs to replay the remaining rounds bit-identically: the live
        trees (each carries its own ``random.Random`` and stat arrays; in
        parallel mode the MASTER trees are canonical, reverse deltas land
        every round), the decision trace, and the measurement memo.  The
        caller pickles the dict — the trees' shared ``mdp`` (and cache)
        dedups inside one ``dumps``.  Learned-cost runs are not
        snapshot-eligible (trainer state is not restorable); the run loop
        passes no thunk for them."""
        return {
            "version": SNAPSHOT_VERSION,
            "engine": self.engine,
            "round": len(self.decisions),
            "decisions": list(self.decisions),
            "trees": self.trees,
            "measure_cache": dict(self._measure_cache),
            "measure_failed": set(self._measure_failed),
            "n_measurements": self.n_measurements,
            "n_measure_failures": self.n_measure_failures,
        }

    def _restore(self, snap: dict) -> None:
        """Adopt a ``snapshot()`` (typically pickle-round-tripped through
        the plan store's checkpoint tier).  A snapshot that doesn't match
        this run's shape is ignored — the run starts fresh, which is
        always correct, just slower."""
        trees = snap.get("trees") if isinstance(snap, dict) else None
        if (
            not isinstance(snap, dict)
            or snap.get("version") != SNAPSHOT_VERSION
            or not trees
            or len(trees) != len(self.trees)
            or snap.get("engine") != self.engine
        ):
            logger.warning("checkpoint does not match this run; starting fresh")
            return
        old_mdp = trees[0].mdp
        if isinstance(old_mdp, CachedMDP) and isinstance(self.mdp, CachedMDP):
            # warm entries priced before the interrupt survive it; a pure
            # memo of exact values never changes plan/cost/decisions
            self.mdp.cache.merge(old_mdp.cache)
        for t in trees:
            t.mdp = self.mdp  # reattach this run's (shared) mdp + cache
        self.trees = trees
        self.decisions = list(snap["decisions"])
        self._measure_cache = dict(snap["measure_cache"])
        self._measure_failed = set(snap["measure_failed"])
        self.n_measurements = snap["n_measurements"]
        self.n_measure_failures = snap["n_measure_failures"]

    # ------------------------------------------------------------------
    def _exact_cost(self, state: State) -> float:
        """EXACT analytic terminal cost.  With a learned server mounted,
        the cache (and any miss pricing through ``self.mdp``) may return
        model predictions — bypass both and price on the inner MDP; with
        no server, the cached value IS exact, so go through the cache as
        the PR-2 path always did (hit counters unchanged)."""
        if self.cost_backend is not None and isinstance(self.mdp, CachedMDP):
            return self.mdp.mdp.terminal_cost(state)
        return self.mdp.terminal_cost(state)

    # ------------------------------------------------------------------
    def _degrade(self, state: State, why: str) -> float:
        """A failed measurement must not kill the run: re-rank this
        candidate by its EXACT analytic cost, count it, and keep going."""
        self.n_measure_failures += 1
        t = self._exact_cost(state)
        self._measure_cache[state] = t
        self._measure_failed.add(state)
        logger.warning(
            "measurement failed (candidate degraded to analytic cost "
            "%.6gs): %s", t, why,
        )
        return t

    def _measure_state(self, state: State) -> float:
        if state in self._measure_cache:
            return self._measure_cache[state]
        try:
            t = self.measure_fn(self.mdp.plan(state))
        except Exception as e:  # noqa: BLE001 - degrade, never abort the run
            return self._degrade(state, repr(e))
        self._measure_cache[state] = t
        self.n_measurements += 1
        return t

    def _prefetch_measurements(self, states: List[State]) -> None:
        """Batch the round's candidate measurements through the fleet
        (one ``measure_many`` fan-out over the workers) so the
        re-ranking ``min()`` below only ever hits the local cache."""
        todo = [s for s in states if s not in self._measure_cache]
        if not todo or self.measure_backend is None:
            return
        plans = [self.mdp.plan(s) for s in todo]
        try:
            times = self.measure_backend.measure_plans(plans)
        except Exception as e:  # noqa: BLE001 - fall back to per-state path
            logger.warning("fleet prefetch failed (%r); measuring serially", e)
            return
        for st, t in zip(todo, times):
            if t is None:
                self._degrade(st, "fleet measurement failed")
            else:
                self._measure_cache[st] = t
                self.n_measurements += 1

    # ------------------------------------------------------------------
    def _round_sequential(self):
        if self.batch and all(isinstance(t, ArrayMCTS) for t in self.trees):
            # lockstep pending-leaf round: the K trees' concurrent
            # simulations price through ONE terminal_cost_batch call per
            # step — results identical to the per-tree loop (engine/batch)
            return run_decision_batch(self.trees, self.mdp,
                                      controller=self.controller)
        return [t.run_decision() for t in self.trees]

    def _round_pinned(self):
        """One decision round through the persistent pinned workers
        (``engine/workers.py``): forward deltas out (root advance +
        sibling cache entries + generation-keyed params), reverse deltas
        back, merged deterministically onto the master's canonical trees
        and cache.  The master-side refit point stays here: workers never
        refit (their backends shipped serve-only), so the merged cache is
        scored after the round and the new generation ships with the next
        round's forward deltas."""
        results = self._pool.round(self._pending_advance)
        self._pending_advance = None
        self._extra_evals += self._pool.extra_evals
        self._pool.extra_evals = 0
        if isinstance(self.mdp, CachedMDP):
            self.mdp.on_round_end()
        return results

    def _round_parallel(self, executor: ProcessPoolExecutor):
        """One decision round across stateless executor workers (the
        reference engine's whole-tree round trip); deterministic merge:
        results and tree updates happen in tree-index order regardless of
        completion order, so output is identical to the sequential path.
        Array trees never take this path — they run in the pinned pool
        (``_round_pinned``)."""
        base_evals = getattr(self.mdp.cost_model, "n_evals", None)
        if base_evals is not None and self._sent_evals is None:
            self._sent_evals = [base_evals] * len(self.trees)
        futures = [executor.submit(_tree_decision, t) for t in self.trees]
        results = []
        for i, fut in enumerate(futures):
            tree, res, stats, serving = fut.result()
            if serving is not None and self.cost_backend is not None:
                self.cost_backend.merge_counters(serving)
            if base_evals is not None:
                sent = self._sent_evals[i]
                if sent < 0:  # was reattached: baseline is the master counter
                    sent = base_evals
                worker_evals = getattr(tree.mdp.cost_model, "n_evals", sent)
                self._extra_evals += max(worker_evals - sent, 0)
            else:
                worker_evals = None
            reattach = self.cache is not None and isinstance(tree.mdp, CachedMDP)
            if reattach:
                self.cache.merge(tree.mdp.cache)
                if stats is not None:
                    self.cache.hits += stats[0]
                    self.cache.misses += stats[1]
                tree.mdp = self.mdp  # reattach the shared cache for next round
            if base_evals is not None:
                self._sent_evals[i] = -1 if reattach else worker_evals
            self.trees[i] = tree
            results.append(res)
        # master-side refit point: workers never refit (their pickled
        # backends are serve-only), so the merged cache is scored here and
        # the refreshed model ships with the next round's submissions
        if isinstance(self.mdp, CachedMDP):
            self.mdp.on_round_end()
        return results

    def run(self, time_budget_s: Optional[float] = None) -> TuneResult:
        t0 = time.perf_counter()
        decisions = self.decisions  # non-empty on a checkpoint resume
        controller = self.controller
        # checkpoint eligibility: learned-cost serving carries trainer
        # state (fit generations, model params) that a snapshot can't
        # restore bit-identically — those runs keep deadline/cancel
        # support but never checkpoint (a replay restarts from scratch,
        # which is deterministic and therefore still correct)
        snapshot_thunk = self.snapshot if self.cost_backend is None else None
        interrupted: Optional[dict] = None
        executor: Optional[ProcessPoolExecutor] = None
        try:
            if self.parallel:
                if self._ext_pool is not None:
                    assert all(isinstance(t, ArrayMCTS) for t in self.trees), \
                        "a shared worker pool requires the array engine"
                    self._ext_pool.rebind(
                        self.trees, self.mdp, shm=self.shm,
                        worker_batch=self.worker_batch,
                    )
                    self._pool = self._ext_pool
                elif all(isinstance(t, ArrayMCTS) for t in self.trees):
                    # persistent pinned workers: trees + serve-only mdp
                    # ship ONCE; every round after that is a delta in
                    # both directions (engine/workers.py)
                    self._pool = PinnedWorkerPool(
                        self.trees, self.mdp, n_workers=self.n_workers,
                        shm=self.shm, worker_batch=self.worker_batch,
                    )
                else:
                    # reference engine: stateless whole-tree round trips
                    executor = ProcessPoolExecutor(
                        max_workers=min(
                            len(self.trees),
                            self.n_workers or os.cpu_count() or 2,
                        ),
                        mp_context=pick_mp_context(),
                    )
            while not self.trees[0].done:
                if time_budget_s and time.perf_counter() - t0 > time_budget_s:
                    break
                if controller is not None:
                    controller.begin_round()
                if self._pool is not None:
                    results = self._round_pinned()
                elif executor is not None:
                    results = self._round_parallel(executor)
                else:
                    results = self._round_sequential()

                # winner: best complete schedule across trees; optionally
                # re-rank the (deduped) candidates by real measurement
                # (paper Fig. 6's commented line).
                if self.measure_fn is not None:
                    ranked = sorted(
                        range(len(results)), key=lambda i: results[i].best_cost
                    )
                    seen: Dict[State, int] = {}
                    for i in ranked:
                        st = results[i].best_state
                        if st is not None and st not in seen:
                            seen[st] = i
                    self._prefetch_measurements(list(seen))
                    best_i = min(
                        seen.values(),
                        key=lambda i: self._measure_state(results[i].best_state),
                    )
                else:
                    best_i = min(
                        range(len(results)), key=lambda i: results[i].best_cost
                    )
                win = results[best_i]
                decisions.append(
                    {
                        "depth": len(self.trees[0].root_state),
                        "stage": self.mdp.space.stages[len(self.trees[0].root_state)].name,
                        "action": win.action,
                        "winner_tree": best_i,
                        "winner_greedy": self.greedy_flags[best_i],
                        "best_cost": win.best_cost,
                    }
                )
                for t in self.trees:
                    t.advance_root(win.action)
                # pinned workers are one advance behind the master's
                # canonical trees until the next round's forward delta
                self._pending_advance = win.action

                if controller is not None:
                    # a cancel can truncate the round mid-iteration
                    # (engine/batch.py); a truncated boundary is NOT
                    # canonical, so it is neither counted, delayed, nor
                    # checkpointed — the last cadence checkpoint (all full
                    # rounds) stays the resume point
                    truncated = controller.round_truncated
                    if not truncated:
                        controller.round_done(snapshot_thunk)
                    reason = controller.should_stop()
                    if reason is not None and not self.trees[0].done:
                        ckpt = False
                        if not truncated:
                            # final boundary checkpoint (idempotent with a
                            # cadence checkpoint on the same round)
                            ckpt = controller.checkpoint(snapshot_thunk)
                        interrupted = {
                            "reason": reason,
                            "rounds_done": len(decisions),
                            "rounds_total": len(self.mdp.space.stages),
                            "round_truncated": truncated,
                            "checkpointed": bool(ckpt),
                        }
                        break
        finally:
            if self._pool is not None and self._pool is not self._ext_pool:
                self._pool.shutdown()
            if executor is not None:
                # wait=True: with wait=False the queue-feeder thread can
                # block forever on the large pickled-tree payloads still in
                # the call queue after a pool failure, hanging interpreter
                # exit
                executor.shutdown(wait=True, cancel_futures=True)

        # final schedule: the best complete state any tree ever saw
        best_tree = min(self.trees, key=lambda t: t.global_best)
        final_state = best_tree.global_best_state
        final_cost = best_tree.global_best
        if self.cost_backend is not None and final_state is not None:
            # a learned server picked the winner by its ESTIMATES; report
            # the exact analytic cost of that schedule so TuneResult.cost
            # is comparable across cost modes
            final_cost = self._exact_cost(final_state)
        measured = None
        if self.measure_fn is not None and final_state is not None:
            # winner by real time among all measured candidates + final
            cands = dict(self._measure_cache)
            cands[final_state] = self._measure_state(final_state)
            final_state = min(cands, key=cands.get)
            # a degraded candidate's entry is its analytic cost, not a
            # real measurement — never report it as one
            if final_state not in self._measure_failed:
                measured = cands[final_state]
            final_cost = self._exact_cost(final_state)
        n_evals = getattr(self.mdp.cost_model, "n_evals", 0) + self._extra_evals
        serving = self.cost_backend.stats() if self.cost_backend else None
        pool = self._pool
        stats = pool.stats() if pool else {}
        if serving is not None:
            # the learned backend's counters, fits and pricing device
            stats["serving"] = serving
        if interrupted is not None:
            # best-so-far provenance: callers (the daemon, the plan store)
            # must treat this result as partial — never record it as THE
            # answer for the request
            stats["interrupted"] = interrupted
        return TuneResult(
            plan=self.mdp.plan(final_state),
            cost=final_cost,
            measured=measured,
            n_evals=n_evals,
            n_measurements=self.n_measurements,
            wall_time_s=time.perf_counter() - t0,
            decisions=decisions,
            algo="mcts",
            engine=self.engine,
            cache_hits=self.cache.hits if self.cache else 0,
            cache_misses=self.cache.misses if self.cache else 0,
            cost_mode=self.cost_mode,
            model_version=serving["model_version"] if serving else 0,
            n_fits=serving["n_fits"] if serving else 0,
            learned_evals=serving["learned_plans"] if serving else 0,
            submit_bytes=pool.submit_bytes if pool else 0,
            return_bytes=pool.return_bytes if pool else 0,
            snapshot_bytes=pool.snapshot_bytes if pool else 0,
            submit_bytes_rounds=list(pool.submit_bytes_rounds) if pool else [],
            return_bytes_rounds=list(pool.return_bytes_rounds) if pool else [],
            n_worker_restarts=pool.n_worker_restarts if pool else 0,
            stats=stats,
            n_measure_failures=self.n_measure_failures,
        )


@dataclass
class MCTSEnsembleBackend:
    """``SearchBackend`` adapter for the ProTuner ensemble (see
    ``repro_torch.core.engine.backend``)."""

    algo: str = "mcts"
    config: MCTSConfig = field(default_factory=MCTSConfig)
    engine: str = "array"
    cost: str = "analytic"  # learned-cost serving mode (engine/serving.py)
    name: str = "mcts"

    def run(
        self,
        mdp,
        *,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
        measure_fn: Optional[Callable] = None,
        measure_backend=None,
        n_standard: int = 15,
        n_greedy: int = 1,
        parallel: bool = False,
        cache: Optional[bool] = None,
        batch: Optional[bool] = None,
        cost=None,  # None -> the backend's configured self.cost
        n_workers: Optional[int] = None,
        worker_pool=None,
        shm: Optional[bool] = None,
        worker_batch: Optional[bool] = None,
        controller=None,
        resume: Optional[dict] = None,
        device: str = "cuda",
        **_,
    ) -> TuneResult:
        mc = dataclasses.replace(self.config, seed=seed)
        # paper protocol: only the cost+real_* variants re-rank by real
        # measurement at root synchronization
        use_measure = measure_fn if "real" in self.algo else None
        use_backend = measure_backend if "real" in self.algo else None
        tuner = ProTuner(
            mdp,
            n_standard=n_standard,
            n_greedy=n_greedy,
            mcts_config=mc,
            measure_fn=use_measure,
            measure_backend=use_backend,
            parallel=parallel,
            seed=seed,
            engine=self.engine,
            cache=cache,
            batch=batch,
            cost=cost if cost is not None else self.cost,
            n_workers=n_workers,
            worker_pool=worker_pool,
            shm=shm,
            worker_batch=worker_batch,
            controller=controller,
            resume=resume,
            device=device,
        )
        res = tuner.run(time_budget_s=time_budget_s)
        res.algo = self.algo
        return res

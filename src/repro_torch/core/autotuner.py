"""Top-level ProTuner API of the port: ``autotune(arch, shape, algo, ..., hw=)``.

A copy of the JAX package's ``core/autotuner.py`` with one addition, the
hardware the cell is priced for: ``hw="h100"`` (the default: the port's
meshes ``single`` 1×8, ``multi`` 2×1×8 and ``card`` 1×1, and the tiles the
port's kernels launch) or ``hw="tpu-v5e"`` (the JAX package's spec, pods and
tiles, under which the results are the JAX package's bit for bit).

Algorithms (paper §5 protocol, plus the complete-plan portfolio):
  mcts_*    — ProTuner ensemble (15 standard + 1 greedy MCTS), Table-1 variants
  beam      — beam search, size 32, 5 passes (Adams et al. baseline)
  greedy    — beam size 1
  random    — random search (no cost model)
  evolve    — evolutionary search over complete plans (core/evolve.py)
  portfolio — race evolve/mcts/beam/random on one shared transposition
              cache and eval budget (core/evolve.py)

``measure_fn`` / ``measure_backend`` (callables, plan -> seconds) re-rank
candidates at every root synchronization — the ``mcts_cost+real_*``
configurations; on the H100 a ``core/measure_fleet.py`` fleet bound to the
card target (``launch/measure.CardTarget``) is the backend.
``plan_store=`` (``repro_torch.service.store.PlanStore``) answers a repeat
request from disk and seeds ``evolve``/``portfolio`` from the cell's stored
plans.  ``cost="learned"|"hybrid"`` and ``pricing="jit"`` compute with torch
on ``device`` (default ``"cuda"``); the analytic default never imports it.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Optional

from repro_torch.configs import get_config, get_shape
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.engine import ENGINES
from repro_torch.core.engine.backend import TABLE1, SearchBackend, resolve_backend
from repro_torch.core.ensemble import TuneResult
from repro_torch.core.mdp import ScheduleMDP
from repro_torch.core.hardware import get_hardware, hardware_key
from repro_torch.core.space import ScheduleSpace, get_mesh


class NoisyCostModel:
    """Deterministic multiplicative log-normal noise on top of the analytic
    model — simulates a learned cost model's error (paper §3); per-plan noise
    is a pure hash so search remains reproducible."""

    def __init__(self, inner: AnalyticCostModel, sigma: float = 0.0, seed: int = 0):
        self.inner = inner
        self.sigma = sigma
        self.seed = seed

    @property
    def n_evals(self):
        return self.inner.n_evals

    def _noise(self, plan) -> float:
        if not self.sigma:
            return 1.0
        # Box-Muller from two INDEPENDENT uniforms: disjoint halves of a
        # 16-byte digest (a single 8-byte digest reused for both radius and
        # angle correlates them and skews the distribution off log-normal)
        h = hashlib.blake2b(
            (str(self.seed) + repr(plan)).encode(), digest_size=16
        ).digest()
        u1 = int.from_bytes(h[:8], "big") / 2**64
        u2 = int.from_bytes(h[8:16], "big") / 2**64
        z = math.sqrt(-2.0 * math.log(max(u1, 1e-12))) * math.cos(2 * math.pi * u2)
        return math.exp(self.sigma * z)

    def cost(self, plan) -> float:
        return self.inner.cost(plan) * self._noise(plan)

    def cost_batch(self, plans) -> list:
        """Batched pricing: inner costs amortize through the analytic
        model's batch path, then the same deterministic per-plan noise is
        applied — ``cost_batch(plans) == [cost(p) for p in plans]``."""
        base = self.inner.cost_batch(plans)
        return [b * self._noise(p) for b, p in zip(base, plans)]

    def partial_cost(self, actions, space) -> float:
        defaults = space.default_actions()
        full = list(actions) + defaults[len(actions):]
        return self.cost(space.plan_from_actions(full))

    def terms(self, plan):
        return self.inner.terms(plan)


def make_mdp(
    arch: str,
    shape_name: str,
    mesh: str = "single",
    noise_sigma: float = 0.0,
    noise_seed: int = 0,
    pricing: Optional[str] = None,
    hw: str = "h100",
    device=None,
) -> ScheduleMDP:
    """Build one cell's MDP on hardware ``hw`` (a ``core.hardware`` name or
    spec) and one of its meshes (``core.space.MESHES``).  ``pricing``
    selects the analytic kernel: None/"columnar" (exact, default),
    "scalar" (the exact oracle replay), or "jit" (the float64 torch program
    on ``device``, default ``"cuda"``: JIT_RTOL tolerance contract and a
    versioned pricing tag; see cost_model.py)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    spec = get_hardware(hw)
    mspec = get_mesh(spec, mesh)
    space = ScheduleSpace(cfg, shape, mspec, spec)
    cm = AnalyticCostModel(cfg, shape, mspec, spec, pricing=pricing,
                           device=device if pricing == "jit" else None)
    if noise_sigma:
        cm = NoisyCostModel(cm, noise_sigma, noise_seed)
    return ScheduleMDP(space, cm)


# TABLE1 lives in repro_torch.core.engine.backend (imported above) — re-exported
# here for backward compatibility with existing callers/tests.


def autotune(
    arch: str,
    shape_name: str,
    *,
    algo: str = "mcts_30s",
    mesh: str = "single",
    seed: int = 0,
    n_standard: int = 15,
    n_greedy: int = 1,
    measure_fn: Optional[Callable] = None,
    measure_backend=None,
    time_budget_s: Optional[float] = None,
    noise_sigma: float = 0.0,
    mdp: Optional[ScheduleMDP] = None,
    engine: str = "array",
    parallel: bool = False,
    cache: Optional[bool] = None,
    batch: Optional[bool] = None,
    cost: str = "analytic",
    n_workers: Optional[int] = None,
    worker_pool=None,
    shm: Optional[bool] = None,
    worker_batch: Optional[bool] = None,
    plan_store=None,
    pricing: Optional[str] = None,
    controller=None,
    resume: Optional[dict] = None,
    hw: str = "h100",
    device: str = "cuda",
) -> TuneResult:
    """Tune one (arch × shape × mesh) cell on hardware ``hw``.

    ``engine`` selects the MCTS tree representation — the default is the
    vectorized ``"array"`` engine with batched leaf evaluation and the
    shared transposition cache, certified bit-identical to the paper-
    faithful ``"reference"`` engine (the JAX package's
    ``tests/test_differential.py``; the port is held to the JAX package's
    results by ``tests/test_torch_search.py``);
    ``parallel`` runs ensemble trees across persistent pinned worker
    processes (``repro_torch.core.engine.workers``; per-round deltas in both
    directions, payload bytes surfaced on ``TuneResult``, ``n_workers``
    caps the pool — default one worker per core up to the tree count);
    ``cache`` forces the shared transposition cache on/off (default: on
    for the array engine); ``batch`` forces lockstep batched leaf
    evaluation on/off (default: on for the array engine); ``shm`` forces
    the pool's shared-memory cache transport on/off (default: auto — on
    for pure-analytic parallel runs where POSIX shared memory exists);
    ``worker_batch`` forces in-worker lockstep batching of each pinned
    subset on/off (default: follow ``batch``).  All algorithms dispatch
    through the ``SearchBackend`` protocol
    (``repro_torch.core.engine.backend``).

    ``cost`` selects the serving layer of the cost stack for MCTS runs:
    ``"analytic"`` (default — exact, bit-identical to the JAX package's
    search), ``"learned"`` (serve the online-trained §3 MLP once it exists),
    or ``"hybrid"`` (serve it only while its holdout Spearman clears the
    confidence gate; exact-analytic fallback otherwise).  A pre-configured
    ``HybridCostBackend`` is also accepted.  See
    ``repro_torch.core.engine.serving``.  ``device`` is where the MLP fits
    and prices, and where ``pricing="jit"`` runs; nothing else reads it,
    and a run with neither never imports torch.

    ``measure_fn`` / ``measure_backend`` are callables (plan -> seconds),
    exactly as in the JAX package: ``mcts_cost+real_*`` runs re-rank each
    root synchronization's candidates by them, and a failed measurement
    degrades that candidate to its exact analytic cost (counted on
    ``TuneResult.n_measure_failures``) instead of aborting the run.  On the
    H100: ``MeasurementFleet(1, target=launch.measure.CardTarget()).bind(
    arch, shape, "card", device="cuda", cut=...)`` times each candidate's
    step on the card (one worker, the weights resident across requests,
    records cached on disk by the program the card runs); its ``step_s``
    is the card's time projected to the cell, in the analytic model's
    seconds, so a degraded candidate ranks on the same scale.

    ``controller`` mounts a round-boundary ``RunController``
    (``repro_torch.core.run_control``): a deadline or cancel finishes the
    current decision round and returns best-so-far with
    ``TuneResult.stats["interrupted"]`` provenance; ``resume`` restores a
    ``ProTuner.snapshot()`` checkpoint so the run replays the remaining
    rounds bit-identically.  An uninterrupted run with a controller
    mounted is bit-identical to one without.  An interrupted (partial)
    result is never recorded into ``plan_store``; the store keys on ``hw``
    (``repro_torch.service.store.canonical_request``), so a plan tuned for
    one hardware never answers a request for another."""
    assert engine in ENGINES, engine
    store_req = None
    if plan_store is not None:
        # persistent PlanStore (repro_torch.service.store): answer a repeat
        # request from disk (from_store=True, zero evals), record a cold
        # result after the run.  The store key covers the value-affecting
        # settings of THIS signature — a caller passing a custom ``mdp``
        # must guarantee it matches them (the daemon does).
        from repro_torch.service.store import canonical_request

        store_req = canonical_request(
            arch, shape_name, mesh=mesh, algo=algo, seed=seed,
            time_budget_s=time_budget_s, n_standard=n_standard,
            n_greedy=n_greedy, noise_sigma=noise_sigma, cost=cost,
            pricing=pricing, hw=hw,
        )
        hit = plan_store.lookup(store_req)
        if hit is not None:
            return hit
    seed_plans = None
    if plan_store is not None and algo in ("evolve", "portfolio"):
        # warm-start the evolutionary population from the store's recorded
        # plans for this cell on this hardware (any algo/seed — a good plan
        # is a good seed); non-evolutionary backends ignore seed_plans
        seed_plans = plan_store.seed_plans(
            arch=arch, shape=shape_name, mesh=mesh, hw=hw
        )
    mdp = mdp or make_mdp(arch, shape_name, mesh, noise_sigma, seed,
                          pricing=pricing, hw=hw, device=device)
    backend: SearchBackend = resolve_backend(algo, engine=engine)
    res = backend.run(
        mdp,
        seed=seed,
        time_budget_s=time_budget_s,
        measure_fn=measure_fn,
        measure_backend=measure_backend,
        n_standard=n_standard,
        n_greedy=n_greedy,
        parallel=parallel,
        cache=cache,
        batch=batch,
        cost=cost,
        n_workers=n_workers,
        worker_pool=worker_pool,
        shm=shm,
        worker_batch=worker_batch,
        seed_plans=seed_plans,
        controller=controller,
        resume=resume,
        device=device,
    )
    spec = getattr(getattr(mdp, "space", None), "hw", None)
    res.hw = hardware_key(spec if spec is not None else hw)
    if plan_store is not None:
        plan_store.record(store_req, res)
    return res

"""Vectorized search engine layer.

Two interchangeable MCTS engines behind one interface:

* ``"reference"`` — the paper-faithful ``Node``-object tree
  (``repro_torch.core.mcts.MCTS``), kept as the behavioral oracle.
* ``"array"`` — ``ArrayMCTS``: the same algorithm in flat numpy arrays
  with batched UCB scoring, exactly equivalent for fixed seeds.  **This is
  the default engine everywhere** (``autotune``, ``ProTuner``), certified
  against the reference across the full (UCB variant × simulation policy ×
  reward mode × seed) grid by the JAX package's differential harness
  (``tests/test_differential.py``); the port's copy gives the JAX
  package's results (``tests/test_torch_search.py``).

Batched leaf evaluation (``engine/batch.py``): ``run_decision_batch`` runs
an ensemble round's K trees in lockstep, queueing each step's K pending
leaves (and the greedy rollouts' per-depth candidate sweeps) into single
batched pricing calls.  The pricing seam it rides on:

* ``AnalyticCostModel.cost_batch(plans)`` — contract:
  ``cost_batch(plans) == [cost(p) for p in plans]`` element-for-element and
  bit-for-bit; duplicate plans are priced once and ``n_evals`` counts each
  unique evaluation once.  Plan-independent accounting amortizes across the
  batch via a persistent evaluation context.
* ``ScheduleMDP.terminal_cost_batch / partial_cost_batch`` — the same
  contract at the state level, falling back to scalar loops for cost
  models without ``cost_batch``.
* ``CachedMDP.terminal_cost_batch / partial_cost_batch`` — additionally
  partitions the batch against the ``TranspositionCache`` and prices ONLY
  the deduplicated misses; ``hits + misses`` advances by exactly the batch
  size, a state appearing twice in one batch is one miss plus one hit, and
  a warm cache never changes returned values (hypothesis-tested in
  ``tests/test_properties.py``).

Plus the shared ``TranspositionCache`` / ``CachedMDP`` that memoizes
``terminal_cost`` / ``partial_cost`` across all ensemble trees and all
decision rounds, and the ``SearchBackend`` protocol (see ``backend.py``)
that ``autotune`` routes every algorithm through.

Parallel execution (``workers.py``): ``parallel=True`` runs ensemble
rounds on PERSISTENT PINNED worker processes — each worker holds its
trees and a serve-only ``CachedMDP`` for the whole run, and per-round
traffic is a delta in both directions (root-advance + incremental cache
export + generation-keyed model params forward; the ``ArrayMCTS`` round
delta back), with payload bytes counted at the pickle boundary and
worker-death resync from the master's canonical trees.

Learned-cost serving (``serving.py``): ``cost="analytic"|"learned"|"hybrid"``
on ``autotune`` / ``ProTuner`` / ``resolve_backend`` mounts a
``HybridCostBackend`` inside ``CachedMDP`` — an ``OnlineCostTrainer``
refits the §3 MLP on the cache's analytic terminal entries, and trained
(confident) models price each deduplicated miss batch in ONE forward pass
on the backend's device, with exact-analytic fallback.  ``cost="analytic"``
(the default) mounts nothing, so the path the JAX package's results are
held to is untouched.
"""
from __future__ import annotations

from repro_torch.core.engine.array_mcts import ArrayMCTS
from repro_torch.core.engine.cache import CachedMDP, TranspositionCache
from repro_torch.core.engine.serving import (
    COST_MODES,
    HybridCostBackend,
    OnlineCostTrainer,
    make_cost_backend,
)
from repro_torch.core.engine.workers import PinnedWorkerPool

ENGINES = ("reference", "array")


def make_tree(mdp, config, engine: str = "reference"):
    """Construct one search tree with the requested engine."""
    if engine == "array":
        return ArrayMCTS(mdp, config)
    if engine == "reference":
        from repro_torch.core.mcts import MCTS

        return MCTS(mdp, config)
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")


__all__ = [
    "ArrayMCTS",
    "CachedMDP",
    "PinnedWorkerPool",
    "TranspositionCache",
    "COST_MODES",
    "HybridCostBackend",
    "OnlineCostTrainer",
    "make_cost_backend",
    "ENGINES",
    "make_tree",
]

"""Beam search baseline (Adams et al. 2019 protocol: beam 32, 5 passes) and
greedy search (beam size 1).

Exactly the behaviour the paper criticizes: every depth is ranked by the
cost model's estimate of an INCOMPLETE schedule (default-completed here),
so cost-model error compounds at every level of the tree.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.engine import CachedMDP
from repro_torch.core.ensemble import TuneResult
from repro_torch.core.mdp import ScheduleMDP, State


def beam_search(
    mdp: ScheduleMDP,
    *,
    beam_size: int = 32,
    passes: int = 5,
    seed: int = 0,
    time_budget_s: Optional[float] = None,
) -> TuneResult:
    t0 = time.perf_counter()
    rng = random.Random(seed)
    best_cost = float("inf")
    best_state: Optional[State] = None
    for p in range(passes):
        if time_budget_s and time.perf_counter() - t0 > time_budget_s:
            break
        frontier: List[State] = [mdp.initial_state]
        depth = 0
        while frontier and not mdp.is_terminal(frontier[0]):
            candidates: List[Tuple[float, float, State]] = []
            for s in frontier:
                for a in range(mdp.n_actions(s)):
                    child = mdp.step(s, a)
                    c = mdp.partial_cost(child)
                    # later passes diversify via rank jitter (the Halide
                    # autoscheduler restarts with perturbed orderings)
                    jitter = rng.random() * 1e-12 if p == 0 else rng.random() * c * 0.05 * p
                    candidates.append((c + jitter, rng.random(), child))
            candidates.sort()
            frontier = [s for _, _, s in candidates[:beam_size]]
            depth += 1
        for s in frontier:
            c = mdp.terminal_cost(s)
            if c < best_cost:
                best_cost, best_state = c, s
    return TuneResult(
        plan=mdp.plan(best_state),
        cost=best_cost,
        measured=None,
        n_evals=getattr(mdp.cost_model, "n_evals", 0),
        n_measurements=0,
        wall_time_s=time.perf_counter() - t0,
        algo=f"beam{beam_size}",
    )


def greedy_search(mdp: ScheduleMDP, seed: int = 0, **kw) -> TuneResult:
    res = beam_search(mdp, beam_size=1, passes=1, seed=seed, **kw)
    res.algo = "greedy"
    return res


# ---------------------------------------------------------------------------
# SearchBackend adapters (repro_torch.core.engine.backend protocol)
# ---------------------------------------------------------------------------
@dataclass
class BeamBackend:
    """Beam search as a ``SearchBackend``.  ``cache=True`` wraps the MDP in
    the shared transposition cache — beam re-prices identical default-
    completed prefixes across passes, so later passes become nearly free."""

    beam_size: int = 32
    passes: int = 5
    name: str = "beam"

    def run(self, mdp, *, seed=0, time_budget_s=None, measure_fn=None,
            cache: bool = False, **_) -> TuneResult:
        if cache and not isinstance(mdp, CachedMDP):
            mdp = CachedMDP(mdp)
        res = beam_search(
            mdp,
            beam_size=self.beam_size,
            passes=self.passes,
            seed=seed,
            time_budget_s=time_budget_s,
        )
        if isinstance(mdp, CachedMDP):
            res.cache_hits = mdp.cache.hits
            res.cache_misses = mdp.cache.misses
        return res


@dataclass
class GreedyBackend:
    name: str = "greedy"

    def run(self, mdp, *, seed=0, time_budget_s=None, measure_fn=None,
            **_) -> TuneResult:
        return greedy_search(mdp, seed=seed, time_budget_s=time_budget_s)

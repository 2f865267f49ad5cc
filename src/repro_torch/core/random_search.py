"""Random search baseline (paper §5: no cost model; best *measured* schedule
within the time budget — ours measures via the compile-based evaluator when
given one, else falls back to the cost model).

Cost-model evaluation routes through ``mdp.terminal_cost`` (not the cost
model directly) so a ``CachedMDP``-wrapped MDP dedupes re-sampled schedules
for free; sampled plans and costs are unchanged (``random_actions`` consumes
the RNG exactly as ``random_plan`` did)."""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.engine import CachedMDP
from repro_torch.core.ensemble import TuneResult
from repro_torch.core.mdp import ScheduleMDP


def random_search(
    mdp: ScheduleMDP,
    *,
    n_samples: int = 256,
    time_budget_s: Optional[float] = None,
    measure_fn: Optional[Callable] = None,
    seed: int = 0,
) -> TuneResult:
    t0 = time.perf_counter()
    rng = random.Random(seed)
    best_cost = float("inf")
    best_state = None
    n_meas = 0
    i = 0
    while True:
        if time_budget_s is not None:
            if time.perf_counter() - t0 > time_budget_s:
                break
        elif i >= n_samples:
            break
        state = tuple(mdp.space.random_actions(rng))
        if measure_fn is not None:
            c = measure_fn(mdp.plan(state))
        else:
            c = mdp.terminal_cost(state)
        n_meas += 1
        if c < best_cost:
            best_cost, best_state = c, state
        i += 1
    return TuneResult(
        plan=mdp.plan(best_state),
        cost=mdp.terminal_cost(best_state),
        measured=best_cost if measure_fn else None,
        n_evals=getattr(mdp.cost_model, "n_evals", 0),
        n_measurements=n_meas if measure_fn else 0,
        wall_time_s=time.perf_counter() - t0,
        algo="random",
    )


# ---------------------------------------------------------------------------
# SearchBackend adapter (repro_torch.core.engine.backend protocol)
# ---------------------------------------------------------------------------
@dataclass
class RandomBackend:
    n_samples: int = 256
    name: str = "random"

    def run(self, mdp, *, seed=0, time_budget_s=None, measure_fn=None,
            cache: bool = False, **_) -> TuneResult:
        if cache and not isinstance(mdp, CachedMDP):
            mdp = CachedMDP(mdp)
        res = random_search(
            mdp,
            n_samples=self.n_samples,
            time_budget_s=time_budget_s,
            measure_fn=measure_fn,
            seed=seed,
        )
        if isinstance(mdp, CachedMDP):
            res.cache_hits = mdp.cache.hits
            res.cache_misses = mdp.cache.misses
        return res

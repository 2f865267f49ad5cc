"""The ``SearchBackend`` protocol: one calling convention for every search
algorithm (MCTS ensemble, beam, greedy, random), so ``autotune`` — and any
future driver (distributed tuner, learned-cost trainer) — dispatches on an
algorithm name without knowing algorithm internals.

A backend is anything with a ``name`` and

    run(mdp, *, seed=0, time_budget_s=None, measure_fn=None, **opts)
        -> TuneResult

``resolve_backend(algo, engine=..., cost=...)`` maps the paper's Table-1
algorithm names to configured backend instances; ``engine`` selects the
MCTS tree representation — ``"array"`` flat numpy with batched leaf
evaluation (the default, differential-tested against the reference) or
``"reference"`` Node objects — and ``cost`` selects the serving layer of
the cost stack (``"analytic"`` exact; learned-cost serving is ROADMAP item
A5).  Whichever backend runs, batch pricing below the seam is the columnar
roofline kernel (``cost_model.PlanColumns`` + ``_terms_columnar``) —
bit-identical to the retained scalar oracle, so backend selection never
changes search values.

Execution options flow through ``**opts`` untouched: ``parallel=True``
runs MCTS ensembles on the persistent pinned worker pool
(``repro_torch.core.engine.workers`` — per-round deltas in both directions,
payload bytes surfaced on ``TuneResult``), ``n_workers`` caps that pool,
and non-MCTS backends simply ignore both.
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

from repro_torch.core.mcts import MCTSConfig


@runtime_checkable
class SearchBackend(Protocol):
    name: str

    def run(
        self,
        mdp,
        *,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
        measure_fn=None,
        **opts,
    ):  # -> TuneResult
        ...


# Table 1 configurations (time budgets scaled: the paper's 30s/10s/1s per
# decision assume a C++ cost model; ours exposes both iteration- and
# second-based budgets).
TABLE1 = {
    "mcts_30s": MCTSConfig(ucb="paper", iters_per_decision=384),
    "mcts_10s": MCTSConfig(ucb="paper", iters_per_decision=128),
    "mcts_1s": MCTSConfig(ucb="paper", iters_per_decision=16),
    "mcts_Cp10_30s": MCTSConfig(ucb="cp10", iters_per_decision=384),
    "mcts_sqrt2_30s": MCTSConfig(ucb="sqrt2", iters_per_decision=384),
    "mcts_cost+real_30s": MCTSConfig(ucb="paper", iters_per_decision=384),
    "mcts_cost+real_1s": MCTSConfig(ucb="paper", iters_per_decision=16),
    "mcts_binary_30s": MCTSConfig(
        ucb="paper", reward_mode="binary", iters_per_decision=384
    ),  # §4.1 0/1-reward ablation (paper: 9% worse)
}


def resolve_backend(
    algo: str, engine: str = "array", cost: str = "analytic"
) -> SearchBackend:
    """Map an algorithm name (paper §5 protocol) to a configured backend.

    ``cost`` configures MCTS backends' learned-cost serving mode; the
    non-model-based baselines (beam/greedy/random) ignore it — they price
    straight through the analytic model, as in the paper."""
    # imported here: beam/random/evolve/ensemble all define backends and
    # import TuneResult from ensemble, which imports this package
    from repro_torch.core.beam import BeamBackend, GreedyBackend
    from repro_torch.core.ensemble import MCTSEnsembleBackend
    from repro_torch.core.evolve import EvolutionarySearchBackend, PortfolioBackend
    from repro_torch.core.random_search import RandomBackend

    if algo == "beam":
        return BeamBackend(beam_size=32, passes=5)
    if algo == "greedy":
        return GreedyBackend()
    if algo == "random":
        return RandomBackend()
    if algo == "evolve":
        return EvolutionarySearchBackend()
    if algo == "portfolio":
        # member mcts/beam runs inherit the engine/cost selection through
        # the portfolio's run() opts
        return PortfolioBackend()
    if algo in TABLE1 or algo == "mcts":
        return MCTSEnsembleBackend(
            algo=algo,
            config=TABLE1.get(algo, TABLE1["mcts_30s"]),
            engine=engine,
            cost=cost,
            name="mcts",
        )
    raise ValueError(f"unknown algo {algo!r}")

"""Evolutionary search over COMPLETE schedules, plus the portfolio
meta-backend that races it against mcts/beam/random on one shared cache.

The paper's central argument — only complete schedules carry a trustworthy
cost — admits more searchers than MCTS.  An openevolve-style
mutate-and-evaluate loop is the natural non-tree member of the family:
individuals are complete action tuples, fitness is the certified
``cost_batch`` path (one deduplicated columnar/jit pricing pass per
generation through ``CachedMDP.terminal_cost_batch``), and no partial
schedule is ever compared (beam's failure mode, Fig. 1/2).

Typed operator catalog (one operator per decision stage, so closure over
``ScheduleSpace`` holds BY CONSTRUCTION — operators move option *indices*,
never raw values):

    flip      2-option stages (bool flags, opt/kv dtype, batch_axes):
              return the other option
    creep     ordered numeric knobs (microbatches, scan_chunk, overlap,
              attn_block): step ±1 through the option list, clamped inward
              at the ends
    resample  unordered categoricals (param_strategy, moe_mode, remat,
              grad_comm): uniform over the OTHER options

Crossover is uniform over stage indices (each gene from either parent), so
it is closed for the same reason.  Both closures are pinned by hypothesis
properties (decoded plan == re-encoded actions) in tests/test_properties.py.

Determinism: one ``random.Random(seed)`` drives sampling in a fixed order,
ties rank by (cost, state tuple), and fitness is the exact batched pricing
path — two runs with the same seed on the same cell are bit-identical
(asserted in the JAX package by tests/test_differential.py; the port gives
the JAX package's results, tests/test_torch_search.py).

``seed_plans``: plans that join the initial population ahead of random
fill.  The JAX package passes a plan store's recorded plans for the cell;
the store is ROADMAP item A10, so the port's ``autotune`` passes none.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.engine import CachedMDP
from repro_torch.core.ensemble import TuneResult
from repro_torch.core.space import ScheduleSpace, SchedulePlan, Stage

State = Tuple[int, ...]

# stages whose option tuples are ordered small->large (or lexicographically,
# for the flash-block pairs): ±1 neighbourhood moves are meaningful
ORDERED_STAGES = frozenset(
    {"microbatches", "scan_chunk", "overlap", "attn_block"}
)


def encode_plan(space: ScheduleSpace, plan: SchedulePlan) -> Optional[State]:
    """Action tuple for ``plan`` in ``space``, or None if any field value
    is not among the cell's options (plan stores can hold plans recorded
    under other cells or older space layouts — those simply don't seed)."""
    actions: List[int] = []
    for stage in space.stages:
        value = getattr(plan, stage.name)
        try:
            actions.append(stage.options.index(value))
        except ValueError:
            return None
    return tuple(actions)


def _op_flip(stage: Stage) -> Callable[[int, random.Random], int]:
    def op(idx: int, rng: random.Random) -> int:
        return 1 - idx

    return op


def _op_creep(stage: Stage) -> Callable[[int, random.Random], int]:
    last = len(stage.options) - 1

    def op(idx: int, rng: random.Random) -> int:
        if idx == 0:
            return 1
        if idx == last:
            return last - 1
        return idx + (1 if rng.random() < 0.5 else -1)

    return op


def _op_resample(stage: Stage) -> Callable[[int, random.Random], int]:
    n = len(stage.options)

    def op(idx: int, rng: random.Random) -> int:
        new = rng.randrange(n - 1)
        return new if new < idx else new + 1  # uniform over the others

    return op


def mutation_operators(
    space: ScheduleSpace,
) -> List[Tuple[str, int, Callable[[int, random.Random], int]]]:
    """The cell's typed operator catalog: ``(name, stage_depth, op)`` per
    mutable stage, where ``op(idx, rng)`` returns a DIFFERENT valid option
    index for that stage.  Single-option stages get no operator."""
    ops = []
    for depth, stage in enumerate(space.stages):
        n = len(stage.options)
        if n < 2:
            continue
        if n == 2:
            kind, op = "flip", _op_flip(stage)
        elif stage.name in ORDERED_STAGES:
            kind, op = "creep", _op_creep(stage)
        else:
            kind, op = "resample", _op_resample(stage)
        ops.append((f"{kind}:{stage.name}", depth, op))
    return ops


def mutate(
    actions: Sequence[int],
    rng: random.Random,
    ops: Sequence[Tuple[str, int, Callable]],
    rate: float,
) -> State:
    """Apply each stage's operator with probability ``rate``; if nothing
    fired, force one (a child identical to its parent is a wasted cache
    hit, not exploration)."""
    out = list(actions)
    changed = False
    for _name, depth, op in ops:
        if rng.random() < rate:
            out[depth] = op(out[depth], rng)
            changed = True
    if not changed and ops:
        _name, depth, op = ops[rng.randrange(len(ops))]
        out[depth] = op(out[depth], rng)
    return tuple(out)


def crossover(a: Sequence[int], b: Sequence[int], rng: random.Random) -> State:
    """Uniform crossover over stage indices — each gene from either parent,
    so the child is inside the space whenever the parents are."""
    return tuple(x if rng.random() < 0.5 else y for x, y in zip(a, b))


@dataclass
class EvolutionarySearchBackend:
    """``SearchBackend`` adapter: ``algo="evolve"`` via ``resolve_backend``.

    Population over complete plans; elitist generational loop with
    tournament selection, optional uniform crossover, and the typed
    per-stage mutation catalog above.  Fitness is ALWAYS the certified
    batched pricing path: each generation is one
    ``CachedMDP.terminal_cost_batch`` call, so re-visited individuals are
    cache hits and ``n_evals`` counts each unique plan's pricing exactly
    once for the whole run (the eval-budget accounting the differential
    tests pin).  ``measure_fn`` does not drive fitness (the paper's
    compile-and-run oracle is too slow for thousand-plan generations); if
    given, the final best plan is measured once."""

    population: int = 32
    generations: int = 24
    elite: int = 4
    tournament: int = 3
    crossover_rate: float = 0.5
    mutation_rate: float = 0.15
    name: str = "evolve"

    def run(
        self,
        mdp,
        *,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
        measure_fn: Optional[Callable] = None,
        cache: Optional[bool] = None,
        max_evals: Optional[int] = None,
        seed_plans: Optional[Sequence[SchedulePlan]] = None,
        controller=None,
        **_,
    ) -> TuneResult:
        t0 = time.perf_counter()
        if cache is None:
            cache = True  # the batched fitness path wants the shared cache
        if cache and not isinstance(mdp, CachedMDP):
            mdp = CachedMDP(mdp)
        space = mdp.space
        ops = mutation_operators(space)
        rng = random.Random(seed)
        cost_model = getattr(mdp, "cost_model", None)

        def evals() -> int:
            return getattr(cost_model, "n_evals", 0)

        evals0 = evals()

        # ---- generation 0: defaults + store seeds + random fill ----
        pop: List[State] = []
        seen = set()

        def add(state: State) -> None:
            if state not in seen:
                seen.add(state)
                pop.append(state)

        add(tuple(space.default_actions()))
        for p in seed_plans or ():
            enc = encode_plan(space, p)
            if enc is not None:
                add(enc)
        del pop[self.population:]
        while len(pop) < self.population:
            add(tuple(space.random_actions(rng)))

        best_state: Optional[State] = None
        best_cost = float("inf")
        decisions: List[dict] = []
        interrupted = None
        g = 0
        while True:
            costs = mdp.terminal_cost_batch(pop)
            for s, c in zip(pop, costs):
                if c < best_cost or (
                    c == best_cost and (best_state is None or s < best_state)
                ):
                    best_cost, best_state = c, s
            decisions.append({
                "generation": g,
                "best_cost": best_cost,
                "population": len(pop),
                "n_evals": evals() - evals0,
            })
            g += 1
            if g >= self.generations:
                break
            if (time_budget_s is not None
                    and time.perf_counter() - t0 > time_budget_s):
                break
            if max_evals is not None and evals() - evals0 >= max_evals:
                break
            if controller is not None:
                # generation boundary = this backend's round boundary
                # (core/run_control.py): a deadline/cancel finishes the
                # generation and returns best-so-far.  No checkpoints —
                # an evolve replay from scratch is deterministic and
                # cheap, so resume-from-checkpoint buys nothing here.
                controller.begin_round()
                controller.round_done()
                reason = controller.should_stop()
                if reason is not None:
                    interrupted = {
                        "reason": reason,
                        "rounds_done": g,
                        "rounds_total": self.generations,
                        "checkpointed": False,
                    }
                    break
            # ---- next generation: elites + tournament offspring ----
            ranked = sorted(range(len(pop)), key=lambda i: (costs[i], pop[i]))
            nxt = [pop[i] for i in ranked[: self.elite]]

            def select() -> State:
                best_i = min(
                    (rng.randrange(len(pop)) for _ in range(self.tournament)),
                    key=lambda i: (costs[i], pop[i]),
                )
                return pop[best_i]

            while len(nxt) < self.population:
                parent = select()
                if rng.random() < self.crossover_rate:
                    parent = crossover(parent, select(), rng)
                nxt.append(mutate(parent, rng, ops, self.mutation_rate))
            pop = nxt

        measured = None
        n_meas = 0
        if measure_fn is not None:
            measured = measure_fn(mdp.plan(best_state))
            n_meas = 1
        res = TuneResult(
            plan=mdp.plan(best_state),
            cost=mdp.terminal_cost(best_state),  # warm: a cache hit
            measured=measured,
            n_evals=evals(),
            n_measurements=n_meas,
            wall_time_s=time.perf_counter() - t0,
            decisions=decisions,
            algo="evolve",
        )
        if isinstance(mdp, CachedMDP):
            res.cache_hits = mdp.cache.hits
            res.cache_misses = mdp.cache.misses
        if interrupted is not None:
            res.stats["interrupted"] = interrupted
        return res


@dataclass
class PortfolioBackend:
    """``algo="portfolio"``: race member searchers on ONE shared
    ``TranspositionCache`` under one eval budget.

    Members run sequentially (deterministic, and on the few-core boxes this
    repo targets, concurrency would just interleave the same work) over the
    same ``CachedMDP``: a plan priced by any member is a cache hit for
    every later member, so the TOTAL unique-plan pricing work is shared —
    ``n_evals`` on the returned result counts each unique plan exactly
    once across the whole portfolio.  ``max_evals`` (when given) is
    decremented by each member's unique-eval consumption; members that
    take an explicit budget (evolve, random) receive the remainder, and a
    spent budget skips the members after it.

    The reported winner is the best member's result, bit-for-bit: the
    winning plan/cost are returned unmodified (asserted by the
    differential tests), with each member's summary — including its full
    plan dict — in ``decisions``."""

    members: Tuple[str, ...] = ("evolve", "mcts_1s", "beam", "random")
    name: str = "portfolio"

    def run(
        self,
        mdp,
        *,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
        measure_fn: Optional[Callable] = None,
        cache: bool = True,
        max_evals: Optional[int] = None,
        seed_plans: Optional[Sequence[SchedulePlan]] = None,
        engine: str = "array",
        cost: str = "analytic",
        n_standard: int = 4,
        n_greedy: int = 1,
        device: str = "cuda",
        **_,
    ) -> TuneResult:
        from repro_torch.core.engine.backend import resolve_backend
        from repro_torch.core.random_search import RandomBackend

        t0 = time.perf_counter()
        if not isinstance(mdp, CachedMDP):
            mdp = CachedMDP(mdp)
        cost_model = getattr(mdp, "cost_model", None)

        def evals() -> int:
            return getattr(cost_model, "n_evals", 0)

        evals0 = evals()
        member_budget_s = (
            time_budget_s / len(self.members) if time_budget_s else None
        )
        results: List[Tuple[str, TuneResult]] = []
        for algo in self.members:
            remaining = (
                None if max_evals is None
                else max_evals - (evals() - evals0)
            )
            if remaining is not None and remaining <= 0:
                break
            opts = dict(cache=True, seed_plans=seed_plans)
            if algo == "evolve":
                backend = EvolutionarySearchBackend()
                opts["max_evals"] = remaining
            elif algo == "random":
                n = 256 if remaining is None else min(256, remaining)
                backend = RandomBackend(n_samples=n)
            else:
                backend = resolve_backend(algo, engine=engine, cost=cost)
                opts.update(n_standard=n_standard, n_greedy=n_greedy, device=device)
            res = backend.run(
                mdp, seed=seed, time_budget_s=member_budget_s, **opts
            )
            results.append((algo, res))
        win_i = min(range(len(results)), key=lambda i: (results[i][1].cost, i))
        winner = results[win_i][1]
        decisions = [
            {
                "member": algo,
                "cost": r.cost,
                "n_evals": r.n_evals,
                "wall_time_s": r.wall_time_s,
                "plan": r.plan.to_dict(),
                "winner": i == win_i,
            }
            for i, (algo, r) in enumerate(results)
        ]
        out = TuneResult(
            plan=winner.plan,
            cost=winner.cost,
            measured=winner.measured,
            n_evals=evals(),
            n_measurements=winner.n_measurements,
            wall_time_s=time.perf_counter() - t0,
            decisions=decisions,
            algo="portfolio",
        )
        out.cache_hits = mdp.cache.hits
        out.cache_misses = mdp.cache.misses
        return out

"""Monte Carlo Tree Search over the scheduling MDP (paper §4, Table 1).

Faithful to the paper:

* Nodes store the running **average** cost (used by the tree policy), the
  **best** cost seen through them, and the complete schedule achieving it.
* The tree policy is the paper's multiplicative UCB
  ``(1/avg_cost)·(1 + Cp·√(ln n / n_j))`` (``ucb="paper"``, Cp=1;
  ``ucb="cp10"``, Cp=10) or the classical additive UCB1 with Cp=√2 on
  normalized rewards (``ucb="sqrt2"``).
* Simulation is uniform-random (standard trees) or purely greedy on the
  cost model (the single greedy tree of §4.1).
* Costs are only ever read from **complete** schedules at simulation end.
* The winning root action is the child whose subtree found the best
  **best-cost** (not average) — §4: "+25% over average".
* Budget per root decision: iteration count (deterministic) or wall-clock
  seconds (paper's 30s/10s/1s/0.5s protocol).
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.mdp import ScheduleMDP, State

INF = float("inf")


@dataclass(frozen=True)
class MCTSConfig:
    ucb: str = "paper"  # paper | cp10 | sqrt2
    simulation: str = "random"  # random | greedy
    reward_mode: str = "cost"  # cost | binary (§4.1 0/1-reward ablation)
    iters_per_decision: Optional[int] = 128
    seconds_per_decision: Optional[float] = None
    seed: int = 0

    @property
    def cp(self) -> float:
        return 10.0 if self.ucb == "cp10" else 1.0


class Node:
    __slots__ = (
        "action",
        "depth",
        "children",
        "untried",
        "n",
        "sum_cost",
        "sum_reward",
        "best_cost",
        "best_state",
    )

    def __init__(self, action: Optional[int], depth: int, n_actions: int):
        self.action = action
        self.depth = depth
        self.children: Dict[int, "Node"] = {}
        self.untried: List[int] = list(range(n_actions))
        self.n = 0
        self.sum_cost = 0.0
        self.sum_reward = 0.0
        self.best_cost = INF
        self.best_state: Optional[State] = None

    @property
    def avg_cost(self) -> float:
        return self.sum_cost / self.n if self.n else INF


@dataclass
class DecisionResult:
    action: int
    best_cost: float
    best_state: State
    iterations: int


class MCTS:
    """One search tree; ``run_decision`` spends the budget then reports its
    best child (the ensemble synchronizes roots across trees)."""

    def __init__(self, mdp: ScheduleMDP, config: MCTSConfig):
        self.mdp = mdp
        self.cfg = config
        self.rng = random.Random(config.seed)
        self.root_state: State = mdp.initial_state
        self.root = self._make_node(None, self.root_state)
        self.baseline: Optional[float] = None  # reward normalizer (sqrt2 mode)
        self.global_best = INF
        self.global_best_state: Optional[State] = None
        self.sim_time = 0.0  # §5.3 bookkeeping: time generating children
        self.eval_time = 0.0  # time in cost evaluation

    # ------------------------------------------------------------------
    def _make_node(self, action, state: State) -> Node:
        n_act = 0 if self.mdp.is_terminal(state) else self.mdp.n_actions(state)
        return Node(action, len(state), n_act)

    def _ucb_score(self, parent: Node, child: Node) -> float:
        c = self.cfg
        explore = math.sqrt(math.log(max(parent.n, 1)) / child.n)
        if c.ucb in ("paper", "cp10"):
            exploit = 1.0 / child.avg_cost
            return exploit * (1.0 + c.cp * explore)
        if c.ucb == "sqrt2":
            # rewards are normalized (baseline/cost, ~1.0 at baseline) or 0/1
            mean_r = child.sum_reward / child.n
            return mean_r + math.sqrt(2.0) * math.sqrt(
                2.0 * math.log(max(parent.n, 1)) / child.n
            )
        raise ValueError(c.ucb)

    # ------------------------------------------------------------------
    def _select(self) -> Tuple[Node, State, List[Node]]:
        node, state = self.root, self.root_state
        path = [node]
        while not node.untried and node.children:
            node = max(node.children.values(), key=lambda ch: self._ucb_score(node, ch))
            state = self.mdp.step(state, node.action)
            path.append(node)
        return node, state, path

    def _expand(self, node: Node, state: State) -> Tuple[Node, State, Optional[Node]]:
        if self.mdp.is_terminal(state) or not node.untried:
            return node, state, None
        a = node.untried.pop(self.rng.randrange(len(node.untried)))
        child_state = self.mdp.step(state, a)
        child = self._make_node(a, child_state)
        node.children[a] = child
        return child, child_state, child

    def _simulate(self, state: State) -> Tuple[State, float]:
        t0 = time.perf_counter()
        while not self.mdp.is_terminal(state):
            n = self.mdp.n_actions(state)
            if self.cfg.simulation == "greedy":
                # greedy default policy: rank children by (unreliable)
                # default-completed cost; ties to the rng
                best_a, best_c = 0, INF
                for a in range(n):
                    c = self.mdp.partial_cost(self.mdp.step(state, a))
                    if c < best_c or (c == best_c and self.rng.random() < 0.5):
                        best_a, best_c = a, c
                state = self.mdp.step(state, best_a)
            else:
                state = self.mdp.step(state, self.rng.randrange(n))
        self.sim_time += time.perf_counter() - t0
        t1 = time.perf_counter()
        cost = self.mdp.terminal_cost(state)
        self.eval_time += time.perf_counter() - t1
        return state, cost

    def _backprop(self, path: List[Node], terminal: State, cost: float):
        if self.baseline is None:
            self.baseline = cost
        beat_best = cost < self.global_best
        if beat_best:
            self.global_best = cost
            self.global_best_state = terminal
        for node in path:
            node.n += 1
            node.sum_cost += cost
            if self.cfg.reward_mode == "binary":
                node.sum_reward += 1.0 if beat_best else 0.0
            else:
                node.sum_reward += (self.baseline / cost) if cost > 0 else 0.0
            if cost < node.best_cost:
                node.best_cost = cost
                node.best_state = terminal

    def iterate_once(self):
        node, state, path = self._select()
        child, child_state, created = self._expand(node, state)
        if created is not None:
            path.append(created)
        terminal, cost = self._simulate(child_state)
        self._backprop(path, terminal, cost)

    # ------------------------------------------------------------------
    def run_decision(self) -> DecisionResult:
        """Spend the per-decision budget, return the winning child."""
        c = self.cfg
        iters = 0
        t0 = time.perf_counter()
        while True:
            if c.seconds_per_decision is not None:
                if time.perf_counter() - t0 >= c.seconds_per_decision and iters > 0:
                    break
                if iters >= 100000:
                    break
            elif iters >= (c.iters_per_decision or 1):
                break
            self.iterate_once()
            iters += 1
        # winner: best BEST-cost child (paper §4, after [9])
        if not self.root.children:
            self.iterate_once()
            iters += 1
        best_child = min(
            self.root.children.values(), key=lambda ch: (ch.best_cost, ch.action)
        )
        return DecisionResult(
            action=best_child.action,
            best_cost=best_child.best_cost,
            best_state=best_child.best_state,
            iterations=iters,
        )

    def advance_root(self, action: int):
        """Move the root to the (synchronized) winning child, keeping the
        subtree (tree reuse as in the paper's Fig. 6 loop)."""
        self.root_state = self.mdp.step(self.root_state, action)
        child = self.root.children.get(action)
        if child is None:
            child = self._make_node(action, self.root_state)
        self.root = child

    @property
    def done(self) -> bool:
        return self.mdp.is_terminal(self.root_state)

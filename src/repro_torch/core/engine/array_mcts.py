"""Array-flattened MCTS: the reference search in flat numpy storage.

Same algorithm as ``repro_torch.core.mcts.MCTS`` — selection, expansion,
simulation, backprop, all three UCB variants, both simulation policies —
but the tree lives in flat arrays indexed by node id
(``visit_counts``, ``sum_cost``, ``sum_reward``, ``best_cost``,
``node_action``, and a ``children`` id table), so the per-level UCB score
is computed over all children at once instead of a Python
``max(..., key=...)`` over ``Node`` objects (after Ragan et al.,
*Array-Based Monte Carlo Tree Search*): one vectorized numpy expression
for wide nodes, an unrolled scalar loop over the same arrays for narrow
nodes where numpy call overhead would dominate.  For ``ScheduleMDP``s the
engine additionally precomputes the static depth->n_actions table so
selection and rollout skip per-step MDP dispatch.

Behavioral equivalence is exact, not approximate: the RNG call sequence
matches the reference line for line, and every float in the UCB score is
computed with the same IEEE-754 operations in the same order (the scalar
``math.log`` of the parent count feeds correctly-rounded numpy
``sqrt``/``divide``/``multiply``), so for a fixed seed both engines select
identical paths, sample identical terminals, and report identical
``best_cost`` — the parity tests in ``tests/test_engine.py`` assert this
for every UCB × simulation combination.
"""
from __future__ import annotations

import math
import random
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.mcts import DecisionResult, MCTSConfig

INF = float("inf")


class ArrayMCTS:
    """Drop-in engine with the reference ``MCTS`` interface
    (``run_decision`` / ``advance_root`` / ``done``)."""

    def __init__(self, mdp, config: MCTSConfig, capacity: int = 1024):
        self.mdp = mdp
        self.cfg = config
        if config.ucb not in ("paper", "cp10", "sqrt2"):
            raise ValueError(config.ucb)
        self._paper = config.ucb in ("paper", "cp10")
        self._cp = config.cp
        self.rng = random.Random(config.seed)
        self.baseline: Optional[float] = None
        self.global_best = INF
        self.global_best_state: Optional[Tuple[int, ...]] = None
        self.sim_time = 0.0
        self.eval_time = 0.0

        # flat node storage -------------------------------------------------
        cap = max(capacity, 16)
        self.size = 0
        self.visit_counts = np.zeros(cap, dtype=np.int64)
        self.sum_cost = np.zeros(cap, dtype=np.float64)
        self.sum_reward = np.zeros(cap, dtype=np.float64)
        self.best_cost = np.full(cap, INF, dtype=np.float64)
        self.node_action = np.full(cap, -1, dtype=np.int32)
        self.n_children = np.zeros(cap, dtype=np.int32)
        # children[nid, slot] = child id, slots filled in insertion order
        # (same tie-break order as the reference dict iteration)
        self.children = np.full((cap, 4), -1, dtype=np.int32)
        self.untried: List[List[int]] = []
        self.best_state: List[Optional[Tuple[int, ...]]] = []
        # python mirrors of the tree STRUCTURE (child ids per node) for the
        # scalar hot paths; the numpy ``children`` table stays canonical and
        # feeds the batched-UCB path for wide nodes
        self._childlist: List[List[int]] = []

        self.root_state: Tuple[int, ...] = mdp.initial_state
        # fast path: a ScheduleMDP's transition structure is static — states
        # are action prefixes, the action count depends only on depth, and
        # ``step`` is tuple append.  Precomputing the depth->n_actions table
        # lets selection and rollout skip per-step method dispatch entirely
        # (values and RNG consumption are unchanged).  Other MDPs (test
        # doubles) take the generic path.
        self._depth_actions: Optional[List[int]] = None
        inner = getattr(mdp, "mdp", mdp)  # unwrap CachedMDP
        from repro_torch.core.mdp import ScheduleMDP

        if isinstance(inner, ScheduleMDP):
            space = inner.space
            self._depth_actions = [
                space.n_actions(d) for d in range(space.n_stages)
            ]
        # per-round delta recording (process-pool workers; see
        # begin_delta/collect_delta/apply_delta)
        self._delta_base: Optional[int] = None
        self._delta_parents: List[int] = []
        self._delta_best: List[int] = []
        self._delta_touched: List[int] = []
        self.root = self._new_node(-1, self.root_state)

    # -- storage management ------------------------------------------------
    @staticmethod
    def _extend(arr: np.ndarray, cap: int, fill) -> np.ndarray:
        out = np.full((cap,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    def _grow_nodes(self):
        cap = self.visit_counts.shape[0] * 2
        self.visit_counts = self._extend(self.visit_counts, cap, 0)
        self.sum_cost = self._extend(self.sum_cost, cap, 0.0)
        self.sum_reward = self._extend(self.sum_reward, cap, 0.0)
        self.best_cost = self._extend(self.best_cost, cap, INF)
        self.node_action = self._extend(self.node_action, cap, -1)
        self.n_children = self._extend(self.n_children, cap, 0)
        self.children = self._extend(self.children, cap, -1)

    def _grow_width(self, need: int):
        w = self.children.shape[1]
        while w < need:
            w *= 2
        wider = np.full((self.children.shape[0], w), -1, dtype=np.int32)
        wider[:, : self.children.shape[1]] = self.children
        self.children = wider

    def _new_node(self, action: int, state) -> int:
        if self.size >= self.visit_counts.shape[0]:
            self._grow_nodes()
        nid = self.size
        self.size += 1
        self.visit_counts[nid] = 0
        self.sum_cost[nid] = 0.0
        self.sum_reward[nid] = 0.0
        self.best_cost[nid] = INF
        self.node_action[nid] = action
        self.n_children[nid] = 0
        da = self._depth_actions
        if da is not None:
            d = len(state)
            n_act = 0 if d >= len(da) else da[d]
        else:
            n_act = 0 if self.mdp.is_terminal(state) else self.mdp.n_actions(state)
        self.untried.append(list(range(n_act)))
        self.best_state.append(None)
        self._childlist.append([])
        return nid

    # -- tree policy (vectorized) -------------------------------------------
    def _best_child(self, nid: int) -> int:
        """argmax of the UCB score over the children.

        Wide nodes take the batched numpy path (one vectorized expression
        over all children at once); narrow nodes (the common case — most
        stages have 2-4 options) use an unrolled scalar loop, because numpy
        call overhead dominates below ~8 elements.  Both paths and the
        reference compute the same IEEE-754 operations in the same order
        (``np.sqrt``/``math.sqrt`` are correctly rounded), so scores — and
        therefore argmax with first-of-ties — are bit-identical."""
        kids = self._childlist[nid]
        nc = len(kids)
        if nc == 1:  # single-option stage: argmax is the only child
            return kids[0]
        logn = math.log(max(int(self.visit_counts[nid]), 1))
        paper = self._paper
        if nc < 8:
            vc, sc, sr = self.visit_counts, self.sum_cost, self.sum_reward
            cp, sqrt = self._cp, math.sqrt
            best_id = -1
            best_score = None
            for cid in kids:
                n = float(vc[cid])
                if paper:
                    # exploit = 1/(sum/n); score = exploit*(1+cp*sqrt(logn/n))
                    score = (1.0 / (float(sc[cid]) / n)) * (
                        1.0 + cp * sqrt(logn / n)
                    )
                else:
                    score = float(sr[cid]) / n + sqrt(2.0) * sqrt(2.0 * logn / n)
                if best_score is None or score > best_score:  # first of ties
                    best_id, best_score = cid, score
            return best_id
        ids = self.children[nid, :nc]
        n = self.visit_counts[ids].astype(np.float64)
        if paper:
            exploit = 1.0 / (self.sum_cost[ids] / n)
            scores = exploit * (1.0 + self._cp * np.sqrt(logn / n))
        else:
            mean_r = self.sum_reward[ids] / n
            scores = mean_r + math.sqrt(2.0) * np.sqrt(2.0 * logn / n)
        # np.argmax keeps the first of tied maxima — same rule as max() over
        # the reference dict's insertion-ordered children
        return int(ids[int(np.argmax(scores))])

    def _select(self):
        nid, state = self.root, self.root_state
        fast = self._depth_actions is not None
        untried, childlist = self.untried, self._childlist
        actions, best_child = self.node_action, self._best_child
        path = [nid]
        while not untried[nid] and childlist[nid]:
            nid = best_child(nid)
            a = int(actions[nid])
            state = state + (a,) if fast else self.mdp.step(state, a)
            path.append(nid)
        return nid, state, path

    def _is_terminal(self, state) -> bool:
        if self._depth_actions is not None:
            return len(state) >= len(self._depth_actions)
        return self.mdp.is_terminal(state)

    def _expand(self, nid: int, state):
        if self._is_terminal(state) or not self.untried[nid]:
            return nid, state, None
        pool = self.untried[nid]
        a = pool.pop(self.rng.randrange(len(pool)))
        child_state = (
            state + (a,) if self._depth_actions is not None
            else self.mdp.step(state, a)
        )
        child = self._new_node(a, child_state)
        slot = len(self._childlist[nid])
        if slot >= self.children.shape[1]:
            self._grow_width(slot + 1)
        self.children[nid, slot] = child
        self.n_children[nid] = slot + 1
        self._childlist[nid].append(child)
        if self._delta_base is not None:
            self._delta_parents.append(nid)
        return child, child_state, child

    # -- default policy ------------------------------------------------------
    def _simulate(self, state):
        t0 = time.perf_counter()
        da = self._depth_actions
        greedy = self.cfg.simulation == "greedy"
        if da is not None:
            # fast rollout: no per-step MDP dispatch; RNG consumption is
            # identical to the generic path (one randrange per depth, or the
            # greedy partial_cost sweep with the same tie-break draws)
            n_stages = len(da)
            if not greedy:
                rr = self.rng.randrange
                d = len(state)
                state = state + tuple(rr(da[i]) for i in range(d, n_stages))
            else:
                partial = self.mdp.partial_cost
                rand = self.rng.random
                while len(state) < n_stages:
                    best_a, best_c = 0, INF
                    for a in range(da[len(state)]):
                        c = partial(state + (a,))
                        if c < best_c or (c == best_c and rand() < 0.5):
                            best_a, best_c = a, c
                    state = state + (best_a,)
        else:
            while not self.mdp.is_terminal(state):
                n = self.mdp.n_actions(state)
                if greedy:
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

    def _backprop(self, path: List[int], terminal, cost: float):
        if self.baseline is None:
            self.baseline = cost
        beat_best = cost < self.global_best
        if beat_best:
            self.global_best = cost
            self.global_best_state = terminal
        if self.cfg.reward_mode == "binary":
            r = 1.0 if beat_best else 0.0
        else:
            r = (self.baseline / cost) if cost > 0 else 0.0
        rec = self._delta_best if self._delta_base is not None else None
        if rec is not None:
            # pre-round nodes whose visit/sum stats this backprop touches:
            # exactly what collect_delta must ship besides the new slices
            base = self._delta_base
            self._delta_touched.extend(n for n in path if n < base)
        if len(path) < 16:
            vc, sc, sr, bc = (
                self.visit_counts, self.sum_cost, self.sum_reward, self.best_cost,
            )
            for nid in path:
                vc[nid] += 1
                sc[nid] += cost
                sr[nid] += r
                if cost < bc[nid]:
                    bc[nid] = cost
                    self.best_state[nid] = terminal
                    if rec is not None:
                        rec.append(nid)
        else:
            ids = np.asarray(path, dtype=np.int64)
            self.visit_counts[ids] += 1
            self.sum_cost[ids] += cost
            self.sum_reward[ids] += r
            improved = ids[self.best_cost[ids] > cost]
            self.best_cost[improved] = cost
            for nid in improved:
                self.best_state[int(nid)] = terminal
                if rec is not None:
                    rec.append(int(nid))

    def iterate_once(self):
        nid, state, path = self._select()
        child, child_state, created = self._expand(nid, state)
        if created is not None:
            path.append(created)
        terminal, cost = self._simulate(child_state)
        self._backprop(path, terminal, cost)

    # -- decision loop --------------------------------------------------------
    def run_decision(self) -> DecisionResult:
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
        if not self._childlist[self.root]:
            self.iterate_once()
            iters += 1
        return self._root_decision(iters)

    def _root_decision(self, iters: int) -> DecisionResult:
        """Winner among the root's children: best BEST-cost child, ties to
        the lowest action — same (best_cost, action) key as the reference."""
        ids = self._childlist[self.root]
        keys = [
            (float(self.best_cost[i]), int(self.node_action[i])) for i in ids
        ]
        best = ids[min(range(len(keys)), key=keys.__getitem__)]
        return DecisionResult(
            action=int(self.node_action[best]),
            best_cost=float(self.best_cost[best]),
            best_state=self.best_state[best],
            iterations=iters,
        )

    # -- per-round tree deltas (process-pool transport) ----------------------
    # A worker runs one decision round and ships back ONLY what the round
    # changed, instead of pickling the whole tree: the round's NEW node
    # slices (``[base:size]`` stat/structure buffers), the stat rows of the
    # round's TOUCHED pre-round nodes (the backprop paths — recorded during
    # the round, so the numeric payload scales with the round, not with the
    # total tree), and the point mutations to pre-round nodes (untried
    # pools / child table rows of expanded parents, improved best-states).
    # The master applies the delta to the tree object it kept, which
    # reproduces the worker's post-round tree exactly — asserted by
    # tests/test_engine.py::test_parallel_delta_merge_equals_whole_tree.
    # This is the REVERSE direction of the pinned-worker protocol
    # (engine/workers.py); the forward direction needs no tree payload at
    # all — the master's root-synchronization action is replayed through
    # ``advance_root``, which both sides apply to identical trees.

    def begin_delta(self):
        """Start recording a round's mutations (worker side)."""
        self._delta_base = self.size
        self._delta_parents = []
        self._delta_best = []
        self._delta_touched = []

    def collect_delta(self) -> dict:
        """Package the recorded round as a picklable delta and stop
        recording.  Payload is a TRUE delta: ``[base:size]`` slices for
        the round's new nodes plus the touched pre-round stat rows —
        nothing proportional to the pre-round tree ships."""
        base = self._delta_base
        size = self.size
        parents = sorted({n for n in self._delta_parents if n < base})
        improved = {n for n in self._delta_best if n < base}
        # every pre-round node whose numeric stats changed this round:
        # backprop paths (visit/sum/best writes); expanded parents' stat
        # changes are also backprop writes, so ``touched`` covers them
        touched = np.fromiter(
            sorted(set(self._delta_touched)), dtype=np.int64,
        )
        delta = {
            "base": base,
            "size": size,
            "width": self.children.shape[1],
            "visit_counts": self.visit_counts[base:size].copy(),
            "sum_cost": self.sum_cost[base:size].copy(),
            "sum_reward": self.sum_reward[base:size].copy(),
            "best_cost": self.best_cost[base:size].copy(),
            "node_action": self.node_action[base:size].copy(),
            "n_children": self.n_children[base:size].copy(),
            "children": self.children[base:size].copy(),
            "touched": touched,
            "touched_visit": self.visit_counts[touched],
            "touched_sum_cost": self.sum_cost[touched],
            "touched_sum_reward": self.sum_reward[touched],
            "touched_best_cost": self.best_cost[touched],
            # expanded pre-round parents: their children-table rows gained
            # slots this round (n_children rides along per parent)
            "children_mut": {n: self.children[n].copy() for n in parents},
            "n_children_mut": {n: int(self.n_children[n]) for n in parents},
            "untried_new": self.untried[base:],
            "childlist_new": self._childlist[base:],
            "best_state_new": self.best_state[base:],
            "untried_mut": {n: self.untried[n] for n in parents},
            "childlist_mut": {n: self._childlist[n] for n in parents},
            "best_state_mut": {n: self.best_state[n] for n in improved},
            "rng": self.rng.getstate(),
            "baseline": self.baseline,
            "global_best": self.global_best,
            "global_best_state": self.global_best_state,
            "sim_time": self.sim_time,
            "eval_time": self.eval_time,
        }
        self._delta_base = None
        self._delta_parents = []
        self._delta_best = []
        self._delta_touched = []
        return delta

    def apply_delta(self, delta: dict):
        """Apply a worker's round delta to this (pre-round) tree, making it
        equal to the worker's post-round tree."""
        base, size = delta["base"], delta["size"]
        if base != len(self.untried):
            raise ValueError(
                f"delta base {base} does not match tree size {len(self.untried)}"
            )
        while self.visit_counts.shape[0] < size:
            self._grow_nodes()
        width = delta["width"]
        if self.children.shape[1] < width:
            self._grow_width(width)
        self.size = size
        self.visit_counts[base:size] = delta["visit_counts"]
        self.sum_cost[base:size] = delta["sum_cost"]
        self.sum_reward[base:size] = delta["sum_reward"]
        self.best_cost[base:size] = delta["best_cost"]
        self.node_action[base:size] = delta["node_action"]
        self.n_children[base:size] = delta["n_children"]
        self.children[base:size, :width] = delta["children"]
        t = delta["touched"]
        self.visit_counts[t] = delta["touched_visit"]
        self.sum_cost[t] = delta["touched_sum_cost"]
        self.sum_reward[t] = delta["touched_sum_reward"]
        self.best_cost[t] = delta["touched_best_cost"]
        for n, row in delta["children_mut"].items():
            self.children[n, : row.shape[0]] = row
        for n, v in delta["n_children_mut"].items():
            self.n_children[n] = v
        self.untried.extend(delta["untried_new"])
        self._childlist.extend(delta["childlist_new"])
        self.best_state.extend(delta["best_state_new"])
        for n, pool in delta["untried_mut"].items():
            self.untried[n] = pool
        for n, kids in delta["childlist_mut"].items():
            self._childlist[n] = kids
        for n, st in delta["best_state_mut"].items():
            self.best_state[n] = st
        self.rng.setstate(delta["rng"])
        self.baseline = delta["baseline"]
        self.global_best = delta["global_best"]
        self.global_best_state = delta["global_best_state"]
        self.sim_time = delta["sim_time"]
        self.eval_time = delta["eval_time"]

    def advance_root(self, action: int):
        self.root_state = self.mdp.step(self.root_state, action)
        nxt = -1
        for i in self._childlist[self.root]:
            if int(self.node_action[i]) == action:
                nxt = i
                break
        if nxt < 0:
            nxt = self._new_node(action, self.root_state)
        self.root = nxt

    @property
    def done(self) -> bool:
        return self.mdp.is_terminal(self.root_state)


def delta_nbytes(delta: dict) -> int:
    """Numeric payload of a collected round delta, in bytes — the array
    buffers that dominate the wire size (new-node slices, touched stat
    rows, expanded parents' child-table rows).  Payload accounting for the
    O(new nodes + touched rows) transport claim: this number scales with
    the ROUND, while ``pickle.dumps(tree)`` scales with the whole tree."""
    n = 0
    for v in delta.values():
        if isinstance(v, np.ndarray):
            n += v.nbytes
    for row in delta["children_mut"].values():
        n += row.nbytes
    return n

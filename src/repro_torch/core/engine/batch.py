"""Lockstep batched decision rounds for ``ArrayMCTS``: the pending-leaf
queue that makes leaf evaluation — ProTuner's hot path — batched end-to-end.

Within one decision round the K ensemble trees are independent given the
transposition cache: tree i's trajectory depends only on its own RNG stream
and its own node statistics, and the cache is a pure memo (it changes which
states get *priced*, never the values returned).  Running the K trees'
iterations in lockstep is therefore exactly sequential-equivalent — same
plans, costs, and decision sequences; with the shared cache on (the array
engine's default) even the aggregate cache hit/miss and ``n_evals`` totals
match, because "first lookup of a state is a miss, every later one a hit"
does not depend on lookup order.  (Uncached, ``cost_batch``'s in-call
dedup can price a leaf shared by two trees once where the scalar loop
prices it twice — values are unaffected, only ``n_evals`` drops.)  What changes
is the shape of the work: each lockstep step exposes K complete schedules
to ONE ``terminal_cost_batch`` call (select-many → expand-many →
evaluate-batch → backprop-many) instead of K interleaved scalar
``terminal_cost`` calls, so duplicate leaves collapse and the round's
deduplicated miss batch prices through one ``PlanColumns`` encode and one
vectorized columnar-kernel pass (``AnalyticCostModel.cost_batch`` →
``_terms_columnar``; bit-identical to the scalar walk by certification).  Greedy rollout tails batch the same
way: each depth's candidate sweep prices through ``partial_cost_batch`` in
one call, with the reference's tie-break RNG draws replayed afterwards in
action order (evaluation consumes no RNG, so the stream is unchanged).

The driver also restructures the per-iteration bookkeeping: each tree's
hot per-node stats live in plain-Python list mirrors for the duration of
the round (scalar list reads/writes are ~3x cheaper than numpy scalar
indexing, and selection/backprop are exactly such scalar walks), flushed
back into the canonical flat arrays in one vectorized assignment per field
at round end.  UCB arithmetic replays the reference's IEEE-754 operation
sequence, so parity stays exact — certified across the full
(UCB × policy × reward × seed) grid by ``tests/test_differential.py``.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

from repro_torch.core.engine.array_mcts import INF, ArrayMCTS
from repro_torch.core.mcts import DecisionResult

SQRT2 = math.sqrt(2.0)

State = Tuple[int, ...]


def _terminal_cost_batch(mdp, states: List[State]) -> List[float]:
    fn = getattr(mdp, "terminal_cost_batch", None)
    if fn is not None:
        return fn(states)
    return [mdp.terminal_cost(s) for s in states]


class _TreeCursor:
    """One tree's view of a lockstep round.

    Carries Python-list mirrors of the flat per-node stat arrays plus local
    bindings of everything the select/expand/rollout walk touches; shares
    the tree's RNG and python-side structure (``untried``/``_childlist``/
    ``best_state``) by reference, so expansion mutates the tree directly and
    ``flush`` only needs to write the stat mirrors back."""

    __slots__ = (
        "t", "mdp", "rng", "untried", "childlist", "best_state",
        "vc", "sc", "sr", "bc", "act",
        "da", "n_stages", "paper", "cp", "greedy", "binary",
        "delta_base", "dparents", "dbest", "dtouched",
    )

    def __init__(self, t: ArrayMCTS):
        self.t = t
        self.mdp = t.mdp
        self.rng = t.rng
        self.untried = t.untried
        self.childlist = t._childlist
        self.best_state = t.best_state
        # per-round delta recording (pinned-worker reverse transport): the
        # cursor's inline expand/backprop mirror ArrayMCTS's hooks, feeding
        # the same record lists ``collect_delta`` packages; recording into
        # them unfiltered is fine — collect_delta filters by ``base``
        self.delta_base = t._delta_base
        self.dparents = t._delta_parents
        self.dbest = t._delta_best
        self.dtouched = t._delta_touched
        size = t.size
        self.vc: List[int] = t.visit_counts[:size].tolist()
        self.sc: List[float] = t.sum_cost[:size].tolist()
        self.sr: List[float] = t.sum_reward[:size].tolist()
        self.bc: List[float] = t.best_cost[:size].tolist()
        self.act: List[int] = t.node_action[:size].tolist()
        self.da = t._depth_actions
        self.n_stages = len(self.da) if self.da is not None else 0
        self.paper = t._paper
        self.cp = t._cp
        self.greedy = t.cfg.simulation == "greedy"
        self.binary = t.cfg.reward_mode == "binary"

    # -- tree policy ------------------------------------------------------
    def _best_child(self, nid: int) -> int:
        """Reference UCB argmax over list mirrors — the same IEEE-754
        operations in the same order as ``MCTS._ucb_score`` (ints convert
        to float64 exactly), first-of-ties."""
        kids = self.childlist[nid]
        if len(kids) == 1:
            return kids[0]
        vc = self.vc
        logn = math.log(max(vc[nid], 1))
        sqrt = math.sqrt
        best_id = -1
        best_score = None
        if self.paper:
            sc, cp = self.sc, self.cp
            for cid in kids:
                n = vc[cid]
                score = (1.0 / (sc[cid] / n)) * (1.0 + cp * sqrt(logn / n))
                if best_score is None or score > best_score:
                    best_id, best_score = cid, score
        else:
            sr = self.sr
            for cid in kids:
                n = vc[cid]
                score = sr[cid] / n + SQRT2 * sqrt(2.0 * logn / n)
                if best_score is None or score > best_score:
                    best_id, best_score = cid, score
        return best_id

    # -- one iteration up to (not including) terminal pricing -------------
    def advance_to_leaf(self):
        """Select + expand + roll out; returns the pending leaf
        ``(path, terminal_state)`` whose cost the caller prices in batch."""
        t = self.t
        untried, childlist, act = self.untried, self.childlist, self.act
        rng, mdp = self.rng, self.mdp
        fast = self.da is not None
        # select
        nid, state = t.root, t.root_state
        path = [nid]
        while not untried[nid] and childlist[nid]:
            nid = self._best_child(nid)
            a = act[nid]
            state = state + (a,) if fast else mdp.step(state, a)
            path.append(nid)
        # expand
        terminal_here = (
            len(state) >= self.n_stages if fast else mdp.is_terminal(state)
        )
        if not terminal_here and untried[nid]:
            pool = untried[nid]
            a = pool.pop(rng.randrange(len(pool)))
            state = state + (a,) if fast else mdp.step(state, a)
            child = t._new_node(a, state)
            slot = len(childlist[nid])
            if slot >= t.children.shape[1]:
                t._grow_width(slot + 1)
            t.children[nid, slot] = child
            t.n_children[nid] = slot + 1
            childlist[nid].append(child)
            if self.delta_base is not None:
                self.dparents.append(nid)
            path.append(child)
            self.vc.append(0)
            self.sc.append(0.0)
            self.sr.append(0.0)
            self.bc.append(INF)
            self.act.append(a)
        # rollout (terminal cost deferred to the batch)
        t0 = time.perf_counter()
        if fast:
            if not self.greedy:
                rr = rng.randrange
                da = self.da
                state = state + tuple(
                    rr(da[i]) for i in range(len(state), self.n_stages)
                )
            else:
                state = self._greedy_rollout(state)
        else:
            state = self._generic_rollout(state)
        t.sim_time += time.perf_counter() - t0
        return path, state

    def _greedy_rollout(self, state: State) -> State:
        """Greedy default policy with each depth's candidate sweep priced in
        one ``partial_cost_batch`` call; tie-break RNG draws replay in
        action order afterwards, so the stream matches the scalar engine."""
        da, mdp = self.da, self.mdp
        pc_batch = getattr(mdp, "partial_cost_batch", None)
        rand = self.rng.random
        while len(state) < self.n_stages:
            n = da[len(state)]
            cands = [state + (a,) for a in range(n)]
            if pc_batch is not None and n > 1:
                costs = pc_batch(cands)
            else:
                pc = mdp.partial_cost
                costs = [pc(c) for c in cands]
            best_a, best_c = 0, INF
            for a in range(n):
                c = costs[a]
                if c < best_c or (c == best_c and rand() < 0.5):
                    best_a, best_c = a, c
            state = cands[best_a]
        return state

    def _generic_rollout(self, state: State) -> State:
        """Non-``ScheduleMDP`` path (test doubles): per-step MDP dispatch,
        batched greedy sweeps when the MDP offers them."""
        mdp, rng = self.mdp, self.rng
        pc_batch = getattr(mdp, "partial_cost_batch", None)
        greedy, rand = self.greedy, self.rng.random
        while not mdp.is_terminal(state):
            n = mdp.n_actions(state)
            if greedy:
                steps = [mdp.step(state, a) for a in range(n)]
                if pc_batch is not None and n > 1:
                    costs = pc_batch(steps)
                else:
                    pc = mdp.partial_cost
                    costs = [pc(s) for s in steps]
                best_a, best_c = 0, INF
                for a in range(n):
                    c = costs[a]
                    if c < best_c or (c == best_c and rand() < 0.5):
                        best_a, best_c = a, c
                state = steps[best_a]
            else:
                state = mdp.step(state, rng.randrange(n))
        return state

    # -- backprop ----------------------------------------------------------
    def backprop(self, path: List[int], terminal: State, cost: float):
        t = self.t
        if t.baseline is None:
            t.baseline = cost
        beat = cost < t.global_best
        if beat:
            t.global_best = cost
            t.global_best_state = terminal
        if self.binary:
            r = 1.0 if beat else 0.0
        else:
            r = (t.baseline / cost) if cost > 0 else 0.0
        vc, sc, sr, bc = self.vc, self.sc, self.sr, self.bc
        best_state = self.best_state
        base = self.delta_base
        if base is not None:
            self.dtouched.extend(n for n in path if n < base)
        for nid in path:
            vc[nid] += 1
            sc[nid] += cost
            sr[nid] += r
            if cost < bc[nid]:
                bc[nid] = cost
                best_state[nid] = terminal
                if base is not None:
                    self.dbest.append(nid)

    def flush(self):
        """Write the stat mirrors back into the canonical flat arrays (one
        vectorized assignment per field; capacity already grown by
        ``_new_node``)."""
        t = self.t
        size = t.size
        assert size == len(self.vc)
        t.visit_counts[:size] = self.vc
        t.sum_cost[:size] = self.sc
        t.sum_reward[:size] = self.sr
        t.best_cost[:size] = self.bc


def run_decision_batch(
    trees: List[ArrayMCTS], mdp=None, controller=None
) -> List[DecisionResult]:
    """One lockstep decision round over ``trees`` — the batched equivalent
    of ``[t.run_decision() for t in trees]``, with identical results.

    Requires an iteration budget (wall-clock budgets are inherently
    per-tree and fall back to scalar ``run_decision``).  All trees must
    share the per-decision budget, as ProTuner ensembles do.

    ``controller`` (core/run_control.py) is the mid-round cancellation
    seam: once ``controller.cancel()`` fires, the remaining iterations of
    THIS round are skipped (after at least one, so every root has a
    child) and the round's decisions are computed from the simulations
    done so far.  Deadlines never truncate — ``abort_round`` only answers
    to an explicit cancel — so an uninterrupted (or merely
    deadline-bounded) round runs all its iterations and stays
    bit-identical to a controller-free one."""
    if not trees:
        return []
    if mdp is None:
        mdp = trees[0].mdp
    cfg = trees[0].cfg
    if cfg.seconds_per_decision is not None:
        return [t.run_decision() for t in trees]
    iters = cfg.iters_per_decision or 1
    cursors = [_TreeCursor(t) for t in trees]
    for it in range(iters):
        if controller is not None and it and controller.abort_round():
            break
        pending = [c.advance_to_leaf() for c in cursors]
        t0 = time.perf_counter()
        costs = _terminal_cost_batch(mdp, [leaf for _, leaf in pending])
        dt = (time.perf_counter() - t0) / len(cursors)
        for c, (path, leaf), cost in zip(cursors, pending, costs):
            c.backprop(path, leaf, cost)
            c.t.eval_time += dt
    out: List[DecisionResult] = []
    for c in cursors:
        extra = 0
        if not c.childlist[c.t.root]:
            # degenerate budget: guarantee a root child, as run_decision does
            path, leaf = c.advance_to_leaf()
            c.backprop(path, leaf, _terminal_cost_batch(mdp, [leaf])[0])
            extra = 1
        c.flush()
        out.append(c.t._root_decision(iters + extra))
    # learned-cost serving (engine/serving.py): a decision-round boundary
    # is the online trainer's deterministic refit point — the next round's
    # miss batches are then priced by the refreshed model
    round_end = getattr(mdp, "on_round_end", None)
    if round_end is not None:
        round_end()
    return out

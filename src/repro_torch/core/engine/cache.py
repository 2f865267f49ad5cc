"""Shared transposition cache over the scheduling MDP.

The MDP is a deterministic prefix tree: a complete schedule IS its action
tuple, so ``terminal_cost`` is a pure function of the state and
``partial_cost`` a pure function of the prefix.  The reference ensemble
re-prices the same complete schedules thousands of times — every one of the
16 trees re-samples overlapping regions of the space, and tree reuse across
decision rounds revisits the same subtree terminals round after round.
``TranspositionCache`` memoizes both signals once, shared across all trees
and all rounds; ``CachedMDP`` is a drop-in ``ScheduleMDP`` wrapper so every
search backend (MCTS, ArrayMCTS, beam, random) gets the cache for free.

With no cost backend mounted (the default), values are bit-identical to
uncached evaluation (a pure memo — no rounding, no eviction), so search
trajectories are unchanged; only the number of cost-model evaluations
drops.

Learned-cost serving (``repro_torch.core.engine.serving``): a
``HybridCostBackend`` passed as ``cost_backend=`` takes over miss pricing —
a deduplicated miss batch is priced by one learned-model forward pass when
the model is trained (and confident), by the exact analytic path otherwise.
Entries the model priced carry its fit-generation id in
``terminal_version`` / ``partial_version``; absence of a tag ALWAYS means
exact analytic pricing, which is what the online trainer harvests (the
model never trains on its own predictions) and what keeps merged
multi-process caches interpretable.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

State = Tuple[int, ...]

# incremental-export cursor: (mutation epoch, len(terminal), len(partial),
# len(terminal_version), len(partial_version)) — see
# TranspositionCache.watermark/export_since
Watermark = Tuple[int, int, int, int, int]


class TranspositionCache:
    """Memo of {complete action tuple -> terminal cost} and
    {prefix action tuple -> default-completed partial cost}, plus
    per-entry model-version tags for learned-priced entries."""

    __slots__ = (
        "terminal", "partial", "terminal_version", "partial_version",
        "hits", "misses", "dedup", "epoch",
    )

    def __init__(self):
        self.terminal: Dict[State, float] = {}
        self.partial: Dict[State, float] = {}
        # model-version tags, ONLY for learned-priced entries: absence of a
        # key means the entry is exact analytic (version 0)
        self.terminal_version: Dict[State, int] = {}
        self.partial_version: Dict[State, int] = {}
        self.hits = 0
        self.misses = 0
        # subset of ``hits`` served by in-batch deduplication: a state that
        # appeared earlier in the SAME miss batch (priced once, served K
        # times) — the batched engines' structural win over scalar walks
        self.dedup = 0
        # mutation epoch: bumped whenever the tables stop being append-only
        # (an eviction, or an in-place value/tag change during a merge) —
        # any outstanding export watermark from an older epoch is then
        # invalid and ``export_since`` falls back to a full export.  Pure
        # appends and re-inserts of identical values never bump it, so the
        # analytic path stays incremental forever.
        self.epoch = 0

    # -- stats ---------------------------------------------------------
    @property
    def n_entries(self) -> int:
        return len(self.terminal) + len(self.partial)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "dedup": self.dedup,
            "hit_rate": self.hit_rate,
            "terminal_entries": len(self.terminal),
            "partial_entries": len(self.partial),
            "learned_terminal_entries": len(self.terminal_version),
            "learned_partial_entries": len(self.partial_version),
        }

    # -- multiprocess merge --------------------------------------------
    def __getstate__(self):
        # Workers receive the mappings but fresh counters, so the counts a
        # worker reports back are exactly the activity of its round and
        # ``merge`` can sum them without double counting.
        return {
            "terminal": self.terminal,
            "partial": self.partial,
            "terminal_version": self.terminal_version,
            "partial_version": self.partial_version,
        }

    def __setstate__(self, state):
        self.terminal = state["terminal"]
        self.partial = state["partial"]
        self.terminal_version = state.get("terminal_version", {})
        self.partial_version = state.get("partial_version", {})
        self.hits = 0
        self.misses = 0
        self.dedup = 0
        self.epoch = 0

    def _merge_tbl(self, tbl, vtbl, new, vnew) -> None:
        """Fold ``new`` entries (with tags ``vnew``) into ``tbl``/``vtbl``
        under the EXACT-WINS rule: an existing untagged (exact analytic)
        entry is never overwritten by a learned prediction, and an
        incoming exact entry replaces a learned one and clears its tag.
        Sibling workers can race on the same state — one serving the
        model, one auditing analytically — and exact must win regardless
        of merge order.  (Two *predictions* of the same state from
        different model generations resolve last-writer-wins; callers
        merge in tree-index order, so that too is deterministic.)

        Epoch accounting: overwriting an EXISTING key with a different
        value or tag mutates the table in place (the key keeps its dict
        position), which invalidates any outstanding length-based export
        watermark — that bumps ``epoch``.  Appending new keys, or
        re-inserting a key with its identical exact value (the pure-
        analytic fast path — the memo is a pure function of the state, so
        every worker computes the same float), keeps watermarks valid."""
        if not vtbl and not vnew:
            tbl.update(new)  # pure-analytic fast path: everything is exact
            return
        changed = False
        for s, c in new.items():
            if s in tbl and s not in vtbl:
                continue  # existing exact entry wins
            v = vnew.get(s)
            if s in tbl and (tbl[s] != c or vtbl.get(s) != v):
                changed = True  # in-place rewrite: watermarks go stale
            tbl[s] = c
            if v is None:
                vtbl.pop(s, None)  # incoming exact clears any stale tag
            else:
                vtbl[s] = v
        if changed:
            self.epoch += 1

    def merge(self, other: "TranspositionCache") -> None:
        """Fold a worker-side cache back into this one.  With no learned
        entries anywhere, keys map to identical (exact) values in every
        worker, so this is a plain order-independent update; learned
        entries merge under the exact-wins rule (``_merge_tbl``)."""
        self._merge_tbl(self.terminal, self.terminal_version,
                        other.terminal, other.terminal_version)
        self._merge_tbl(self.partial, self.partial_version,
                        other.partial, other.partial_version)
        self.hits += other.hits
        self.misses += other.misses
        self.dedup += other.dedup

    # -- incremental export (pinned-worker forward deltas) -------------
    # The pinned process-pool protocol ships each worker ONLY the cache
    # entries it has not seen yet: the master takes a per-worker
    # ``watermark()`` at every submit and sends ``export_since(wm)`` the
    # next round.  Dicts are insertion-ordered and (absent evictions and
    # in-place rewrites) append-only, so "everything since" is a pair of
    # islices — O(new entries), never a whole-table diff.  The mutation
    # ``epoch`` guards the exceptional cases: a refit eviction or an
    # exact-wins rewrite invalidates length-based cursors, and the next
    # export for every worker degrades to a full-table resync exactly
    # once (the analytic path never bumps the epoch, so it exports
    # incrementally forever).

    def watermark(self) -> Watermark:
        """Cursor for ``export_since``: the current mutation epoch plus
        the four table lengths."""
        return (self.epoch, len(self.terminal), len(self.partial),
                len(self.terminal_version), len(self.partial_version))

    def export_since(self, wm: Optional[Watermark]):
        """Entries added since ``wm`` as ``((terminal, partial,
        terminal_version, partial_version), full)``.  ``full=True`` means
        the watermark was missing or from an older mutation epoch and the
        export is a complete snapshot (receivers should evict any locally
        tagged entries the snapshot no longer certifies — see
        ``HybridCostBackend.apply_params``)."""
        if wm is None or wm[0] != self.epoch:
            return (
                (dict(self.terminal), dict(self.partial),
                 dict(self.terminal_version), dict(self.partial_version)),
                True,
            )
        return (
            (dict(itertools.islice(self.terminal.items(), wm[1], None)),
             dict(itertools.islice(self.partial.items(), wm[2], None)),
             dict(itertools.islice(self.terminal_version.items(), wm[3], None)),
             dict(itertools.islice(self.partial_version.items(), wm[4], None))),
            False,
        )

    def apply_export(self, entries, full: bool = False) -> None:
        """Fold an ``export_since`` payload into this cache (worker side
        of the forward delta).  Merging — not replacing — under the same
        exact-wins rule as ``merge``, so applying a full resync on top of
        local state is always safe."""
        t, p, tv, pv = entries
        self._merge_tbl(self.terminal, self.terminal_version, t, tv)
        self._merge_tbl(self.partial, self.partial_version, p, pv)

    def evict_learned(self) -> int:
        """Drop every learned-tagged entry (master refit superseded them;
        they reprice on next lookup).  Bumps the mutation epoch: exports
        can no longer be expressed as table-length islices."""
        n = len(self.terminal_version) + len(self.partial_version)
        if n:
            for s in self.terminal_version:
                del self.terminal[s]
            self.terminal_version.clear()
            for s in self.partial_version:
                del self.partial[s]
            self.partial_version.clear()
            self.epoch += 1
        return n


class CachedMDP:
    """``ScheduleMDP`` wrapper memoizing ``terminal_cost``/``partial_cost``.

    Everything else delegates to the wrapped MDP, so this nests around any
    object implementing the MDP protocol (including test doubles).

    ``cost_backend`` (optional, a ``HybridCostBackend``) reroutes MISS
    pricing through the learned-cost serving layer; hit/miss bookkeeping,
    deduplication, and the batch contract below are unchanged."""

    def __init__(self, mdp, cache: TranspositionCache = None,
                 cost_backend=None):
        self.mdp = mdp
        self.cache = cache if cache is not None else TranspositionCache()
        self.cost_backend = cost_backend
        if cost_backend is not None:
            cost_backend.bind(self.cache)

    # -- pure structure: straight delegation ---------------------------
    @property
    def initial_state(self) -> State:
        return self.mdp.initial_state

    @property
    def space(self):
        return self.mdp.space

    @property
    def cost_model(self):
        return self.mdp.cost_model

    def n_actions(self, state: State) -> int:
        return self.mdp.n_actions(state)

    def step(self, state: State, action: int) -> State:
        return self.mdp.step(state, action)

    def is_terminal(self, state: State) -> bool:
        return self.mdp.is_terminal(state)

    def plan(self, state: State):
        return self.mdp.plan(state)

    # -- memoized cost signals -----------------------------------------
    def terminal_cost(self, state: State) -> float:
        tbl = self.cache.terminal
        c = tbl.get(state)
        if c is not None:
            self.cache.hits += 1
            return c
        self.cache.misses += 1
        if self.cost_backend is not None:
            costs, ver = self.cost_backend.price_terminal(self.mdp, [state])
            c = costs[0]
            if ver:
                self.cache.terminal_version[state] = ver
        else:
            c = self.mdp.terminal_cost(state)
        tbl[state] = c
        return c

    def partial_cost(self, state: State) -> float:
        if self.mdp.is_terminal(state):
            return self.terminal_cost(state)
        tbl = self.cache.partial
        c = tbl.get(state)
        if c is not None:
            self.cache.hits += 1
            return c
        self.cache.misses += 1
        if self.cost_backend is not None:
            costs, ver = self.cost_backend.price_partial(self.mdp, [state])
            c = costs[0]
            if ver:
                self.cache.partial_version[state] = ver
        else:
            c = self.mdp.partial_cost(state)
        tbl[state] = c
        return c

    # -- batched cost signals ------------------------------------------
    # Contract (shared by both methods): values equal the scalar methods
    # element-for-element; hits + misses advance by exactly len(states);
    # only MISSES reach the pricing layer, deduplicated, in first-occurrence
    # order — a state appearing twice in one batch is one miss plus one
    # hit, exactly as if the batch had been priced sequentially.  A warm
    # cache therefore never changes returned values, only the hit count.
    # The deduplicated miss batch is priced COLUMNAR-SIDE: it reaches the
    # wrapped MDP's batch methods (one PlanColumns encode + one vectorized
    # roofline-kernel pass per miss batch) or, with a cost backend
    # mounted, the backend (which builds the same one-per-batch encoding
    # and feeds it to the learned MLP or the analytic kernel); newly
    # priced entries then carry the serving model's version tag.

    def _batch(self, states, tbl, vtbl, price) -> List[float]:
        out: List[Optional[float]] = [None] * len(states)
        pending: Dict[State, None] = {}  # dedup, insertion-ordered
        hits = 0
        for i, s in enumerate(states):
            c = tbl.get(s)
            if c is not None:
                out[i] = c
                hits += 1
            elif s in pending:
                hits += 1  # duplicate miss: sequential order would hit
                self.cache.dedup += 1
            else:
                pending[s] = None
        self.cache.hits += hits
        self.cache.misses += len(pending)
        if pending:
            miss_states = list(pending)
            costs, ver = price(miss_states)
            for s, c in zip(miss_states, costs):
                tbl[s] = c
                if ver:
                    vtbl[s] = ver
            for i, s in enumerate(states):
                if out[i] is None:
                    out[i] = tbl[s]
        return out

    def _terminal_price(self):
        if self.cost_backend is not None:
            return lambda miss: self.cost_backend.price_terminal(self.mdp, miss)
        inner = getattr(self.mdp, "terminal_cost_batch", None)
        if inner is None:
            return lambda miss: ([self.mdp.terminal_cost(s) for s in miss], 0)
        return lambda miss: (inner(miss), 0)

    def _partial_price(self):
        if self.cost_backend is not None:
            return lambda miss: self.cost_backend.price_partial(self.mdp, miss)
        inner = getattr(self.mdp, "partial_cost_batch", None)
        if inner is None:
            return lambda miss: ([self.mdp.partial_cost(s) for s in miss], 0)
        return lambda miss: (inner(miss), 0)

    def terminal_cost_batch(self, states: Sequence[State]) -> List[float]:
        return self._batch(
            states, self.cache.terminal, self.cache.terminal_version,
            self._terminal_price(),
        )

    def partial_cost_batch(self, states: Sequence[State]) -> List[float]:
        """Mixed batches allowed: terminal states route to the terminal
        table (as the scalar ``partial_cost`` does)."""
        is_terminal = self.mdp.is_terminal
        term_idx = [i for i, s in enumerate(states) if is_terminal(s)]
        if not term_idx:
            return self._batch(
                states, self.cache.partial, self.cache.partial_version,
                self._partial_price(),
            )
        term_set = set(term_idx)
        part_idx = [i for i in range(len(states)) if i not in term_set]
        out: List[Optional[float]] = [None] * len(states)
        for i, c in zip(term_idx,
                        self.terminal_cost_batch([states[i] for i in term_idx])):
            out[i] = c
        for i, c in zip(part_idx,
                        self.partial_cost_batch([states[i] for i in part_idx])):
            out[i] = c
        return out

    # -- serving hooks --------------------------------------------------
    def on_round_end(self) -> None:
        """Round-boundary hook (lockstep batched rounds, parallel merges):
        gives the online trainer a deterministic refit point even when no
        miss batch crosses the refit threshold mid-round."""
        if self.cost_backend is not None:
            self.cost_backend.maybe_refit()

    def __getattr__(self, name):
        # fall through for any extension attribute on the wrapped MDP;
        # dunders (and ``mdp`` itself, pre-__init__ during unpickling) must
        # raise, not recurse
        if name.startswith("_") or name == "mdp":
            raise AttributeError(name)
        return getattr(self.mdp, name)

"""Learned-cost serving behind the transposition-cache seam: the port of
the JAX package's ``core/engine/serving.py``.

The paper's §3 observation — a model trained on complete schedules ranks
complete schedules well — plus the engine layer's two facts make this
subsystem almost free:

* every ``TranspositionCache`` terminal entry is a ``(actions, cost)``
  training example that the search already paid for, and
* the batch seam (``CachedMDP.terminal_cost_batch`` →
  ``cost_batch``) already funnels every cache-miss batch through ONE
  pricing call — the natural mount point for a model that prices a whole
  batch in one forward pass.

Three pieces:

``OnlineCostTrainer``
    Harvests the cache's analytic-priced terminal entries (entries a
    learned model priced are tagged in ``cache.terminal_version`` and
    excluded, so the model never trains on its own predictions), refits
    the ``LearnedCostModel`` MLP on snapshots — warm-started from the
    previous fit, normalization recomputed per fit — and scores each fit
    on a held-out slice (Spearman) to decide whether the model is
    *confident* enough to serve.

``HybridCostBackend``
    Mounted inside ``CachedMDP`` (``cost_backend=``).  Prices each
    deduplicated miss batch: ``mode="learned"`` serves the model whenever
    one exists, ``mode="hybrid"`` additionally requires the holdout
    confidence gate; both fall back to the analytic path (which preserves
    the one-``cost_batch``-call-per-miss-batch batching) while
    untrained.  Entries the model priced are tagged with the model's
    version id so merged caches stay interpretable — version 0 / no tag
    always means exact analytic.

``make_cost_backend``
    Maps the user-facing ``cost="analytic"|"learned"|"hybrid"`` selector
    (``autotune`` / ``ProTuner`` / ``resolve_backend``) to a backend —
    ``None`` for ``"analytic"``, so the exact-analytic path is literally
    the unchanged exact code and stays bit-identical to the JAX package's
    search.

Process-pool protocol: pickled backends disable refitting
(``__getstate__`` clears ``refit_enabled``), so workers only SERVE the
model version they were shipped and tag new entries with it; the master
refits on the merged cache at round boundaries and ships the new model
with the next round's submissions.  Merged caches therefore never contain
a version id that some trainer didn't mint.

Device: the MLP fits and prices on the backend's ``device`` (default
``"cuda"``; a machine without a card raises unless ``device="cpu"`` is
given).  A worker process prices on the device its shipped backend names:
it imports torch when the first learned model arrives (the model's params
travel as numpy) and opens its own CUDA context there.  ``stats()`` and
``worker_report()`` name the device each party priced on.  This module
imports ``learned_cost`` (and so torch) only inside the calls that fit or
price, so ``repro_torch.core.ensemble``'s import chain, which the pinned
pool's forkserver preloads, stays free of torch.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import PlanColumns

COST_MODES = ("analytic", "learned", "hybrid")


@dataclass
class FitReport:
    """One refit: dataset size, holdout quality, and the serving verdict.

    ``n_train + n_holdout <= n_examples``: holdout-marked states that are
    too few to score (< 8) sit out entirely rather than leak into
    training."""

    version: int
    n_examples: int
    n_train: int
    n_holdout: int
    holdout_spearman: float
    confident: bool


class OnlineCostTrainer:
    """Periodic refits of the learned cost model on transposition-cache
    snapshots.

    ``should_fit`` triggers on the count of ANALYTIC terminal entries: the
    first fit at ``min_examples``, refits every ``refit_every`` new
    analytic entries after that.  Each fit recomputes the log-cost
    normalization from the snapshot (the cache's cost distribution drifts
    as the search descends) and warm-starts from the previous parameters.
    """

    def __init__(
        self,
        space,
        *,
        min_examples: int = 64,
        refit_every: int = 256,
        steps: int = 200,
        lr: float = 3e-3,
        seed: int = 0,
        holdout_frac: float = 0.25,
        confidence_threshold: float = 0.8,
        device="cuda",
    ):
        from repro_torch.device import resolve_device

        self.space = space
        # where fits run and the fitted models price; checked at once, so
        # that a trainer asked for the card raises on a machine without one
        self.device = str(resolve_device(device))
        self.min_examples = min_examples
        self.refit_every = refit_every
        self.steps = steps
        self.lr = lr
        self.seed = seed
        self.holdout_frac = holdout_frac
        self.confidence_threshold = confidence_threshold
        self.model = None  # LearnedCostModel after the first fit
        self.confident = False
        self.version = 0  # fit generation; 0 = untrained
        self._fitted_at = 0  # analytic-entry count at the last fit
        # adaptive refit interval: doubles after an unconfident fit (more
        # data of the same on-policy distribution rarely flips the verdict
        # immediately, and fits are the expensive part), resets once a fit
        # clears the gate
        self._interval = refit_every
        self.reports: List[FitReport] = []

    # -- harvest --------------------------------------------------------
    @staticmethod
    def n_analytic(cache) -> int:
        """Analytic-priced terminal entries (tags mark learned ones)."""
        return len(cache.terminal) - len(cache.terminal_version)

    def harvest(self, cache) -> Tuple[list, List[float]]:
        """Snapshot the cache's analytic terminal entries as training
        pairs: a terminal state IS its action tuple, so each entry is a
        free ``(actions, cost)`` example."""
        tagged = cache.terminal_version
        states = [s for s in cache.terminal if s not in tagged]
        return states, [cache.terminal[s] for s in states]

    def should_fit(self, cache) -> bool:
        n = self.n_analytic(cache)
        if self.model is None:
            return n >= self.min_examples
        return n - self._fitted_at >= self._interval

    # -- fit ------------------------------------------------------------
    def is_holdout(self, state) -> bool:
        """Persistent train/holdout split by content hash: a state's
        assignment never changes — across fits, processes, and runs — so
        warm-started parameters have NEVER trained on any holdout example
        and the confidence score cannot be inflated by memorization (a
        per-fit reshuffle would hand fit N+1 a holdout that fit N trained
        on).  Salted so the split is independent of the audit-batch hash."""
        denom = max(int(round(1.0 / self.holdout_frac)), 2)
        return zlib.crc32(repr(tuple(state)).encode() + b"/holdout") % denom == 0

    def fit(self, cache) -> Optional[FitReport]:
        from repro_torch.core.learned_cost import _spearman, fit_learned_cost

        states, costs = self.harvest(cache)
        n = len(states)
        if n < max(self.min_examples, 8):
            return None
        plans = [self.space.plan_from_actions(list(s)) for s in states]
        # holdout-marked states NEVER train — even when there are too few
        # of them to score (then they sit out entirely and the fit stays
        # uncertified) — otherwise a small first fit would leak them into
        # the warm-started params and inflate every later confidence score
        hold, train = [], []
        for i, s in enumerate(states):
            (hold if self.is_holdout(s) else train).append(i)
        if len(hold) < 8:
            hold = []  # too little data to certify: hybrid keeps falling back
        if len(train) < 8:
            return None
        model = fit_learned_cost(
            self.space,
            [plans[i] for i in train],
            [costs[i] for i in train],
            params=self.model.params if self.model is not None else None,
            steps=self.steps,
            lr=self.lr,
            seed=self.seed,
            device=self.device,
        )
        self.version += 1
        model.version = self.version
        if hold:
            preds = model.cost_batch([plans[i] for i in hold])
            rho = _spearman(
                np.asarray(preds), np.asarray([costs[i] for i in hold])
            )
        else:
            rho = 0.0
        self.confident = bool(hold) and rho >= self.confidence_threshold
        self.model = model
        self._fitted_at = self.n_analytic(cache)
        self._interval = (
            self.refit_every if self.confident
            else min(self._interval * 2, 16 * self.refit_every)
        )
        report = FitReport(
            self.version, n, len(train), len(hold), rho, self.confident
        )
        self.reports.append(report)
        return report


class HybridCostBackend:
    """Prices ``CachedMDP`` miss batches: learned model when trained (and,
    in hybrid mode, confident), exact analytic otherwise.

    Returned by every ``price_*`` call: ``(costs, version)`` where
    ``version`` is 0 for analytic pricing or the serving model's fit
    generation — ``CachedMDP`` tags the new cache entries with it."""

    def __init__(
        self,
        space,
        mode: str = "hybrid",
        trainer: Optional[OnlineCostTrainer] = None,
        audit_every: int = 8,
        device="cuda",
        **trainer_kwargs,
    ):
        if mode not in ("learned", "hybrid"):
            raise ValueError(
                f"cost backend mode {mode!r}; analytic mode mounts no "
                f"backend (make_cost_backend returns None)"
            )
        self.mode = mode
        self.trainer = trainer if trainer is not None else OnlineCostTrainer(
            space, device=device, **trainer_kwargs
        )
        # Audit stream: while the model serves, ~1/``audit_every`` of
        # terminal miss batches are still priced analytically (and left
        # untagged).  Without it, serving STARVES training — every new
        # entry would be model-tagged, the analytic-entry count would
        # freeze, and no refit (hence no confidence re-check) could ever
        # fire again; the gate could open once and never close.  The audit
        # batches keep fresh on-policy labels flowing from whatever region
        # the search currently explores, so later refits can detect drift.
        # Selection is a STATELESS content hash of the batch's first state
        # (``audit_batch``), so the stream survives worker pickling and
        # needs no counter synchronization across processes.  0/None
        # disables (serve-everything; refits stop once serving starts —
        # only sensible for fixed offline models).
        self.audit_every = audit_every
        self.cache = None  # bound by CachedMDP at mount time
        self.refit_enabled = True  # cleared in pickled (worker) copies
        self.n_learned_batches = 0
        self.n_learned_plans = 0
        self.n_analytic_plans = 0

    # -- lifecycle ------------------------------------------------------
    def bind(self, cache) -> None:
        self.cache = cache

    def __getstate__(self):
        # Workers serve the shipped model but never refit: version ids
        # stay minted by exactly one trainer (the master's), so tags in
        # merged caches are globally interpretable.  Pricing counters ship
        # zeroed (like TranspositionCache's hit/miss counters): a worker's
        # counts are then exactly its round's activity, and the master
        # merges them by summing (``merge_counters``) without double
        # counting.
        d = self.__dict__.copy()
        d["refit_enabled"] = False
        d["n_learned_batches"] = 0
        d["n_learned_plans"] = 0
        d["n_analytic_plans"] = 0
        return d

    def counters(self) -> Tuple[int, int, int]:
        return (
            self.n_learned_batches, self.n_learned_plans, self.n_analytic_plans
        )

    def merge_counters(self, counters: Tuple[int, int, int]) -> None:
        """Fold a worker's round pricing counters back into this backend
        (they pickle zeroed, so each worker reports exactly its round)."""
        self.n_learned_batches += counters[0]
        self.n_learned_plans += counters[1]
        self.n_analytic_plans += counters[2]

    @property
    def model(self):
        return self.trainer.model

    @property
    def device(self) -> str:
        """Where this backend's models fit and price."""
        return self.trainer.device

    def worker_report(self) -> dict:
        """What this (worker) process priced on: its pid, the backend's
        device, the device of its last learned forward pass (None before
        the first), and the CUDA context it opened for it
        (``repro_torch.device.open_context``: seconds and card bytes)."""
        m = self.trainer.model
        priced_on = m.priced_on if m is not None else None
        report = {"pid": os.getpid(), "device": self.device, "priced_on": priced_on}
        if priced_on is not None:  # learned_cost, hence torch, is loaded
            from repro_torch.device import CONTEXT

            report["cuda_context"] = dict(CONTEXT)
        return report

    def maybe_refit(self) -> None:
        """Refit check — called at every pricing boundary and at lockstep
        round ends; a cheap integer compare when nothing is due.

        A successful refit EVICTS every learned-priced cache entry: cached
        predictions would otherwise be served as hits forever, so early
        model generations would keep steering the search long after being
        superseded (or after the confidence gate closed).  Evicted states
        are simply repriced — by the new model or analytically — on their
        next lookup; analytic entries are exact and never evicted."""
        if (
            self.refit_enabled
            and self.cache is not None
            and self.trainer.should_fit(self.cache)
        ):
            if self.trainer.fit(self.cache) is not None:
                self._evict_learned(self.cache)

    @staticmethod
    def _evict_learned(cache) -> None:
        cache.evict_learned()

    # -- fit-generation-keyed param shipping (pinned workers) ----------
    # Pinned process-pool workers hold this backend for the whole run, so
    # the master ships model parameters ONLY when the fit generation
    # changes — nothing rides on the wire between refits (the pre-pinning
    # pool re-pickled the entire backend, trainer and all, every round).

    def params_delta(self, known_version: int):
        """What a worker holding fit generation ``known_version`` needs:
        ``None`` while the generation is unchanged, else ``(version,
        confident, model)`` — the serving verdict and the warm model
        (params + normalization) of the current generation."""
        t = self.trainer
        if t.version == known_version:
            return None
        return (t.version, t.confident, t.model)

    def apply_params(self, delta) -> None:
        """Worker side: install a shipped fit generation.  Mirrors the
        master's refit eviction first — the local cache may hold
        predictions tagged by the superseded generation, and the master
        already evicted its copies, so they must not keep serving as
        hits.  Until this call arrives, the worker keeps serving the old
        model (bit-identity with the sequential learned path is not a
        contract; the ANALYTIC parallel path never mounts a backend)."""
        version, confident, model = delta
        if self.cache is not None:
            self.cache.evict_learned()
        t = self.trainer
        t.version = version
        t.confident = confident
        t.model = model

    def _serving_model(self):
        m = self.trainer.model
        if m is None:
            return None
        if self.mode == "hybrid" and not self.trainer.confident:
            return None
        return m

    def audit_batch(self, states: Sequence) -> bool:
        """True if a serving-era terminal miss batch should be priced
        analytically anyway (the audit stream).  A pure content hash of
        the first miss state: deterministic across processes and runs,
        ~1/``audit_every`` of batches."""
        if not self.audit_every:
            return False
        h = zlib.crc32(repr(states[0]).encode())
        return h % self.audit_every == 0

    # -- pricing --------------------------------------------------------
    # When the LEARNED model serves, the miss batch's plans are
    # materialized once and encoded once as a PlanColumns
    # structure-of-arrays — the same encoding the analytic columnar
    # kernel prices, featurized directly by the MLP
    # (learned_cost.featurize_columns), so the batch never re-walks the
    # plan objects.  When the model does NOT serve (untrained, gate
    # closed, audit batch), pricing goes straight to the MDP's analytic
    # batch methods — they dedup default-completions and apply the cost
    # model's own small-batch dispatch, so no encode is paid that the
    # kernel would not use.  MDPs without the relevant seams (test
    # doubles) take the scalar fallbacks unchanged.

    def _serve_columns(self, m, cols) -> List[float]:
        if hasattr(m, "cost_columns"):
            return m.cost_columns(cols)
        return m.cost_batch(cols.plans)

    def price_terminal(self, mdp, states: Sequence) -> Tuple[List[float], int]:
        """Price a deduplicated terminal miss batch; ONE model forward
        pass (over one ``PlanColumns`` encode) when serving learned, one
        analytic ``terminal_cost_batch`` → columnar kernel otherwise.
        ~1/``audit_every`` of serving-era batches go analytic (see
        ``__init__``: the audit stream that keeps training alive)."""
        self.maybe_refit()
        m = self._serving_model()
        if m is not None and self.audit_batch(states):
            m = None  # audit batch: exact labels, untagged, harvestable
        plan = getattr(mdp, "plan", None)
        if m is not None and plan is not None:
            cols = PlanColumns.from_plans([plan(s) for s in states])
            costs = self._serve_columns(m, cols)
            self.n_learned_batches += 1
            self.n_learned_plans += len(states)
            return costs, m.version
        self.n_analytic_plans += len(states)
        price = getattr(mdp, "terminal_cost_batch", None)
        if price is not None:
            return price(states), 0
        return [mdp.terminal_cost(s) for s in states], 0

    def price_partial(self, mdp, states: Sequence) -> Tuple[List[float], int]:
        """Partial prefixes price through their default completion — the
        SAME features the analytic partial signal scores
        (``ScheduleMDP.completed_plans``; one shared implementation so the
        two paths cannot drift), and the features the model was trained on
        for complete schedules (the paper's Fig. 1/2 caveat applies: this
        signal is weaker).  MDPs without ``completed_plans`` (test
        doubles) price analytically."""
        self.maybe_refit()
        m = self._serving_model()
        completed = getattr(mdp, "completed_plans", None)
        if m is not None and completed is not None:
            cols = PlanColumns.from_plans(completed(states))
            costs = self._serve_columns(m, cols)
            self.n_learned_batches += 1
            self.n_learned_plans += len(states)
            return costs, m.version
        self.n_analytic_plans += len(states)
        price = getattr(mdp, "partial_cost_batch", None)
        if price is not None:
            return price(states), 0
        return [mdp.partial_cost(s) for s in states], 0

    # -- observability --------------------------------------------------
    def stats(self) -> dict:
        t = self.trainer
        return {
            "cost_mode": self.mode,
            "device": self.device,
            "priced_on": t.model.priced_on if t.model is not None else None,
            "model_version": t.version,
            "n_fits": len(t.reports),
            "confident": t.confident,
            "holdout_spearman": (
                t.reports[-1].holdout_spearman if t.reports else None
            ),
            "fits": [dataclasses.asdict(r) for r in t.reports],
            "learned_batches": self.n_learned_batches,
            "learned_plans": self.n_learned_plans,
            "analytic_plans": self.n_analytic_plans,
        }


def make_cost_backend(cost, space, device="cuda", **trainer_kwargs):
    """Resolve the ``cost=`` selector to a backend (or ``None``).

    ``"analytic"`` → ``None``: no backend is mounted, so the pricing path
    is the unchanged exact code — bit-identical to the JAX package's
    search.  A ready-made ``HybridCostBackend`` passes through (tests
    configure trainers directly), keeping its own device; ``"learned"`` /
    ``"hybrid"`` build one that fits and prices on ``device``."""
    if cost is None or cost == "analytic":
        return None
    if isinstance(cost, HybridCostBackend):
        return cost
    if cost in ("learned", "hybrid"):
        return HybridCostBackend(space, mode=cost, device=device, **trainer_kwargs)
    raise ValueError(f"unknown cost mode {cost!r}; expected one of {COST_MODES}")

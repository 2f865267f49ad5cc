"""The port's learned-cost serving behind the cache seam
(``repro_torch.core.engine.serving``): the counterpart of each behaviour of
the JAX package's ``tests/test_serving.py`` (trainer harvest and refit,
hybrid routing with analytic fallback, one forward pass a lockstep miss
batch, exact-analytic bit-identity, the serve-only pickle, the params
delta and the worker version-tag protocol), with the MLP on the CPU
(``device="cpu"``).  Where the JAX run can be reproduced, the MLP starts
from the JAX package's initial weights carried across, and the plan, the
exact cost, the serving counters, the fits and their holdout Spearman
equal the JAX run's."""
import pickle
import random

import jax
import numpy as np
import pytest
import torch

from conftest import DECODE_CELL, MOE_TRAIN_CELL, make_cell_mdp
from repro.core import learned_cost as jlc
from repro.core.engine import HybridCostBackend as JaxBackend, OnlineCostTrainer as JaxTrainer
from repro.core.ensemble import ProTuner as JaxProTuner
from repro.core.mcts import MCTSConfig as JaxMCTSConfig
from repro_torch.configs import get_config, get_shape
from repro_torch.core import learned_cost
from repro_torch.core.autotuner import autotune
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.engine import (
    ArrayMCTS,
    CachedMDP,
    HybridCostBackend,
    OnlineCostTrainer,
    TranspositionCache,
    make_cost_backend,
)
from repro_torch.core.engine.batch import run_decision_batch
from repro_torch.core.ensemble import ProTuner
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.mcts import MCTSConfig
from repro_torch.core.mdp import ScheduleMDP
from repro_torch.core.space import SINGLE_POD, ScheduleSpace

torch.set_num_threads(1)


def _mdp(arch=DECODE_CELL[0], shape=DECODE_CELL[1]) -> ScheduleMDP:
    """The cell's reduced MDP under the TPU spec, as the JAX suite builds it."""
    cfg, sh = get_config(arch).reduced(), get_shape(shape)
    return ScheduleMDP(ScheduleSpace(cfg, sh, SINGLE_POD, TPU_V5E),
                       AnalyticCostModel(cfg, sh, SINGLE_POD, TPU_V5E))


def _backend(space, mode="hybrid", audit_every=8, **kw):
    kw.setdefault("min_examples", 32)
    kw.setdefault("refit_every", 64)
    kw.setdefault("steps", 30)
    return HybridCostBackend(
        space, mode=mode, audit_every=audit_every,
        trainer=OnlineCostTrainer(space, device="cpu", **kw),
    )


def _warm(cmdp, n=48, seed=0):
    """Fill the cache with analytic-priced random terminals."""
    rng = random.Random(seed)
    states = [tuple(cmdp.space.random_actions(rng)) for _ in range(n)]
    cmdp.terminal_cost_batch(states)
    return states


# ---------------------------------------------------------------------------
# trainer: harvest + refit
# ---------------------------------------------------------------------------
def test_trainer_harvests_analytic_entries_and_fits():
    mdp = _mdp()
    be = _backend(mdp.space)
    cmdp = CachedMDP(mdp, cost_backend=be)
    _warm(cmdp, n=31)  # one short of min_examples
    assert be.trainer.model is None and not be.trainer.should_fit(cmdp.cache)
    _warm(cmdp, n=8, seed=1)
    assert be.trainer.should_fit(cmdp.cache)
    cmdp.on_round_end()  # the deterministic refit boundary
    assert be.trainer.model is not None, "refit point crossed but no fit"
    assert be.trainer.version == 1 and be.model.version == 1
    rep = be.trainer.reports[-1]
    assert rep.n_examples >= 32 and rep.n_holdout > 0
    # harvest excludes nothing yet: no learned entries exist
    states, costs = be.trainer.harvest(cmdp.cache)
    assert len(states) == len(cmdp.cache.terminal)
    assert all(cmdp.cache.terminal[s] == c for s, c in zip(states, costs))


def test_trainer_never_trains_on_learned_entries():
    mdp = _mdp()
    # always serve; audits off so every batch is model-priced
    be = _backend(mdp.space, confidence_threshold=-1.0, audit_every=0)
    cmdp = CachedMDP(mdp, cost_backend=be)
    _warm(cmdp, n=40)
    cmdp.on_round_end()
    assert be.trainer.confident
    # these misses are model-priced and tagged...
    learned_states = _warm(cmdp, n=20, seed=2)
    new_tags = [s for s in learned_states if s in cmdp.cache.terminal_version]
    assert new_tags, "confident model did not serve"
    assert all(
        cmdp.cache.terminal_version[s] == be.model.version for s in new_tags
    )
    # ...and the next harvest must skip every one of them
    states, _ = be.trainer.harvest(cmdp.cache)
    assert not set(states) & set(cmdp.cache.terminal_version)


def test_unconfident_fit_backs_off_refits():
    mdp = _mdp()
    be = _backend(mdp.space, confidence_threshold=2.0)  # can never pass
    cmdp = CachedMDP(mdp, cost_backend=be)
    _warm(cmdp, n=40)
    cmdp.on_round_end()
    assert be.trainer.model is not None and not be.trainer.confident
    assert be.trainer._interval == 128  # doubled from refit_every=64
    # unconfident model must NOT serve in hybrid mode: everything analytic
    assert not cmdp.cache.terminal_version
    assert be.n_learned_batches == 0


# ---------------------------------------------------------------------------
# hybrid routing
# ---------------------------------------------------------------------------
def test_untrained_backend_prices_exactly_like_analytic():
    mdp = _mdp()
    plain = CachedMDP(_mdp())
    be = _backend(mdp.space, min_examples=10**9)  # never fits
    hybrid = CachedMDP(mdp, cost_backend=be)
    rng = random.Random(3)
    states = [tuple(mdp.space.random_actions(rng)) for _ in range(16)]
    assert hybrid.terminal_cost_batch(states) == plain.terminal_cost_batch(states)
    prefixes = [s[:4] for s in states]
    assert hybrid.partial_cost_batch(prefixes) == plain.partial_cost_batch(prefixes)
    assert (hybrid.cache.hits, hybrid.cache.misses) == (
        plain.cache.hits, plain.cache.misses)
    assert not hybrid.cache.terminal_version
    assert be.n_analytic_plans > 0 and be.n_learned_plans == 0


def test_scalar_misses_route_through_backend():
    mdp = _mdp()
    be = _backend(mdp.space, confidence_threshold=-1.0, audit_every=0)
    cmdp = CachedMDP(mdp, cost_backend=be)
    _warm(cmdp, n=40)
    cmdp.on_round_end()
    rng = random.Random(9)
    s = tuple(mdp.space.random_actions(rng))
    while s in cmdp.cache.terminal:
        s = tuple(mdp.space.random_actions(rng))
    f0 = be.model.n_forward
    c = cmdp.terminal_cost(s)
    assert cmdp.cache.terminal[s] == c
    assert cmdp.cache.terminal_version[s] == be.model.version
    assert be.model.n_forward == f0 + 1
    # partial prefix, too
    p = s[:3]
    cp = cmdp.partial_cost(p)
    assert cmdp.cache.partial[p] == cp
    assert cmdp.cache.partial_version[p] == be.model.version


def test_audit_stream_keeps_training_alive_while_serving():
    mdp = _mdp()
    be = _backend(mdp.space, confidence_threshold=-1.0, audit_every=2)
    cmdp = CachedMDP(mdp, cost_backend=be)
    _warm(cmdp, n=40)
    cmdp.on_round_end()
    assert be.trainer.confident
    n_analytic0 = be.trainer.n_analytic(cmdp.cache)
    # serving-era miss batches: each audits iff the stateless content hash
    # selects it — deterministic, process-independent, ~1/audit_every
    rng = random.Random(23)
    audited = served = 0
    for _ in range(24):
        s = tuple(mdp.space.random_actions(rng))
        while s in cmdp.cache.terminal:
            s = tuple(mdp.space.random_actions(rng))
        expect_audit = be.audit_batch([s])
        cmdp.terminal_cost_batch([s])
        tagged = s in cmdp.cache.terminal_version
        assert tagged == (not expect_audit)
        audited += expect_audit
        served += not expect_audit
    assert audited > 0 and served > 0
    # audited entries are exact, untagged, and harvestable: the analytic
    # stream keeps growing, so a later refit (and gate re-check) can fire
    assert be.trainer.n_analytic(cmdp.cache) == n_analytic0 + audited
    assert be.n_analytic_plans > 0
    # a pickled (worker) copy makes identical audit decisions
    worker = pickle.loads(pickle.dumps(cmdp)).cost_backend
    probe = [tuple(mdp.space.random_actions(rng)) for _ in range(16)]
    assert [worker.audit_batch([s]) for s in probe] == [
        be.audit_batch([s]) for s in probe]


def test_refit_evicts_superseded_predictions():
    mdp = _mdp()
    be = _backend(mdp.space, confidence_threshold=-1.0, refit_every=8,
                  audit_every=0)
    cmdp = CachedMDP(mdp, cost_backend=be)
    _warm(cmdp, n=40)
    cmdp.on_round_end()
    assert be.trainer.version == 1
    served = [s for s in _warm(cmdp, n=15, seed=5)
              if s in cmdp.cache.terminal_version]
    assert served  # v1 predictions are cached
    # drop the model: the next pricing boundary refits (analytic count is
    # past min_examples), evicts every v1 prediction, then serves v2
    be.trainer.model = None
    rng = random.Random(6)
    extra = []
    while len(extra) < 9:
        s = tuple(mdp.space.random_actions(rng))
        if s not in cmdp.cache.terminal:
            extra.append(s)
    cmdp.terminal_cost_batch(extra)
    assert be.trainer.version == 2
    # every v1 prediction is gone — repriced on next lookup, never served
    # as a stale hit; everything tagged now is v2
    assert all(s not in cmdp.cache.terminal for s in served)
    assert cmdp.cache.terminal_version
    assert all(v == 2 for v in cmdp.cache.terminal_version.values())
    c = cmdp.terminal_cost(served[0])  # reprice with the v2 model
    assert cmdp.cache.terminal_version[served[0]] == 2
    assert c > 0


def test_holdout_split_is_persistent_and_disjoint_from_training():
    mdp = _mdp()
    be = _backend(mdp.space)
    tr = be.trainer
    rng = random.Random(31)
    states = [tuple(mdp.space.random_actions(rng)) for _ in range(64)]
    first = [tr.is_holdout(s) for s in states]
    assert any(first) and not all(first)
    tr.version += 3  # the split must NOT depend on the fit generation
    assert [tr.is_holdout(s) for s in states] == first
    # pickled (worker) trainers agree too
    assert [pickle.loads(pickle.dumps(tr)).is_holdout(s) for s in states] == first


def test_make_cost_backend_modes():
    space = _mdp().space
    assert make_cost_backend("analytic", space) is None
    assert make_cost_backend(None, space) is None
    assert make_cost_backend("learned", space, device="cpu").mode == "learned"
    be = _backend(space)
    assert make_cost_backend(be, space) is be
    with pytest.raises(ValueError):
        make_cost_backend("compile", space)
    with pytest.raises(ValueError):
        HybridCostBackend(space, mode="analytic", device="cpu")


# ---------------------------------------------------------------------------
# the acceptance counter test: one model call per lockstep miss batch on
# the Table-1 decode cell
# ---------------------------------------------------------------------------
def test_lockstep_round_prices_miss_batch_in_one_forward_pass():
    mdp = _mdp("granite-3-2b", "decode_32k")
    # audits off: every miss batch must be exactly one model forward
    be = _backend(mdp.space, confidence_threshold=-1.0, audit_every=0)
    cmdp = CachedMDP(mdp, cost_backend=be)
    _warm(cmdp, n=40)  # train the server
    cmdp.on_round_end()
    assert be.model is not None
    iters, k = 6, 4
    import dataclasses

    cfg = MCTSConfig(ucb="paper", iters_per_decision=iters, seed=0)
    trees = [ArrayMCTS(cmdp, dataclasses.replace(cfg, seed=i))
             for i in range(k)]
    f0, b0 = be.model.n_forward, be.n_learned_batches
    hm0 = cmdp.cache.hits + cmdp.cache.misses
    run_decision_batch(trees, cmdp)
    forward = be.model.n_forward - f0
    batches = be.n_learned_batches - b0
    # every miss batch was priced in exactly ONE forward pass, and
    # there is at most one miss batch per lockstep step — never one call
    # per leaf (k * iters would be the scalar-loop count)
    assert forward == batches
    assert 0 < forward <= iters
    assert forward < k * iters
    # the lockstep round still priced every leaf through the cache seam
    assert cmdp.cache.hits + cmdp.cache.misses - hm0 >= k * iters


def test_round_end_hook_refits_between_rounds():
    mdp = _mdp()
    be = _backend(mdp.space, min_examples=32, refit_every=10**9)
    cmdp = CachedMDP(mdp, cost_backend=be)
    _warm(cmdp, n=60)
    assert be.trainer.model is None  # refit checks fired before the data existed
    # the lockstep round's boundary is a refit point
    tree = ArrayMCTS(cmdp, MCTSConfig(iters_per_decision=2, seed=0))
    run_decision_batch([tree], cmdp)
    assert be.trainer.model is not None, "round-end hook did not refit"


# ---------------------------------------------------------------------------
# ProTuner integration
# ---------------------------------------------------------------------------
def test_protuner_analytic_mode_is_bit_identical_and_unmounted():
    def run(**kw):
        t = ProTuner(
            _mdp(), n_standard=2, n_greedy=1,
            mcts_config=MCTSConfig(iters_per_decision=8), seed=1, **kw,
        )
        res = t.run()
        return t, res

    t0, r0 = run()
    t1, r1 = run(cost="analytic")
    assert t1.mdp.cost_backend is None  # nothing mounted: the exact path
    assert (r0.plan, r0.cost, [d["action"] for d in r0.decisions]) == (
        r1.plan, r1.cost, [d["action"] for d in r1.decisions])
    assert r1.cost_mode == "analytic" and r1.model_version == 0


def test_protuner_hybrid_falls_back_exactly_while_untrained():
    def run(cost):
        res = ProTuner(
            _mdp(), n_standard=2, n_greedy=1,
            mcts_config=MCTSConfig(iters_per_decision=8), seed=1, cost=cost,
        ).run()
        return res

    r_a = run("analytic")
    r_h = run(_backend(_mdp().space, min_examples=10**9))  # never trains
    assert (r_h.plan, r_h.cost) == (r_a.plan, r_a.cost)
    assert [d["action"] for d in r_h.decisions] == [
        d["action"] for d in r_a.decisions]
    assert r_h.cost_mode == "hybrid" and r_h.n_fits == 0


def test_protuner_hybrid_serves_and_reports():
    be = _backend(_mdp().space, confidence_threshold=-1.0)
    res = ProTuner(
        _mdp(), n_standard=2, n_greedy=1,
        mcts_config=MCTSConfig(iters_per_decision=16), seed=0, cost=be,
    ).run()
    assert res.cost_mode == "hybrid"
    assert res.n_fits >= 1 and res.model_version >= 1
    assert res.learned_evals > 0
    # reported cost is the EXACT analytic cost of the final plan, not the
    # model's estimate
    oracle = _mdp()
    assert res.cost == oracle.cost_model.cost(res.plan)


def test_protuner_rejects_hybrid_without_cache():
    with pytest.raises(ValueError):
        ProTuner(_mdp(), n_standard=1, n_greedy=0, cache=False, cost="hybrid", device="cpu")


def test_protuner_adopts_premounted_backend():
    # a backend already mounted on a passed-in CachedMDP is pricing misses
    # whatever cost= says — reporting and exact repricing must see it
    be = _backend(_mdp().space, confidence_threshold=-1.0)
    cmdp = CachedMDP(_mdp(), cost_backend=be)
    tuner = ProTuner(cmdp, n_standard=2, n_greedy=0,
                     mcts_config=MCTSConfig(iters_per_decision=16), seed=0)
    assert tuner.cost_backend is be and tuner.cost_mode == "hybrid"
    res = tuner.run()
    assert res.cost_mode == "hybrid" and res.learned_evals > 0
    assert res.cost == _mdp().cost_model.cost(res.plan)  # exact, not estimate


def test_reference_engine_serves_learned_cost():
    # cost backends imply the cache for ANY engine (the cache is the seam);
    # engine="reference" + cost="learned" must mount, not raise
    be = _backend(_mdp().space, mode="learned", min_examples=16)
    tuner = ProTuner(_mdp(), n_standard=1, n_greedy=0, engine="reference",
                     mcts_config=MCTSConfig(iters_per_decision=16), seed=0,
                     cost=be)
    assert isinstance(tuner.mdp, CachedMDP)
    res = tuner.run()
    assert res.cost_mode == "learned" and res.n_fits >= 1


# ---------------------------------------------------------------------------
# worker protocol: serve-only pickles, version tags survive merges
# ---------------------------------------------------------------------------
def test_pickled_backend_is_serve_only():
    mdp = _mdp()
    be = _backend(mdp.space, confidence_threshold=-1.0)
    cmdp = CachedMDP(mdp, cost_backend=be)
    _warm(cmdp, n=40)
    cmdp.on_round_end()
    v = be.model.version
    worker = pickle.loads(pickle.dumps(cmdp))
    wbe = worker.cost_backend
    assert wbe.refit_enabled is False and be.refit_enabled is True
    assert wbe.model.version == v
    # a worker prices new misses with the shipped model and tags them
    rng = random.Random(17)
    states = [tuple(mdp.space.random_actions(rng)) for _ in range(12)]
    worker.terminal_cost_batch(states)
    new = [s for s in states if s in worker.cache.terminal_version]
    assert new and all(worker.cache.terminal_version[s] == v for s in new)
    # trainer state untouched: no fits happened worker-side
    assert wbe.trainer.version == v


def test_params_ship_only_on_generation_change_and_evict_on_install():
    """The pinned-worker forward seam: ``params_delta`` is ``None`` while
    the fit generation is unchanged (nothing re-pickles round after
    round), ships ``(version, confident, model)`` exactly when a refit
    minted a new generation, and ``apply_params`` on the worker side
    mirrors the master's refit eviction before installing — stale
    predictions tagged by the superseded generation must not keep serving
    as hits."""
    mdp = _mdp()
    # steps=10: the protocol under test is version bookkeeping, not fit
    # quality — confidence_threshold=-1 serves whatever comes out
    be = _backend(mdp.space, confidence_threshold=-1.0, steps=10)
    cmdp = CachedMDP(mdp, cost_backend=be)
    assert be.params_delta(0) is None  # untrained: generation 0 everywhere
    _warm(cmdp, n=40)
    cmdp.on_round_end()  # master refit -> generation 1
    v = be.trainer.version
    assert v >= 1
    delta = be.params_delta(0)
    assert delta is not None
    assert delta[0] == v and delta[2] is be.trainer.model
    assert be.params_delta(v) is None  # same generation: nothing ships

    # worker holds generation v (the init snapshot) and serves with it
    worker = pickle.loads(pickle.dumps(cmdp))
    wbe = worker.cost_backend
    rng = random.Random(23)
    states = [tuple(mdp.space.random_actions(rng)) for _ in range(12)]
    worker.terminal_cost_batch(states)
    tagged = [s for s in states if s in worker.cache.terminal_version]
    assert tagged and all(
        worker.cache.terminal_version[s] == v for s in tagged
    )

    # master refits again -> generation v+1; the worker keeps serving the
    # old model until the delta arrives, then installs and evicts
    assert be.trainer.fit(cmdp.cache) is not None
    delta2 = be.params_delta(v)
    assert delta2 is not None and delta2[0] == v + 1
    assert wbe.trainer.version == v  # still the old generation
    wbe.apply_params(delta2)
    assert wbe.trainer.version == v + 1
    assert wbe.model is delta2[2]
    for s in tagged:  # superseded predictions evicted, repriced on lookup
        assert s not in worker.cache.terminal
    assert not worker.cache.terminal_version


def test_cache_merge_carries_version_tags():
    a, b = TranspositionCache(), TranspositionCache()
    a.terminal[(1, 2)] = 0.5
    b.terminal[(3, 4)] = 0.7
    b.terminal_version[(3, 4)] = 2
    b.partial[(3,)] = 0.9
    b.partial_version[(3,)] = 2
    a.merge(b)
    assert a.terminal_version == {(3, 4): 2}
    assert a.partial_version == {(3,): 2}
    st = a.stats()
    assert st["learned_terminal_entries"] == 1
    assert st["learned_partial_entries"] == 1


def test_cache_merge_exact_wins_over_predictions():
    # sibling workers race on state S: one audits it analytically (exact,
    # untagged), one serves the model (tagged) — exact must survive the
    # merge in BOTH orders
    def exact():
        c = TranspositionCache()
        c.terminal[(7, 7)] = 1.0  # the exact analytic value
        return c

    def predicted():
        c = TranspositionCache()
        c.terminal[(7, 7)] = 1.1  # a model prediction
        c.terminal_version[(7, 7)] = 3
        return c

    a = exact()
    a.merge(predicted())
    assert a.terminal[(7, 7)] == 1.0 and not a.terminal_version

    b = predicted()
    b.merge(exact())
    assert b.terminal[(7, 7)] == 1.0 and not b.terminal_version


def test_small_first_fit_never_trains_on_holdout_states():
    mdp = _mdp()
    be = _backend(mdp.space, min_examples=10, refit_every=10**9)
    tr = be.trainer
    cmdp = CachedMDP(mdp, cost_backend=be)
    # a snapshot small enough that the holdout slice (<8) cannot be scored
    rng = random.Random(41)
    states = []
    while len(states) < 12:
        s = tuple(mdp.space.random_actions(rng))
        if s not in states:
            states.append(s)
    n_marked = sum(tr.is_holdout(s) for s in states)
    assert n_marked > 0  # some ARE holdout-marked
    cmdp.terminal_cost_batch(states)
    cmdp.on_round_end()
    rep = tr.reports[-1]
    # uncertified (no scorable holdout) AND holdout-marked states sat out
    # of training entirely — they never leak into the warm-started params
    assert rep.n_holdout == 0 and not tr.confident
    assert rep.n_examples == len(states)
    assert rep.n_train == len(states) - n_marked < len(states)


def test_parallel_hybrid_merges_worker_tags_and_counters():
    # "learned" mode: serve as soon as the master's round-end fit exists
    # (the tiny first-round snapshot has no holdout, so hybrid's gate
    # would stay closed — gate behavior is covered sequentially above)
    be = _backend(_mdp().space, mode="learned", min_examples=16)
    tuner = ProTuner(
        _mdp(), n_standard=2, n_greedy=0,
        mcts_config=MCTSConfig(iters_per_decision=12), seed=0,
        parallel=True, cost=be,
    )
    res = tuner.run()
    assert res.cost > 0 and res.plan is not None
    assert be.trainer.version >= 1
    # learned-priced worker entries landed in the master cache with tags,
    # and the workers' serving counters merged back (they pickle zeroed,
    # ship as round activity) — TuneResult.learned_evals reflects them
    assert tuner.cache.terminal_version
    assert be.n_learned_plans > 0
    assert res.learned_evals == be.n_learned_plans
    # each worker names the device it priced on: the backend's, explicitly
    workers = res.stats["workers"]
    assert len(workers) == 2
    assert all(w["pricing"]["device"] == "cpu" for w in workers)
    assert {w["pricing"]["priced_on"] for w in workers} <= {"cpu", None}
    assert any(w["pricing"]["priced_on"] == "cpu" for w in workers)
    assert len({w["pricing"]["pid"] for w in workers}) == 2


# ---------------------------------------------------------------------------
# the port against the JAX package, from the same initial weights
# ---------------------------------------------------------------------------
def _jax_init(d_in, hidden=64, seed=0):
    return jax.tree.map(np.asarray, jlc._mlp_init(jax.random.PRNGKey(seed), d_in, hidden))


@pytest.mark.parametrize("cell", [DECODE_CELL, MOE_TRAIN_CELL], ids=["decode", "moe_train"])
@pytest.mark.parametrize("mode,threshold,iters,n_standard", [
    ("hybrid", -1.0, 16, 2), ("learned", 0.8, 16, 2), ("hybrid", 0.8, 16, 4),
    ("learned", 0.8, 32, 4)])
def test_learned_search_equals_the_jax_run(monkeypatch, cell, mode, threshold, iters,
                                           n_standard):
    """ProTuner with a learned backend, the port's MLP started from JAX's
    ``_mlp_init`` carried across: the same plan and exact cost, the same
    serving counters, fit generations, holdout Spearman and evals."""
    monkeypatch.setattr(learned_cost, "_mlp_init", _jax_init)
    kw = dict(min_examples=32, refit_every=64, steps=30, confidence_threshold=threshold)
    jmdp = make_cell_mdp(*cell)
    jbe = JaxBackend(jmdp.space, mode=mode, audit_every=8, trainer=JaxTrainer(jmdp.space, **kw))
    ref = JaxProTuner(jmdp, n_standard=n_standard, n_greedy=1,
                      mcts_config=JaxMCTSConfig(iters_per_decision=iters), seed=0,
                      cost=jbe).run()
    be = HybridCostBackend(_mdp(*cell).space, mode=mode, audit_every=8,
                           trainer=OnlineCostTrainer(_mdp(*cell).space, device="cpu", **kw))
    got = ProTuner(_mdp(*cell), n_standard=n_standard, n_greedy=1,
                   mcts_config=MCTSConfig(iters_per_decision=iters), seed=0, cost=be).run()
    assert got.plan.to_dict() == ref.plan.to_dict()
    assert got.cost == ref.cost
    assert be.counters() == jbe.counters()
    assert (got.n_fits, got.model_version, got.learned_evals, got.n_evals) == (
        ref.n_fits, ref.model_version, ref.learned_evals, ref.n_evals)
    assert [(r.n_examples, r.n_train, r.n_holdout, r.confident) for r in be.trainer.reports] == [
        (r.n_examples, r.n_train, r.n_holdout, r.confident) for r in jbe.trainer.reports]
    np.testing.assert_allclose([r.holdout_spearman for r in be.trainer.reports],
                               [r.holdout_spearman for r in jbe.trainer.reports], atol=1e-12)
    assert [d["action"] for d in got.decisions] == [d["action"] for d in ref.decisions]


@pytest.mark.parametrize("cost", ["learned", "hybrid"])
@pytest.mark.parametrize("algo", ["mcts_1s", "beam", "portfolio"])
def test_autotune_serves_learned_cost_on_the_cpu(cost, algo):
    """``autotune(cost=...)`` runs on the device asked for; the exact cost
    of the final plan is reported; beam prices analytically as in the JAX
    package (only MCTS serves a model)."""
    res = autotune("granite-3-2b", "decode_32k", algo=algo, cost=cost, device="cpu",
                   mdp=_mdp(), n_standard=2, n_greedy=1, hw="tpu-v5e")
    assert res.plan is not None and res.cost == _mdp().cost_model.cost(res.plan)
    if algo == "mcts_1s":
        assert res.cost_mode == cost and res.n_fits >= 1
        serving = res.stats["serving"]  # the backend's counters, fits and device
        assert serving["device"] == "cpu" and len(serving["fits"]) == res.n_fits
        assert serving["learned_plans"] == res.learned_evals


def test_backend_stats_name_the_pricing_device():
    be = _backend(_mdp().space, confidence_threshold=-1.0)
    cmdp = CachedMDP(_mdp(), cost_backend=be)
    assert be.device == "cpu" and be.stats()["priced_on"] is None
    _warm(cmdp, n=40)
    cmdp.on_round_end()
    _warm(cmdp, n=12, seed=4)
    st = be.stats()
    assert st["device"] == "cpu" and st["priced_on"] == "cpu" and st["learned_plans"] > 0
    rep = pickle.loads(pickle.dumps(be)).worker_report()
    assert rep["device"] == "cpu" and rep["priced_on"] == "cpu" and "cuda_context" in rep


def test_learned_backend_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cost_backend("hybrid", _mdp().space)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune("granite-3-2b", "decode_32k", algo="mcts_1s", cost="learned", n_standard=1,
                 n_greedy=0)

"""The port's learned cost model (``repro_torch.core.learned_cost``) against
the JAX package's (``repro.core.learned_cost``) on the same numpy inputs:
features element for element, the MLP forward from JAX's initial weights
within rtol 1e-5, a 60-step fit from the same weights and data within rtol
1e-4, ``_spearman`` exactly.  The port runs on the CPU here
(``device="cpu"``); ``chip_smoke.py`` holds card against CPU."""
import pickle
import random

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config, get_shape as jax_get_shape
from repro.core import learned_cost as jlc
from repro.core.cost_model import PlanColumns as JaxColumns
from repro.core.space import SINGLE_POD as JAX_SINGLE_POD, ScheduleSpace as JaxSpace
from repro_torch.configs import get_config, get_shape
from repro_torch.convert import MLP_KEYS, mlp_params_from_numpy, mlp_params_to_numpy
from repro_torch.core import learned_cost as lc
from repro_torch.core.cost_model import AnalyticCostModel, PlanColumns
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.space import SINGLE_POD, ScheduleSpace

torch.set_num_threads(1)

CELLS = [("granite-moe-1b-a400m", "train_4k"), ("granite-3-2b", "decode_32k"),
         ("falcon-mamba-7b", "train_4k"), ("stablelm-12b", "prefill_32k")]


def _spaces(arch, shape):
    """The cell's reduced space in both packages (the TPU spec: the port's
    space then offers the JAX package's stages and options)."""
    jsp = JaxSpace(jax_get_config(arch).reduced(), jax_get_shape(shape), JAX_SINGLE_POD)
    psp = ScheduleSpace(get_config(arch).reduced(), get_shape(shape), SINGLE_POD, TPU_V5E)
    return jsp, psp


def _plans(jsp, psp, n, seed=0):
    rng = np.random.default_rng(seed)
    acts = [[int(rng.integers(len(s.options))) for s in psp.stages] for _ in range(n)]
    return [jsp.plan_from_actions(a) for a in acts], [psp.plan_from_actions(a) for a in acts]


def _jax_init(d_in, seed=0):
    return jax.tree.map(np.asarray, jlc._mlp_init(jax.random.PRNGKey(seed), d_in))


def _data(arch="granite-moe-1b-a400m", shape="train_4k", n=96):
    jsp, psp = _spaces(arch, shape)
    jplans, pplans = _plans(jsp, psp, n)
    oracle = AnalyticCostModel(psp.cfg, psp.shape, psp.mesh, psp.hw)
    costs = oracle.cost_batch(pplans)
    return jsp, psp, jplans, pplans, costs


@pytest.mark.parametrize("arch,shape", CELLS)
def test_features_equal_the_jax_features(arch, shape):
    jsp, psp = _spaces(arch, shape)
    jplans, pplans = _plans(jsp, psp, 40, seed=3)
    ref = jlc.featurize_batch(jplans, jsp)
    got = lc.featurize_batch(pplans, psp)
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert np.array_equal(lc.featurize(pplans[0], psp), jlc.featurize(jplans[0], jsp))
    cols = lc.featurize_columns(PlanColumns.from_plans(pplans), psp)
    assert np.array_equal(cols, jlc.featurize_columns(JaxColumns.from_plans(jplans), jsp))
    assert np.array_equal(cols, got)
    # one-hot per stage, knobs after: width and exclusivity
    width = sum(len(s.options) for s in psp.stages)
    assert got.shape == (40, width + 5)
    off = 0
    for stage in psp.stages:
        assert np.all(got[:, off:off + len(stage.options)].sum(1) == 1.0)
        off += len(stage.options)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_forward_from_the_jax_init_agrees(arch, shape):
    """The same parameters (JAX's ``_mlp_init(PRNGKey(0))`` carried across)
    and normalization: the port's predictions within rtol 1e-5 of the JAX
    forward's, in one batch and one plan at a time."""
    jsp, psp = _spaces(arch, shape)
    jplans, pplans = _plans(jsp, psp, 37, seed=5)
    params = _jax_init(lc.featurize(pplans[0], psp).shape[0])
    jm = jlc.LearnedCostModel(params=jax.tree.map(jax.numpy.asarray, params), space=jsp,
                              mean=-4.0, std=1.5)
    pm = lc.LearnedCostModel(params=params, space=psp, mean=-4.0, std=1.5, device="cpu")
    ref = np.asarray(jm.cost_batch(jplans))
    got = np.asarray(pm.cost_batch(pplans))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose([pm.cost(p) for p in pplans[:5]], ref[:5], rtol=1e-5)
    assert pm.priced_on == "cpu"


def test_sixty_step_fit_from_the_same_init_agrees():
    """``fit_learned_cost(steps=60)`` from JAX's initial weights on the same
    plans and costs: the same normalization, and predictions (on the
    training plans and on unseen ones) within rtol 1e-4."""
    jsp, psp, jplans, pplans, costs = _data()
    params = _jax_init(lc.featurize(pplans[0], psp).shape[0])
    jm = jlc.fit_learned_cost(jsp, jplans, costs, steps=60,
                              params=jax.tree.map(jax.numpy.asarray, params))
    pm = lc.fit_learned_cost(psp, pplans, costs, steps=60, params=params, device="cpu")
    assert (pm.mean, pm.std) == (jm.mean, jm.std)
    np.testing.assert_allclose(pm.cost_batch(pplans), jm.cost_batch(jplans), rtol=1e-4)
    jnew, pnew = _plans(jsp, psp, 32, seed=9)
    np.testing.assert_allclose(pm.cost_batch(pnew), jm.cost_batch(jnew), rtol=1e-4)
    # the fit moved the weights, and both packages moved them alike
    jp = jax.tree.map(np.asarray, jm.params)
    for k in MLP_KEYS:
        assert not np.array_equal(pm.params[k], params[k]) or k.startswith("b")
        np.testing.assert_allclose(pm.params[k], jp[k], rtol=1e-3, atol=1e-5)


def test_spearman_is_exact():
    rng = np.random.default_rng(0)
    for n in (2, 7, 64, 300):
        a, b = rng.normal(size=n), rng.normal(size=n)
        assert lc._spearman(a, b) == jlc._spearman(a, b)
        ties = np.round(a, 1)
        assert lc._spearman(ties, b) == jlc._spearman(ties, b)
    assert lc._spearman(np.ones(5), np.arange(5.0)) == jlc._spearman(np.ones(5), np.arange(5.0))
    assert lc._spearman(np.zeros(1), np.zeros(1)) == 0.0  # no spread: 0, not nan
    assert lc._spearman(np.arange(9.0), np.arange(9.0)) == pytest.approx(1.0, abs=0)


def test_cost_batch_equals_scalar_costs_and_counts_one_forward():
    _, psp, _, pplans, costs = _data(n=64)
    model = lc.fit_learned_cost(psp, pplans, costs, steps=20, device="cpu")
    plans = pplans[:13]
    f0, e0 = model.n_forward, model.n_evals
    batched = model.cost_batch(plans)
    assert model.n_forward == f0 + 1 and model.n_evals == e0 + 13
    np.testing.assert_allclose(batched, [model.cost(p) for p in plans], rtol=1e-6)
    assert model.n_forward == f0 + 14
    assert all(np.isfinite(c) and c > 0 for c in batched)
    assert model.cost_batch([]) == [] and model.cost_columns(PlanColumns.from_plans([])) == []
    assert model.cost_columns(PlanColumns.from_plans(plans)) == batched
    # partial costs price the default completion
    acts = psp.random_actions(random.Random(1))[:3]
    full = acts + psp.default_actions()[3:]
    assert model.partial_cost(acts, psp) == model.cost(psp.plan_from_actions(full))


def test_refit_warm_start_and_per_fit_normalization():
    _, psp, _, pplans, costs = _data(n=64)
    m1 = lc.fit_learned_cost(psp, pplans, costs, steps=40, device="cpu")
    m2 = lc.fit_learned_cost(psp, pplans, [c * 100.0 for c in costs], params=m1.params,
                             steps=40, device="cpu")
    assert m2.mean == pytest.approx(m1.mean + np.log(100.0), rel=1e-3)
    assert all(np.isfinite(p) and p > 0 for p in m2.cost_batch(pplans[:8]))


def test_init_is_he_normal_from_an_explicit_generator():
    a, b = lc._mlp_init(20, seed=3), lc._mlp_init(20, seed=3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["w1"], lc._mlp_init(20, seed=4)["w1"])
    assert {k: v.shape for k, v in a.items()} == {
        "w1": (20, 64), "b1": (64,), "w2": (64, 64), "b2": (64,), "w3": (64, 1), "b3": (1,)}
    assert not any(a[k].any() for k in ("b1", "b2", "b3"))
    big = lc._mlp_init(4000, seed=0)["w1"]
    assert np.std(big) == pytest.approx((2.0 / 4000) ** 0.5, rel=0.02)
    state = torch.random.get_rng_state()
    lc._mlp_init(20, seed=3)
    assert torch.equal(state, torch.random.get_rng_state())  # the global RNG is untouched


def test_params_round_trip_and_a_pickled_model_ships_numpy():
    params = _jax_init(30)
    net = mlp_params_from_numpy(params, "cpu")
    assert isinstance(net, lc.MLP) and net.l1.weight.shape == (64, 30)
    back = mlp_params_to_numpy(net)
    assert all(np.array_equal(back[k], params[k]) for k in params)
    _, psp, _, pplans, costs = _data(n=48)
    model = lc.fit_learned_cost(psp, pplans, costs, steps=10, device="cpu")
    before = model.cost_batch(pplans[:6])
    clone = pickle.loads(pickle.dumps(model))
    assert clone._net is None and all(isinstance(v, np.ndarray) for v in clone.params.values())
    assert clone.cost_batch(pplans[:6]) == before


def test_ranking_correlation_and_train_learned_cost():
    _, psp = _spaces("granite-3-2b", "decode_32k")
    oracle = AnalyticCostModel(psp.cfg, psp.shape, psp.mesh, psp.hw)
    model = lc.train_learned_cost(psp, oracle, n_samples=128, steps=100, device="cpu")
    rho = lc.ranking_correlation(model, oracle, psp, n=64)
    assert -1.0 <= rho <= 1.0
    assert lc.ranking_correlation(oracle, oracle, psp, n=64) == pytest.approx(1.0)


def test_fitting_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, psp, _, pplans, costs = _data(n=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lc.fit_learned_cost(psp, pplans, costs, steps=1)
    model = lc.LearnedCostModel(params=lc._mlp_init(lc.featurize(pplans[0], psp).shape[0]),
                                space=psp, mean=0.0, std=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.cost(pplans[0])

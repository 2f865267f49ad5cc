"""The port's compiled pricing path (``pricing="jit"``): a float64 torch
program, held to the port's columnar kernel within ``JIT_RTOL`` (atol 0).

The JAX package's jitted path does not import under the installed jax (its
``cost_model._jax_mods`` needs ``jax.experimental.enable_x64``), so the
yardstick is the columnar kernel, which ``tests/test_torch_search.py`` holds
bit for bit to the JAX package's.  Here the program runs on the CPU
(``device="cpu"``); ``chip_smoke.py`` runs it on the card.
"""
import pickle
import random
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.core.autotuner import autotune, make_mdp
from repro_torch.core.cost_model import (
    JIT_MIN_BATCH, JIT_PRICING_TAG, JIT_RTOL, AnalyticCostModel, PlanColumns,
)
from repro_torch.core.hardware import H100, TPU_V5E
from repro_torch.core.space import ScheduleSpace, get_mesh
from repro_torch.service.store import canonical_request, cell_key, request_key

torch.set_num_threads(1)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _pair(arch, shape_name, hw, mesh, reduced):
    """(jit model through every batch, columnar model through every batch, space)."""
    cfg, shape = get_config(arch), get_shape(shape_name)
    cfg = cfg.reduced() if reduced else cfg
    spec = {"h100": H100, "tpu-v5e": TPU_V5E}[hw]
    mspec = get_mesh(spec, mesh)
    jit = AnalyticCostModel(cfg, shape, mspec, spec, pricing="jit", columnar_min_batch=1,
                            device="cpu")
    col = AnalyticCostModel(cfg, shape, mspec, spec, columnar_min_batch=1)
    return jit, col, ScheduleSpace(cfg, shape, mspec, spec)


def _check(jit, col, plans):
    cols = PlanColumns.from_plans(plans)
    a = jit._terms_jitted(cols, jit._ctx())
    b = col._terms_columnar(cols, col._ctx())["step_s"]
    assert np.all(np.isfinite(a)) and a.dtype == np.float64
    np.testing.assert_allclose(a, b, rtol=JIT_RTOL, atol=0.0)
    return a


@pytest.mark.parametrize("hw", ["h100", "tpu-v5e"])
@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_jit_matches_columnar_on_every_cell(arch, reduced, shape_name, hw):
    """Every arch, reduced and at full width, train/prefill/decode, both
    hardware specs, single and multi-pod: 48 numpy-seeded random plans
    (infeasible ones included: at full width many overflow a card)."""
    for mesh in ("single", "multi"):
        jit, col, space = _pair(arch, shape_name, hw, mesh, reduced)
        rng = np.random.default_rng(zlib.crc32(repr((arch, reduced, shape_name, hw, mesh)).encode()))
        plans = [space.plan_from_actions([int(rng.integers(len(s.options))) for s in space.stages])
                 for _ in range(48)]
        _check(jit, col, plans)
        assert jit.n_jit_batches == 1


@settings(max_examples=30, deadline=None)
@given(
    st.sampled_from(["granite-3-2b", "granite-moe-1b-a400m", "falcon-mamba-7b"]),
    st.sampled_from(["train_4k", "decode_32k"]),
    st.sampled_from(["h100", "tpu-v5e"]),
    st.sampled_from(["single", "multi"]),
    st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=12),
)
def test_jit_kernel_matches_columnar_within_rtol_property(arch, shape_name, hw, mesh, seeds):
    """The port's counterpart of the JAX package's jit-parity property:
    ``cost_batch`` through the compiled kernel against the exact columnar
    one, elementwise within JIT_RTOL, duplicates included."""
    jit, col, space = _pair(arch, shape_name, hw, mesh, True)
    plans = [space.random_plan(random.Random(s)) for s in seeds]
    plans = plans + plans[: len(plans) // 2]
    np.testing.assert_allclose(np.asarray(jit.cost_batch(plans)),
                               np.asarray(col.cost_batch(plans)), rtol=JIT_RTOL, atol=0.0)


def test_pricing_tag_contract():
    """The jit path's values carry their own versioned tag: the model's
    ``pricing_tag``, and the store's request and cell keys (which equal the
    exact path's keys when pricing is exact)."""
    mdp = make_mdp("granite-3-2b", "decode_32k", pricing="jit", device="cpu")
    cm = mdp.cost_model
    assert cm.pricing_tag == JIT_PRICING_TAG == "analytic-jit-v1"
    for exact in (None, "scalar", "columnar"):
        assert make_mdp("granite-3-2b", "decode_32k", pricing=exact).cost_model.pricing_tag == "exact"
    base = dict(arch="granite-3-2b", shape="decode_32k", algo="mcts_1s")
    exact = canonical_request(**base)
    jit = canonical_request(**base, pricing="jit")
    assert "pricing" not in exact and jit["pricing"] == JIT_PRICING_TAG
    assert canonical_request(**base, pricing="columnar") == exact
    assert request_key(jit) != request_key(exact) and cell_key(jit) != cell_key(exact)
    with pytest.raises(ValueError):
        canonical_request(**base, pricing="xla")


def test_min_batch_dispatch_and_exact_small_batches():
    """JIT_MIN_BATCH is the JAX package's 8 (the columnar kernel's is 16);
    below it a batch prices through the exact scalar replay and never runs
    the program."""
    assert JIT_MIN_BATCH == 8
    jit = make_mdp("granite-moe-1b-a400m", "train_4k", "card", pricing="jit", device="cpu")
    exact = make_mdp("granite-moe-1b-a400m", "train_4k", "card")
    assert jit.cost_model.columnar_min_batch == 8 and exact.cost_model.columnar_min_batch == 16
    space = exact.space
    plans = [space.random_plan(random.Random(s)) for s in range(20)]
    assert jit.cost_model.cost_batch(plans[:7]) == exact.cost_model.cost_batch(plans[:7])
    assert jit.cost_model.n_jit_batches == 0
    got = jit.cost_model.cost_batch(plans)
    assert jit.cost_model.n_jit_batches == 1
    np.testing.assert_allclose(got, exact.cost_model.cost_batch(plans), rtol=JIT_RTOL, atol=0.0)
    # the scalar seam prices through the same dispatch (a batch of one: exact)
    assert jit.cost_model.cost(plans[0]) == exact.cost_model.cost(plans[0])


def test_pickled_model_drops_the_program_and_reprices_equal():
    jit, _, space = _pair("falcon-mamba-7b", "train_4k", "h100", "single", True)
    plans = [space.random_plan(random.Random(s)) for s in range(10)]
    first = jit.cost_batch(plans)
    assert jit._jit_fn is not None
    clone = pickle.loads(pickle.dumps(jit))
    assert clone._jit_fn is None and clone.device == "cpu"
    assert clone.cost_batch(plans) == first


def test_jit_search_agrees_with_the_exact_search():
    """``autotune(pricing="jit")`` on the CPU: within JIT_RTOL of every exact
    value, so the search takes the exact run's decisions here."""
    kw = dict(algo="mcts_1s", seed=0, n_standard=2, n_greedy=1, hw="tpu-v5e")
    jit = autotune("granite-3-2b", "decode_32k", pricing="jit", device="cpu", **kw)
    exact = autotune("granite-3-2b", "decode_32k", **kw)
    assert jit.plan == exact.plan
    assert [d["action"] for d in jit.decisions] == [d["action"] for d in exact.decisions]
    assert abs(jit.cost - exact.cost) <= JIT_RTOL * exact.cost


def test_jit_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mdp("granite-3-2b", "decode_32k", pricing="jit")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune("granite-3-2b", "decode_32k", algo="mcts_1s", pricing="jit", n_standard=1,
                 n_greedy=0)

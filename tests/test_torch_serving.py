"""The port's continuous-batching engine on the CPU against the JAX engine.

Same weights (JAX-initialised, carried across), same prompts as
``test_serving_engine.py``: the token ids must be identical, batched decode
must equal solo decode, and ``run()`` returns only that call's completions.
granite-3-2b has its own tests; the MoE and Mamba archs share tests
parametrised over the arch, slot reuse included.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

PROMPTS = [
    np.array([3, 1, 4, 1, 5, 9, 2], np.int32),
    np.array([2, 7], np.int32),
    np.array([6, 6, 6, 6], np.int32),
]


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("granite-3-2b").reduced()
    cfg = get_config("granite-3-2b").reduced()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _engine(cfg, params, slots, max_len=32):
    return ServingEngine(cfg, params, batch_slots=slots, max_len=max_len, device="cpu")


def _solo(cfg, params, prompt, max_new):
    eng = _engine(cfg, params, 1)
    eng.submit(prompt, max_new_tokens=max_new)
    (done,) = eng.run()
    return done.generated


def test_token_ids_match_jax_engine(model):
    jcfg, cfg, jparams, params = model
    jeng = JaxServingEngine(jcfg, jparams, batch_slots=2, max_len=32)
    eng = _engine(cfg, params, 2)
    for p in PROMPTS:
        jeng.submit(p, max_new_tokens=5)
        eng.submit(p, max_new_tokens=5)
    exp = {r.uid: r.generated for r in jeng.run()}
    got = {r.uid: r.generated for r in eng.run()}
    assert got == exp
    assert all(len(g) == 5 for g in got.values())


def test_batched_decode_matches_solo(model):
    _, cfg, _, params = model
    eng = _engine(cfg, params, 2)
    uids = [eng.submit(p, max_new_tokens=5) for p in PROMPTS]
    by_uid = {r.uid: r.generated for r in eng.run()}
    assert sorted(by_uid) == uids
    for uid, prompt in zip(uids, PROMPTS):
        assert by_uid[uid] == _solo(cfg, params, prompt, 5)


def test_slot_reuse_matches_a_fresh_engine(model):
    _, cfg, _, params = model
    eng = _engine(cfg, params, 1)
    eng.submit(np.array([9, 8, 7], np.int32), max_new_tokens=4)
    eng.run()
    eng.submit(np.array([1, 2], np.int32), max_new_tokens=4)
    (second,) = eng.run()
    assert second.generated == _solo(cfg, params, np.array([1, 2], np.int32), 4)


def test_run_returns_only_this_calls_completions(model):
    _, cfg, _, params = model
    eng = _engine(cfg, params, 2)
    eng.submit(np.array([1, 2], np.int32), max_new_tokens=2)
    assert [r.uid for r in eng.run()] == [1]
    eng.submit(np.array([3], np.int32), max_new_tokens=2)
    assert [r.uid for r in eng.run()] == [2]
    assert [r.uid for r in eng.finished] == [1, 2]


def test_run_surfaces_still_active_requests(model):
    _, cfg, _, params = model
    eng = _engine(cfg, params, 1)
    eng.submit(np.array([5], np.int32), max_new_tokens=8)
    eng.submit(np.array([6], np.int32), max_new_tokens=8)
    assert eng.run(max_steps=3) == []
    assert eng.pending() == {"active": 1, "queued": 1}
    assert len(eng.run()) == 2
    assert eng.pending() == {"active": 0, "queued": 0}


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["granite-moe-1b-a400m", "falcon-mamba-7b"])
def arch_model(request):
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def test_arch_token_ids_match_jax_engine(arch_model):
    jcfg, cfg, jparams, params = arch_model
    jeng = JaxServingEngine(jcfg, jparams, batch_slots=2, max_len=32)
    eng = _engine(cfg, params, 2)
    for p in PROMPTS:
        jeng.submit(p, max_new_tokens=5)
        eng.submit(p, max_new_tokens=5)
    exp = {r.uid: r.generated for r in jeng.run()}
    got = {r.uid: r.generated for r in eng.run()}
    assert got == exp
    assert all(len(g) == 5 for g in got.values())


def test_arch_slot_reuse_matches_jax_and_a_fresh_engine(arch_model):
    """The second occupant of a slot yields what a fresh engine yields (the
    conv/SSM state is zeroed on reassignment), in both frameworks."""
    jcfg, cfg, jparams, params = arch_model
    jeng = JaxServingEngine(jcfg, jparams, batch_slots=1, max_len=32)
    eng = _engine(cfg, params, 1)
    for e in (jeng, eng):
        e.submit(np.array([9, 8, 7], np.int32), max_new_tokens=4)
        e.run()
        e.submit(np.array([1, 2], np.int32), max_new_tokens=4)
    (jsecond,), (second,) = jeng.run(), eng.run()
    assert second.generated == jsecond.generated
    assert second.generated == _solo(cfg, params, np.array([1, 2], np.int32), 4)

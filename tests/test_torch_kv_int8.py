"""The port's int8 KV cache on the CPU against the JAX package's.

The same JAX-initialised weights (carried across with
``convert.params_from_numpy``) and numpy tokens go through the jitted JAX
``decode_step`` on ``init_cache(..., kv_dtype="int8")`` and through the
port's, over several steps, with a scalar and a per-row ``cur``, and with a
``commit`` mask on the port's side (the JAX engine's ``where`` on the JAX
side).  Tolerances:

* codes: within 1 of the JAX codes, on at most ``CODE_SHARE`` of the
  entries (inside ``jax.jit`` XLA turns ``amax / 127`` and ``x / scale``
  into multiplies by reciprocals, and the two packages' f32 products may
  round a K or V element apart, so a value at a rounding boundary may take
  the next code);
* scales: f32 round-off, relative ``SCALE_RTOL``;
* logits: the bf16 decode tests' ``TOL`` (``tests/test_torch_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.space import SchedulePlan
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models import transformer as ttf
from repro_torch.training.train_step import make_serve_step

torch.set_num_threads(1)

B, L = 2, 8
TOL = dict(rtol=1e-4, atol=1e-4)
CODE_SHARE = 1e-2
SCALE_RTOL = 2e-6
ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "jamba-1.5-large-398b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    jstep = jax.jit(lambda p, c, x, t: jtf.decode_step(p, jcfg, c, x, t))
    return jcfg, cfg, jparams, params, toks, jstep


def _tok(toks, t):
    return torch.from_numpy(toks[:, t:t + 1]).long()


def _assert_cache_close(got: dict, exp: dict) -> None:
    """Every leaf of the port's cache tree against the JAX tree: int8 codes
    within the stated share, scales to f32 round-off, other leaves (the
    Mamba state of a hybrid period) to ``TOL``."""
    assert got.keys() == exp.keys()
    for k in got:
        if isinstance(got[k], dict):
            _assert_cache_close(got[k], exp[k])
            continue
        a, e = got[k].numpy(), np.asarray(exp[k])
        assert a.shape == e.shape and a.dtype == e.dtype, k
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - e.astype(np.int32))
            assert d.max() <= 1, f"{k}: a code differs by {d.max()}"
            assert (d != 0).mean() <= CODE_SHARE, f"{k}: {(d != 0).mean():.4f} of the codes differ"
        elif k in ("k_s", "v_s"):
            np.testing.assert_allclose(a, e, rtol=SCALE_RTOL, atol=0)
        else:
            np.testing.assert_allclose(a, e, **TOL)


def test_int8_cache_layout(model):
    _, cfg, *_ = model
    cache = ttf.init_cache(cfg, B, L, kv_dtype="int8", device="cpu")
    n_attn = 0
    for leaves in cache.values():
        if "k" not in leaves:
            continue
        n_attn += 1
        lead = (cfg.n_periods, B, cfg.n_kv_heads, L)
        assert leaves.keys() == {"k", "v", "k_s", "v_s"}
        for name in ("k", "v"):
            assert leaves[name].dtype == torch.int8
            assert tuple(leaves[name].shape) == lead + (cfg.resolved_head_dim,)
            assert not leaves[name].any()
        for name in ("k_s", "v_s"):
            assert leaves[name].dtype == torch.float32
            assert tuple(leaves[name].shape) == lead + (1,)
            assert bool((leaves[name] == 1).all())  # ones, as the JAX cache starts
    assert n_attn >= 1


def test_int8_decode_scalar_cur_matches_jax(model):
    jcfg, cfg, jparams, params, toks, jstep = model
    jcache = jtf.init_cache(jcfg, B, L, "int8")
    cache = ttf.init_cache(cfg, B, L, kv_dtype="int8", device="cpu")
    for t in range(6):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, cache = ttf.decode_step(params, cfg, cache, _tok(toks, t), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(cache, jcache)


def test_int8_decode_per_row_cur_matches_jax(model):
    jcfg, cfg, jparams, params, toks, jstep = model
    jcache = jtf.init_cache(jcfg, B, L, "int8")
    cache = ttf.init_cache(cfg, B, L, kv_dtype="int8", device="cpu")
    for t in range(6):
        _, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        _, cache = ttf.decode_step(params, cfg, cache, _tok(toks, t), t)
    for cur in (np.array([2, 5], np.int32), np.array([6, 0], np.int32)):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, 7:8]), jnp.asarray(cur))
        tl, cache = ttf.decode_step(params, cfg, cache, _tok(toks, 7), torch.from_numpy(cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_close(cache, jcache)


def test_int8_decode_commit_writes_only_its_rows_in_place(model):
    """The in-place masked write of codes and scales equals the JAX engine's
    commit: the new cache where ``commit`` is true, the old one elsewhere."""
    jcfg, cfg, jparams, params, toks, jstep = model
    jcache = jtf.init_cache(jcfg, B, L, "int8")
    cache = ttf.init_cache(cfg, B, L, kv_dtype="int8", device="cpu")
    for t in range(3):
        _, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        _, cache = ttf.decode_step(params, cfg, cache, _tok(toks, t), t)
    for commit in (np.array([True, False]), np.array([False, True])):
        cur = np.array([3, 1], np.int32)
        jl, jnew = jstep(jparams, jcache, jnp.asarray(toks[:, 5:6]), jnp.asarray(cur))
        jcache = jax.tree.map(
            lambda new, old: np.where(commit.reshape((1, B) + (1,) * (new.ndim - 2)), new, old),
            jnew, jcache)
        tl, got = ttf.decode_step(params, cfg, cache, _tok(toks, 5), torch.from_numpy(cur),
                                  commit=torch.from_numpy(commit))
        assert got is cache
        _assert_cache_close(cache, jcache)
        np.testing.assert_allclose(tl.numpy()[commit], np.asarray(jl)[commit], **TOL)


def test_int8_decode_quantizes_each_new_row_through_the_wrapper(model, monkeypatch):
    """Each attention layer's new K and V rows go through ``ops.quantize_int8``
    as one contiguous ``(B*Hkv, hd)`` tensor each: two calls a layer a step
    (the chip check counts the same calls as kernel launches)."""
    _, cfg, _, params, toks, _ = model
    shapes = []
    real = ops.quantize_int8

    def counting(x):
        shapes.append((tuple(x.shape), x.is_contiguous()))
        return real(x)

    monkeypatch.setattr(ops, "quantize_int8", counting)
    cache = ttf.init_cache(cfg, B, L, kv_dtype="int8", device="cpu")
    ttf.decode_step(params, cfg, cache, _tok(toks, 0), 0)
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_plan()) * cfg.n_periods
    assert shapes == [((B * cfg.n_kv_heads, cfg.resolved_head_dim), True)] * (2 * n_attn)


def test_int8_serve_step_stays_near_the_full_precision_cache(model):
    """``make_serve_step`` over ``init_cache(kv_dtype=plan.kv_dtype)``, as the
    card's decode measurement builds it: the int8 cache's logits within 1e-2
    in relative norm of the f32 cache's, and its codes times its scales
    within half a step (plus f32 round-off) of the f32 cache's K and V in
    the first attention layer, whose inputs the two runs share."""
    _, cfg, _, params, toks, _ = model
    out = {}
    for kv_dtype in ("bf16", "int8"):
        step = make_serve_step(cfg, None, SchedulePlan(kv_dtype=kv_dtype), device="cpu")
        cache = ttf.init_cache(cfg, B, L, kv_dtype=kv_dtype, device="cpu")
        for t in range(L):
            logits, cache = step(params, cache, _tok(toks, t), t)
        out[kv_dtype] = logits, cache
    (ref, ref_cache), (got, got_cache) = out["bf16"], out["int8"]
    assert float((got - ref).norm() / ref.norm()) < 1e-2
    first = next(name for name, leaves in got_cache.items() if "k_s" in leaves)
    leaves = ttf.period_params(got_cache[first], 0)
    for k in ("k", "v"):
        deq = leaves[k].float() * leaves[k + "_s"]
        err = (deq - ref_cache[first][k][0]).abs()
        assert bool((err <= leaves[k + "_s"] * (0.5 + 1e-5)).all()), k


def test_quant_kv_rows_are_the_plain_rowwise_quantizer():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 2, 1, 16)).astype(np.float32))
    q, s = attention._quant_kv(x)
    qp, sp = ops.quantize_int8(x.reshape(6, 16))
    assert q.shape == (3, 2, 1, 16) and s.shape == (3, 2, 1, 1)
    assert torch.equal(q.reshape(6, 16), qp) and torch.equal(s.reshape(6, 1), sp)

"""The port's models on the CPU against the JAX package's.

Reduced configs (f32, the JAX ``reduced()`` layer count), JAX-initialised
weights carried across with ``convert.params_from_numpy``, tokens drawn with
numpy: prefill logits, decode logits and the updated caches must agree.
granite-3-2b has its own tests; the MoE, Mamba and hybrid archs share
tests parametrised over the arch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.space import MeshSpec, SchedulePlan
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttf
from repro_torch.training.train_step import (
    make_positions, make_prefill_step, make_serve_step, tiles_from_plan,
)

import torch_dist_cases as dist_cases

torch.set_num_threads(1)

B, S = 2, 16
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("granite-3-2b").reduced()
    cfg = get_config("granite-3-2b").reduced()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jparams, params, toks


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _tnp(tree):
    return {k: _tnp(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _assert_tree_close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_close(a[k], b[k])
        else:
            np.testing.assert_allclose(a[k], b[k], **TOL)


def test_config_copy_matches_jax(model):
    jcfg, cfg, *_ = model
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config("granite-3-2b")) == dataclasses.asdict(
        jax_get_config("granite-3-2b")
    )
    assert cfg.n_layers == 2 and cfg.dtype == "float32"


def test_converted_params_keep_nesting_and_stacked_axis(model):
    jcfg, cfg, jparams, params, _ = model
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in jleaves:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert params["blocks"]["b0"]["attn"]["wq"].shape[0] == cfg.n_periods


def test_prefill_logits_match_jax(model):
    jcfg, cfg, jparams, params, toks = model
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    exp = jtf.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    plan = SchedulePlan(attn_block=(8, 16))
    step = make_prefill_step(cfg, None, plan, device="cpu")
    batch = {
        "inputs": torch.from_numpy(toks).long(),
        "positions": make_positions(cfg, B, S, device="cpu"),
    }
    got = step(params, batch)
    assert got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    assert tiles_from_plan(plan).attn_block_q == 8


def test_decode_scalar_cur_matches_jax(model):
    jcfg, cfg, jparams, params, toks = model
    T, L = 6, 8
    jcache = jtf.init_cache(jcfg, B, L)
    cache = ttf.init_cache(cfg, B, L, device="cpu")
    for t in range(T):
        jl, jcache = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, cache = ttf.decode_step(params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(_tnp(cache), _np(jcache))


def test_decode_per_row_cur_matches_jax(model):
    jcfg, cfg, jparams, params, toks = model
    L = 8
    jcache = jtf.init_cache(jcfg, B, L)
    cache = ttf.init_cache(cfg, B, L, device="cpu")
    # rows at different lengths: row 0 at 2, row 1 at 5, over a filled cache
    for t in range(6):
        _, jcache = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        _, cache = ttf.decode_step(params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
    cur = np.array([2, 5], np.int32)
    tok = toks[:, 7:8]
    jl, jcache = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(tok), jnp.asarray(cur))
    tl, cache = ttf.decode_step(params, cfg, cache, torch.from_numpy(tok).long(), torch.from_numpy(cur))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(_tnp(cache), _np(jcache))


def test_decode_commit_writes_only_its_rows_in_place(model):
    """The in-place masked write equals the JAX engine's commit: the new cache
    where ``commit`` is true, the old one elsewhere, and the same tree object."""
    jcfg, cfg, jparams, params, toks = model
    L = 8
    jcache = jtf.init_cache(jcfg, B, L)
    cache = ttf.init_cache(cfg, B, L, device="cpu")
    for t in range(3):
        _, jcache = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        _, cache = ttf.decode_step(params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
    cur = np.array([3, 1], np.int32)
    commit = np.array([True, False])
    jl, jnew = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, 5:6]), jnp.asarray(cur))
    exp = jax.tree.map(
        lambda new, old: np.where(commit.reshape((1, B) + (1,) * (new.ndim - 2)), new, old), jnew, jcache
    )
    tl, got = ttf.decode_step(params, cfg, cache, torch.from_numpy(toks[:, 5:6]).long(),
                              torch.from_numpy(cur), commit=torch.from_numpy(commit))
    assert got is cache
    _assert_tree_close(_tnp(got), _np(exp))
    np.testing.assert_allclose(tl.numpy()[commit], np.asarray(jl)[commit], **TOL)


def test_decode_matches_forward(model):
    """Token-by-token decode reproduces the teacher-forced forward logits
    (the port's mirror of test_models_smoke.test_decode_matches_forward)."""
    _, cfg, _, params, toks = model
    T = 8
    x = torch.from_numpy(toks[:, :T]).long()
    full = ttf.forward(params, cfg, x, make_positions(cfg, B, T, device="cpu"))
    cache = ttf.init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        last, cache = ttf.decode_step(params, cfg, cache, x[:, t:t + 1], t)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


def test_unported_paths_raise_with_their_roadmap_item(model):
    """Prefill and decode over a mesh are ported (decode named ROADMAP A8
    until then): on a (1, 1) gloo mesh the prefill logits equal the
    one-device step's, and the serve step's decoded logits equal the
    one-device serve step's bit for bit (one device is a mesh of size 1)."""
    _, cfg, jparams, params, toks = model
    tree = jax.tree.map(np.asarray, jparams)
    got, got_dec = run_on_mesh(MeshSpec(("data", "model"), (1, 1)), dist_cases.prefill_and_decode_one,
                               "granite-3-2b", {}, tree, B, S, device="cpu")[0]
    batch = dist_cases.batch_for(cfg, B, S)
    exp = make_prefill_step(cfg, None, SchedulePlan(), device="cpu")(params, batch)
    np.testing.assert_allclose(got.numpy(), exp.numpy(), **TOL)
    serve = make_serve_step(cfg, None, SchedulePlan(), device="cpu")
    cache = ttf.init_cache(cfg, B, S, device="cpu")
    exp_dec = torch.stack([serve(params, cache, batch["inputs"][:, t:t + 1], t)[0] for t in range(S)], 1)
    assert torch.equal(got_dec, exp_dec)
    # A2 is ported: every arch resolves and M-RoPE has its positions
    assert get_config("qwen2-vl-72b").pos_kind == "mrope"
    assert get_config("nemotron-4-15b").n_layers == 32
    pos = make_positions(dataclasses.replace(cfg, pos_kind="mrope"), B, S, device="cpu")
    assert tuple(pos.shape) == (B, 3, S)


# ---------------------------------------------------------------------------
# MoE, Mamba and the hybrid period (attention + Mamba + MoE)
NEW_ARCHS = ["granite-moe-1b-a400m", "falcon-mamba-7b", "jamba-1.5-large-398b"]


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_model(request):
    jcfg = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jparams, params, toks


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_registered_config_matches_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    assert [(s.mixer, s.mlp) for s in cfg.layer_plan()] == [
        (s.mixer, s.mlp) for s in jcfg.layer_plan()]
    assert (cfg.resolved_dt_rank, cfg.is_moe, cfg.is_ssm, cfg.is_attention_free) == (
        jcfg.resolved_dt_rank, jcfg.is_moe, jcfg.is_ssm, jcfg.is_attention_free)


def test_arch_prefill_logits_match_jax(arch_model):
    jcfg, cfg, jparams, params, toks = arch_model
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    plan = SchedulePlan(attn_block=(8, 16), scan_chunk=64)
    jtiles = jops.KernelTiles(attn_block_q=8, attn_block_kv=16, scan_chunk=64)
    exp = jtf.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), tiles=jtiles)
    step = make_prefill_step(cfg, None, plan, device="cpu")
    ops.reset_counters()
    got = step(params, {"inputs": torch.from_numpy(toks).long(),
                        "positions": make_positions(cfg, B, S, device="cpu")})
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors launch nothing
    assert got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_arch_decode_logits_and_cache_match_jax(arch_model):
    jcfg, cfg, jparams, params, toks = arch_model
    L = 8
    jcache = jtf.init_cache(jcfg, B, L)
    cache = ttf.init_cache(cfg, B, L, device="cpu")
    for t in range(5):
        jl, jcache = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, cache = ttf.decode_step(params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(_tnp(cache), _np(jcache))


def test_arch_decode_per_row_commit_matches_jax(arch_model):
    """Rows at their own lengths, one row committed: the JAX step followed by
    the JAX engine's masked commit, against the port's in-place commit."""
    jcfg, cfg, jparams, params, toks = arch_model
    L = 8
    jcache = jtf.init_cache(jcfg, B, L)
    cache = ttf.init_cache(cfg, B, L, device="cpu")
    for t in range(3):
        _, jcache = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        _, cache = ttf.decode_step(params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
    cur = np.array([3, 1], np.int32)
    commit = np.array([False, True])
    jl, jnew = jtf.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, 5:6]), jnp.asarray(cur))
    exp = jax.tree.map(
        lambda new, old: np.where(commit.reshape((1, B) + (1,) * (new.ndim - 2)), new, old), jnew, jcache
    )
    tl, got = ttf.decode_step(params, cfg, cache, torch.from_numpy(toks[:, 5:6]).long(),
                              torch.from_numpy(cur), commit=torch.from_numpy(commit))
    assert got is cache
    _assert_tree_close(_tnp(got), _np(exp))
    np.testing.assert_allclose(tl.numpy()[commit], np.asarray(jl)[commit], **TOL)


def test_arch_decode_matches_forward(arch_model):
    _, cfg, _, params, toks = arch_model
    T = 8
    x = torch.from_numpy(toks[:, :T]).long()
    full = ttf.forward(params, cfg, x, make_positions(cfg, B, T, device="cpu"))
    cache = ttf.init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        last, cache = ttf.decode_step(params, cfg, cache, x[:, t:t + 1], t)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b"])
def test_converted_leaves_keep_their_dtypes(arch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(tree, cfg, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        node = params
        for key in path:
            node = node[key.key]
        f32 = path[-1].key in convert.F32_LEAVES
        assert node.dtype == (torch.float32 if f32 else torch.bfloat16), path
        assert (leaf.dtype.name == "float32") == f32
        np.testing.assert_array_equal(node.float().numpy(), leaf.astype(np.float32))
    slot = "mlp" if cfg.is_moe else "mamba"
    name = "router" if cfg.is_moe else "A_log"
    tree["blocks"]["b0"][slot][name] = tree["blocks"]["b0"][slot][name].astype(jnp.bfloat16)
    with pytest.raises(ValueError, match=name):
        convert.params_from_numpy(tree, cfg, device="cpu")


def test_make_serve_step_passes_the_plan_tiles_to_moe(monkeypatch):
    """The plan's tiles reach every grouped GEMM of a decode step (and of a
    prefill), as the JAX ``make_serve_step`` threads them."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = ttf.init_params(cfg, 0, device="cpu")
    plan = SchedulePlan(attn_block=(8, 16), scan_chunk=64)
    want = tiles_from_plan(plan)
    assert (want.attn_block_q, want.attn_block_kv, want.scan_chunk) == (8, 16, 64)
    seen = []
    real = ops.moe_gemm

    def spy(x, w, *, tiles=ops.DEFAULT_TILES):
        seen.append(tiles)
        return real(x, w, tiles=tiles)

    monkeypatch.setattr(ops, "moe_gemm", spy)
    step = make_serve_step(cfg, None, plan, device="cpu")
    cache = ttf.init_cache(cfg, B, 8, device="cpu")
    step(params, cache, torch.zeros((B, 1), dtype=torch.long), 0)
    assert seen == [want] * 3 * cfg.n_layers
    seen.clear()
    make_prefill_step(cfg, None, plan, device="cpu")(
        params, {"inputs": torch.zeros((B, S), dtype=torch.long),
                 "positions": make_positions(cfg, B, S, device="cpu")})
    assert seen == [want] * 3 * cfg.n_layers


def test_prefill_step_passes_the_plan_scan_chunk(monkeypatch):
    cfg = get_config("falcon-mamba-7b").reduced()
    params = ttf.init_params(cfg, 0, device="cpu")
    seen = []
    real = ops.selective_scan

    def spy(*args, tiles=ops.DEFAULT_TILES):
        seen.append((tiles.scan_chunk, tiles.scan_d_block))
        return real(*args, tiles=tiles)

    monkeypatch.setattr(ops, "selective_scan", spy)
    make_prefill_step(cfg, None, SchedulePlan(scan_chunk=64), device="cpu")(
        params, {"inputs": torch.zeros((B, S), dtype=torch.long),
                 "positions": make_positions(cfg, B, S, device="cpu")})
    assert seen == [(64, 256)] * cfg.n_layers

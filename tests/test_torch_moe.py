"""The port's MoE on the CPU against the JAX package's.

The plain ``moe_gemm`` against the Pallas kernel in interpret mode on the
parametrisations of ``test_kernels.py``; ``moe.forward`` on reduced
granite-moe against ``repro.models.moe.forward`` with JAX-initialised
weights, routing and dispatch bookkeeping compared exactly, once without
drops and once with a router biased so that two experts overflow.  A CPU
tensor takes the plain version and never counts as a launch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.core.space import MeshSpec
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import moe

import torch_dist_cases as dist_cases

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
B, S = 2, 16  # 32 tokens


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tree(p) -> dict:
    return {k: _t(np.asarray(v)) for k, v in p.items()}


# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "E,C,d,f,bc,bf,bd",
    [(4, 32, 64, 48, 16, 16, 32), (2, 16, 32, 32, 16, 32, 16), (8, 8, 16, 16, 8, 16, 16)],
)
def test_moe_gemm_plain_matches_pallas(E, C, d, f, bc, bf, bd):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, f)).astype(np.float32)
    exp = jax_moe_gemm(jnp.asarray(x), jnp.asarray(w), block_c=bc, block_f=bf, block_d=bd,
                       interpret=True)
    tiles = ops.KernelTiles(moe_block_c=bc, moe_block_f=bf, moe_block_d=bd)
    mg.LAUNCHES.reset()
    got = ops.moe_gemm(_t(x), _t(w), tiles=tiles)  # a CPU tensor: the plain version
    assert mg.LAUNCHES.count == 0 and mg.LAUNCHES.tiles == set()
    assert got.shape == (E, C, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-4, rtol=2e-4)


def test_moe_gemm_plain_bf16_accumulates_in_f32_and_returns_x_dtype():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 8, 64)).astype(np.float32)
    w = rng.standard_normal((3, 64, 24)).astype(np.float32)
    exp = jref.moe_gemm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    got = ref.moe_gemm(_t(x).bfloat16(), _t(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(exp, np.float32))


@pytest.mark.parametrize("x_t,w_t", [(False, False), (False, True), (True, False), (True, True)])
def test_moe_gemm_function_gradients_in_every_layout(x_t, w_t):
    # ragged E and C; each operand given as stored, transposed where its flag
    # is set; the Function's dx and dw against autograd through ref.moe_gemm
    rng = np.random.default_rng(12)
    E, C, d, f = 3, 40, 24, 16
    x = _t(rng.standard_normal((E, d, C) if x_t else (E, C, d)).astype(np.float32))
    w = _t(rng.standard_normal((E, f, d) if w_t else (E, d, f)).astype(np.float32))
    gy = _t(rng.standard_normal((E, C, f)).astype(np.float32))
    calls = []

    def gemm(a, b, a_t, b_t):
        calls.append((a.data_ptr(), b.data_ptr(), a.is_contiguous() and b.is_contiguous()))
        return ref.moe_gemm(a, b, x_t=a_t, w_t=b_t)

    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = mg.MoeGemmFn.apply(xs, ws, x_t, w_t, gemm)
    gx, gw = torch.autograd.grad(y, (xs, ws), gy)
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    yp = ref.moe_gemm(xp, wp, x_t=x_t, w_t=w_t)
    ex, ew = torch.autograd.grad(yp, (xp, wp), gy)
    assert y.shape == (E, C, f) and gx.shape == x.shape and gw.shape == w.shape
    for got, exp in ((y, yp), (gx, ex), (gw, ew)):
        np.testing.assert_allclose(got.detach().numpy(), exp.detach().numpy(), atol=1e-5, rtol=1e-5)
    # three products, each on the saved operands and the incoming gradient as stored
    stored = {xs.data_ptr(), ws.data_ptr(), gy.data_ptr()}
    assert len(calls) == 3 and all(a in stored and b in stored and c for a, b, c in calls)
    # the wrapper hands a CPU tensor and its layout to the plain version
    np.testing.assert_allclose(mg.moe_gemm(x, w, x_t=x_t, w_t=w_t).numpy(), yp.detach().numpy(),
                               atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.mark.parametrize("n_tokens,block", [(4, 8), (32, 8), (4096, 128), (1000, 16)])
def test_capacity_matches_jax(cfgs, n_tokens, block):
    jcfg, cfg = cfgs
    full_j, full_t = jax_get_config(ARCH), get_config(ARCH)
    assert moe.capacity(n_tokens, cfg, block) == jmoe.capacity(n_tokens, jcfg, block)
    assert moe.capacity(n_tokens, full_t, block) == jmoe.capacity(n_tokens, full_j, block)
    assert moe.capacity(4096, full_t, 128) == 1280 and moe.capacity(4, full_t, 8) == 8


def _moe_case(jcfg, biased: bool):
    """JAX-initialised MoE weights and an input; with ``biased``, one input
    feature and two router rows push every token to experts 0 and 1."""
    jp = jmoe.init(jcfg, jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    if biased:
        x[..., 0] = 5.0
        router = np.array(jp["router"])
        router[0, 0], router[0, 1] = 3.0, 2.5
        jp = {**jp, "router": jnp.asarray(router)}
    return jp, x


def _jax_bookkeeping(jp, jcfg, x, C):
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    grouped, (se, st, sw, keep, pos) = jmoe._local_route_group(
        xt, jp["router"], jcfg.experts_per_token, jcfg.n_experts, C, xt.dtype)
    return grouped, se, st, sw, keep, pos


@pytest.mark.parametrize("biased", [False, True], ids=["no_drops", "drops"])
@pytest.mark.parametrize("moe_block_c", [128, 16])
def test_moe_forward_matches_jax(cfgs, biased, moe_block_c):
    jcfg, cfg = cfgs
    jp, x = _moe_case(jcfg, biased)
    p = _tree(jp)
    jtiles = jops.KernelTiles(moe_block_c=moe_block_c)
    tiles = ops.KernelTiles(moe_block_c=moe_block_c)
    T = B * S
    C = moe.capacity(T, cfg, block=moe_block_c if T >= moe_block_c else 8)

    # routing and dispatch bookkeeping: equal, not close
    jgrouped, *jbook = _jax_bookkeeping(jp, jcfg, x, C)
    xt = _t(x).reshape(T, -1)
    _, topw, topi = moe.route(p, cfg, xt)
    jprobs = jax.nn.softmax(jnp.asarray(xt.numpy()) @ jp["router"], axis=-1)
    jtopw, jtopi = jax.lax.top_k(jprobs, cfg.experts_per_token)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_allclose(topw.numpy(), np.asarray(jtopw / jtopw.sum(-1, keepdims=True)),
                               rtol=1e-5)
    book = moe.dispatch(topi, topw, cfg.n_experts, C)
    for name, got, exp in zip(("se", "st", "sw", "keep", "pos"), book, jbook):
        if name == "sw":
            np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(exp), err_msg=name)
    # the biased router sends all T tokens to experts 0 and 1
    assert (~book[3]).sum().item() == (2 * max(0, T - C) if biased else 0)

    # a dropped pair adds 0 to slot 0 of its expert: the buffer equals JAX's
    grouped = moe.group(xt, book[0], book[1], book[3], book[4], cfg.n_experts, C)
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(jgrouped))

    exp = jmoe.forward(jp, jcfg, jnp.asarray(x), tiles=jtiles, shard=lambda a, _: a)
    mg.LAUNCHES.reset()
    got = moe.forward(p, cfg, _t(x), tiles=tiles)
    assert mg.LAUNCHES.count == 0
    assert got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=1e-5)


def test_dispatch_sort_is_stable():
    # equal experts keep their token order, so a token's slot is its rank
    topi = torch.tensor([[1, 0], [1, 2], [0, 1], [1, 0]])
    topw = torch.full((4, 2), 0.5)
    se, st, _, keep, pos = moe.dispatch(topi, topw, 3, 2)
    assert se.tolist() == [0, 0, 0, 1, 1, 1, 1, 2]
    assert st.tolist() == [0, 2, 3, 0, 1, 2, 3, 1]
    assert pos.tolist() == [0, 1, 0, 0, 1, 0, 0, 0]
    assert keep.tolist() == [True, True, False, True, True, False, False, True]


def _dispatch_by_bincount(topi, topw, E, C):
    """``moe.dispatch`` as it counted each expert's pairs before: ``torch.bincount``."""
    T, k = topi.shape
    flat_e = topi.reshape(-1)
    flat_t = torch.arange(T).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], topw.reshape(-1)[order]
    counts = torch.bincount(flat_e, minlength=E)
    pos = torch.arange(T * k) - (torch.cumsum(counts, 0) - counts)[se]
    keep = pos < C
    return se, st, sw, keep, torch.where(keep, pos, 0)


def _routing(case: str, T: int, k: int, E: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(7)
    if case == "one_expert":  # every pair to expert 3: most past capacity
        return torch.full((T, k), 3)
    if case == "idle_experts":  # experts 2, 5 and every odd one above 8 get no pair
        used = torch.tensor([0, 1, 3, 4, 6, 8, 10, 12])
        return used[torch.rand(T, used.numel(), generator=gen).argsort(-1)[:, :k]]
    # distinct experts a token, as top-k gives them
    return torch.rand(T, E, generator=gen).argsort(-1)[:, :k]


@pytest.mark.parametrize("case,T,k,E,C,drops", [
    ("random", 32, 8, 32, 16, False),
    ("random", 48, 2, 16, 16, False),  # jamba's top-2 of 16
    ("random", 64, 8, 16, 8, True),  # pairs past capacity
    ("one_expert", 16, 1, 8, 8, True),
    ("idle_experts", 40, 4, 16, 8, True),
])
def test_dispatch_counts_equal_bincount_bit_for_bit(case, T, k, E, C, drops):
    topi = _routing(case, T, k, E)
    topw = torch.rand(T, k, generator=torch.Generator().manual_seed(1))
    got = moe.dispatch(topi, topw, E, C)
    want = _dispatch_by_bincount(topi, topw, E, C)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool((~got[3]).any()) == drops  # pairs past capacity, dropped to slot 0
    if case == "idle_experts":
        assert torch.bincount(topi.reshape(-1), minlength=E)[[2, 5, 7, 9]].eq(0).all()


def test_aux_loss_matches_jax(cfgs):
    jcfg, cfg = cfgs
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((24, cfg.n_experts)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    topi = np.argsort(-probs, axis=-1)[:, : cfg.experts_per_token]
    exp = jmoe.aux_loss(jnp.asarray(probs), jnp.asarray(topi), cfg.n_experts)
    got = moe.aux_loss(_t(probs), _t(topi), cfg.n_experts)
    np.testing.assert_allclose(got.item(), float(exp), rtol=1e-6)


def test_init_layout_and_dtypes_match_jax(cfgs):
    jcfg, cfg = cfgs
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    jp = jmoe.init(dataclasses.replace(jcfg, dtype="bfloat16"), jax.random.PRNGKey(0))
    p = moe.init(bf, torch.Generator().manual_seed(0), "cpu", n_periods=2)
    assert p.keys() == jp.keys()
    for k in p:
        assert tuple(p[k].shape) == (2,) + tuple(jp[k].shape)
        assert str(p[k].dtype).split(".")[1] == jp[k].dtype.name


def test_expert_parallel_path_raises_naming_its_item(cfgs):
    """The expert-parallel path, which raised naming A8 before it was ported,
    now runs: on a (1, 2) gloo mesh (two experts a rank) its forward and
    gradients equal the one-device path's within 5e-3 in relative norm (the
    EP combine is rounded to bf16, as in the JAX package)."""
    _, cfg = cfgs
    rng = np.random.default_rng(3)
    p = {k: v.numpy() for k, v in moe.init(cfg, torch.Generator().manual_seed(0), "cpu").items()}
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    got = run_on_mesh(MeshSpec(("data", "model"), (1, 2)), dist_cases.ep_cases,
                      [dict(arch=ARCH, act=cfg.act, fsdp=False, p=p, x=x, r=r)], device="cpu")[0][0]
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    tiles = dataclasses.replace(ops.DEFAULT_TILES, moe_block_c=8)  # EP's capacity block
    y = moe.forward(tp, cfg, tx, tiles=tiles)
    (y * torch.from_numpy(r)).sum().backward()

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    assert rel(got["y"], y.detach()) < 5e-3 and rel(got["dx"], tx.grad) < 5e-3
    for k, t in tp.items():
        assert rel(got["grads"][k], t.grad) < 5e-3, k

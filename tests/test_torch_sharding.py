"""The port's sharding layer on the CPU against the JAX package's.

* ``ShardingRules``, spec for spec, against ``repro.sharding.rules`` for all
  ten archs over a grid of plans and six meshes (the TPU pods, the H100
  node and two-node meshes, (4, 2) and (2, 2)): every parameter, the
  optimizer state (f32 and int8 moments), every activation name, the batch
  and the bf16 and int8 caches.  Parameter shapes come from
  ``jax.eval_shape`` (nothing allocated at full width); a JAX
  ``PartitionSpec`` is compared as a tuple.
* The int8 error-feedback ring over a 4-rank gloo group against the
  reference's ``compressed_psum`` under ``jax.vmap``, within 8 f32 ulps of
  the largest value (not bit for bit: XLA fuses each hop's dequantize into
  its add, one rounding; the port's dequantize rounds the product first).
* The expert-parallel MoE on a (2, 2) gloo mesh against the reference's
  ``_forward_ep_shard_map`` on four forced host devices (run once in a
  subprocess, saved to ``.npz``), forward and gradients, with dropped pairs,
  swiglu and gelu, with and without FSDP; and against the port's one-device
  forward.
"""
import dataclasses
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.core.space import MeshSpec as JaxMeshSpec
from repro.core.space import SchedulePlan as JaxPlan
from repro.models import transformer as jtf
from repro.sharding.rules import ShardingRules as JaxRules
from repro.training import optimizer as joptim
from repro.training.grad_compress import compressed_psum as jax_compressed_psum
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.space import (
    H100_NODE, H100_TWO_NODES, MULTI_POD, SINGLE_POD, MeshSpec, SchedulePlan,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as ttf
from repro_torch.sharding.rules import PartitionSpec, ShardingRules
from repro_torch.training import optimizer as optim

import torch_dist_cases as cases

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {
    "single_pod": SINGLE_POD, "multi_pod": MULTI_POD, "h100_node": H100_NODE,
    "h100_two_nodes": H100_TWO_NODES, "4x2": MeshSpec(("data", "model"), (4, 2)),
    "2x2": MeshSpec(("data", "model"), (2, 2)),
}
PLANS = [
    dict(param_strategy=ps, mixer_tp=mt, ffn_tp=ft, vocab_shard=vs, moe_mode=mm, batch_axes=ba,
         seq_shard=ss)
    for ps, mt, ft, vs, mm, ba, ss in itertools.product(
        ("replicated", "tp", "fsdp", "fsdp_tp"), (False, True), (False, True), (False, True),
        ("ep", "tp", "dense"), ("data", "pod_data"), (False, True))
]


def _tup(tree):
    """A tree of specs with every spec (JAX's or the port's) as a plain tuple."""
    if isinstance(tree, dict):
        return {k: _tup(v) for k, v in tree.items()}
    return None if tree is None else tuple(tree)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict) else torch.empty(v, device="meta")
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch_shapes(request):
    arch = request.param
    jcfg = jax_get_config(arch)
    jp = jax.eval_shape(lambda k: jtf.init_params(jcfg, k), jax.random.PRNGKey(0))
    jopt = {dt: jax.eval_shape(lambda p: joptim.init_opt_state(
        p, joptim.OptimizerConfig(moment_dtype=dt)), jp) for dt in ("float32", "int8")}
    jcache = {kv: jax.eval_shape(lambda: jtf.init_cache(jcfg, 16, 64, kv_dtype=kv))
              for kv in ("bf16", "int8")}
    shape = jax_get_shape("train_4k")
    return arch, jcfg, jp, jopt, jcache, shape


def test_param_shapes_match_jax_eval_shape(arch_shapes):
    arch, _, jp, *_ = arch_shapes
    assert ttf.param_shapes(get_config(arch)) == _shapes(jp)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_match_jax_spec_for_spec(arch_shapes, mesh_name):
    arch, jcfg, jp, jopt, jcache, jshape = arch_shapes
    cfg, spec = get_config(arch), MESHES[mesh_name]
    jmesh = JaxMeshSpec(spec.names, spec.shape)
    shapes = _shapes(jp)
    opt = {dt: optim.init_opt_state(_meta(shapes), optim.OptimizerConfig(moment_dtype=dt))
           for dt in ("float32", "int8")}
    caches = {kv: _shapes(jcache[kv]) for kv in jcache}
    d, S, B = cfg.d_model, 64, 16
    act_shapes = {
        "act_btd": (B, S, d), "act_bhsd": (B, max(cfg.n_heads, 1), S, 64),
        "act_bkvsd": (B, max(cfg.n_kv_heads, 1), S, 64), "act_btf": (B, S, max(cfg.d_ff, 8)),
        "act_bti": (B, S, max(2 * cfg.d_inner, 8)), "moe_ecd": (max(cfg.n_experts, 8), 32, d),
        "moe_ecf": (max(cfg.n_experts, 8), 32, max(cfg.d_ff, 8)), "logits": (B, S, cfg.vocab_size),
        "kv_cache": (B, max(cfg.n_kv_heads, 1), S, 64), "unknown": (B,),
    }
    seen = set()
    for kw in PLANS:
        j = JaxRules(jcfg, jshape, JaxPlan(**kw), jmesh)
        p = ShardingRules(cfg, jshape, SchedulePlan(**kw), spec)
        key = (j.batch, j.tp_mixer, j.tp_ffn, j.tp_vocab, j.fsdp_axes, j.moe_mode, kw["seq_shard"])
        assert key == (p.batch, p.tp_mixer, p.tp_ffn, p.tp_vocab, p.fsdp_axes, p.moe_mode,
                       kw["seq_shard"])
        if key in seen:  # the rest depends on these alone
            continue
        seen.add(key)
        jspecs = j.param_pspecs(jp)
        pspecs = p.param_pspecs(shapes)
        assert _tup(pspecs) == _tup(jspecs), kw
        assert all(isinstance(s, PartitionSpec) for _, s in optim.leaves(pspecs))
        for dt in ("float32", "int8"):
            assert _tup(optim.opt_state_pspecs(opt[dt], pspecs)) == _tup(
                joptim.opt_state_pspecs(jopt[dt], jspecs)), (kw, dt)
        for name, shp in act_shapes.items():
            assert _tup(p.act_spec(name, len(shp), shp)) == _tup(j.act_spec(name, len(shp), shp))
        for nd in (2, 3):
            assert tuple(p.batch_spec(nd)) == tuple(j.batch_spec(nd))
            assert tuple(p.batch_spec(nd, 1)) == tuple(j.batch_spec(nd, 1))
        for kv in caches:
            assert _tup(p.cache_pspecs(caches[kv])) == _tup(j.cache_pspecs(jcache[kv])), (kw, kv)
    assert len(seen) > 4


# ---------------------------------------------------------------------------
# The int8 ring
# ---------------------------------------------------------------------------
RING_STEPS = 8


@pytest.fixture(scope="module")
def ring():
    xs = np.random.default_rng(0).standard_normal((4, 33, 130)).astype(np.float32)
    got = run_on_mesh(MeshSpec(("data", "model"), (4, 1)), cases.ring_cases, xs, RING_STEPS, "data",
                      device="cpu")
    red, err = jax.vmap(lambda x: jax_compressed_psum(x, "data"), axis_name="data")(jnp.asarray(xs))
    step = jax.jit(jax.vmap(lambda x, e: jax_compressed_psum(x, "data", error=e), axis_name="data"))
    e, fed = jnp.zeros_like(xs), []
    for _ in range(RING_STEPS):
        r, e = step(jnp.asarray(xs), e)
        fed.append(np.asarray(r))
    return xs, got, np.asarray(red), np.asarray(err), np.stack(fed, 1), np.asarray(e)


def test_ring_matches_the_reference(ring):
    """The same arithmetic in the same order, but not bit for bit: in the
    reference's compiled loop body XLA fuses ``q * s + local`` into one
    rounding, where the port's dequantize (a kernel of its own on the card)
    rounds ``q * s`` first, so each hop may differ by an f32 ulp.  Held
    within 8 ulps of the largest reduced value (3.8e-6 here; the largest
    difference seen is 4 ulps, and no int8 code differs), without error
    feedback and with it at every one of 8 steps."""
    xs, got, red, err, fed, last_err = ring
    tol = dict(rtol=0, atol=8 * float(np.spacing(np.float32(np.abs(fed).max()))))
    for i in range(4):
        np.testing.assert_allclose(got[i]["plain"].numpy(), red[i], **tol)
        np.testing.assert_allclose(got[i]["first_err"].numpy(), err[i], **tol)
        np.testing.assert_allclose(got[i]["fed"].numpy(), fed[i], **tol)
        np.testing.assert_allclose(got[i]["last_err"].numpy(), last_err[i], **tol)


def test_ring_is_close_to_the_sum_and_feedback_removes_the_bias(ring):
    """The reference tests' bounds: within 5 % of the true sum, and with
    error feedback the 8 steps' total within 1 %."""
    xs, got, *_ = ring
    true = xs.sum(0)
    for i in range(4):
        rel = np.abs(got[i]["plain"].numpy() - true).max() / np.abs(true).max()
        assert rel < 0.05, rel
    acc = got[0]["fed"].numpy().sum(0)
    rel = np.linalg.norm(acc - RING_STEPS * true) / np.linalg.norm(RING_STEPS * true)
    assert rel < 0.01, rel


# ---------------------------------------------------------------------------
# Expert parallelism against the reference's shard_map path
# ---------------------------------------------------------------------------
EP_B, EP_S = 4, 16  # 32 tokens a data rank: capacity(32, block=8) = 24 < 32

EP_REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.kernels.ops import DEFAULT_TILES
from repro.models import moe
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {{}}
for name, act, fsdp, bias in {cases!r}:
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), act=act)
    key = jax.random.PRNGKey(len(out))
    p = moe.init(cfg, key)
    rng = np.random.default_rng(len(out))
    x = rng.standard_normal(({B}, {S}, cfg.d_model)).astype(np.float32)
    if bias:  # one expert wins for most tokens: pairs past the capacity drop
        x[..., 0] = np.abs(x[..., 0]) + 2.0
        p["router"] = p["router"].at[0, 0].add(8.0)
    r = rng.standard_normal(x.shape).astype(np.float32)
    dist = moe.MoEDist(mesh=mesh, fsdp=fsdp)
    def f(p, x):
        y = moe.forward(p, cfg, x, tiles=DEFAULT_TILES, shard=lambda a, n: a, dist=dist)
        return jnp.sum(y * r), y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    out[name + ".x"], out[name + ".r"], out[name + ".y"], out[name + ".dx"] = x, r, y, gx
    for k in p:
        out[name + ".p." + k] = np.asarray(p[k])
        out[name + ".g." + k] = np.asarray(gp[k])
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
"""
EP_CASES = [("swiglu_drop", "swiglu", True, True), ("swiglu", "swiglu", False, False),
            ("gelu_drop", "gelu", False, True)]


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ep") / "ref.npz")
    code = EP_REFERENCE.format(src=os.path.join(ROOT, "src"), cases=EP_CASES, B=EP_B, S=EP_S,
                               path=path)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.load(path)
    ref = {name: {"x": ref[f"{name}.x"], "r": ref[f"{name}.r"], "y": ref[f"{name}.y"],
                  "dx": ref[f"{name}.dx"],
                  "p": {k.split(".")[-1]: ref[k] for k in ref.files if k.startswith(f"{name}.p.")},
                  "g": {k.split(".")[-1]: ref[k] for k in ref.files if k.startswith(f"{name}.g.")}}
           for name, *_ in EP_CASES}
    work = [dict(arch="granite-moe-1b-a400m", act=act, fsdp=fsdp, p=ref[name]["p"],
                 x=ref[name]["x"], r=ref[name]["r"]) for name, act, fsdp, _ in EP_CASES]
    got = run_on_mesh(MeshSpec(("data", "model"), (2, 2)), cases.ep_cases, work, device="cpu")
    return ref, got


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


# the combine is rounded to bf16 before its all-reduce, in both: a flipped
# rounding moves an element by one bf16 step of ~2**-8 relative
EP_REL = 5e-3


@pytest.mark.parametrize("i", range(len(EP_CASES)), ids=[c[0] for c in EP_CASES])
def test_expert_parallel_forward_and_grads_match_the_reference(ep, i):
    ref, got = ep
    name, act, fsdp, bias = EP_CASES[i]
    r, g = ref[name], got[0][i]
    assert _rel(g["y"].numpy(), r["y"]) < EP_REL
    assert _rel(g["dx"].numpy(), r["dx"]) < EP_REL
    for k in r["g"]:
        assert _rel(g["grads"][k].numpy(), r["g"][k]) < EP_REL, k
    # each rank holds its E/2 experts, and d_ff/2 of them under FSDP
    E, f = r["p"]["w_up"].shape[0], r["p"]["w_up"].shape[2]
    for rank in got:
        assert rank[i]["local"]["w_up"] == (E // 2, r["p"]["w_up"].shape[1], f // 2 if fsdp else f)
        assert rank[i]["local"]["router"] == r["p"]["router"].shape


@pytest.mark.parametrize("i", range(len(EP_CASES)), ids=[c[0] for c in EP_CASES])
def test_expert_parallel_matches_the_one_device_forward(ep, i):
    """The port's EP against its own one-device path on each data rank's rows
    (the dispatch is local to a data rank, at the reference's capacity)."""
    ref, got = ep
    name, act, *_ = EP_CASES[i]
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), act=act)
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in ref[name]["p"].items()}
    x = torch.from_numpy(ref[name]["x"].copy()).requires_grad_(True)
    tiles = dataclasses.replace(ops.DEFAULT_TILES, moe_block_c=8)  # the EP path's capacity block
    y = torch.cat([moe.forward(p, cfg, x[h * 2:(h + 1) * 2], tiles=tiles) for h in range(2)])
    (y * torch.from_numpy(ref[name]["r"])).sum().backward()
    g = got[0][i]
    assert _rel(g["y"].numpy(), y.detach().numpy()) < EP_REL
    assert _rel(g["dx"].numpy(), x.grad.numpy()) < EP_REL
    for k, t in p.items():
        assert _rel(g["grads"][k].numpy(), t.grad.numpy()) < EP_REL, k


def test_biased_ep_cases_drop_pairs(ep):
    """The biased cases overflow an expert at the EP capacity on each data
    rank, so the drop path is what they compare; the others drop none."""
    ref, _ = ep
    for name, act, fsdp, bias in EP_CASES:
        cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), act=act)
        T = EP_B // 2 * EP_S
        C = moe.capacity(T, cfg, block=8)
        for h in range(2):
            xt = torch.from_numpy(ref[name]["x"][h * 2:(h + 1) * 2].reshape(T, -1))
            _, topw, topi = moe.route({"router": torch.from_numpy(ref[name]["p"]["router"])}, cfg, xt)
            keep = moe.dispatch(topi, topw, cfg.n_experts, C)[3]
            assert bool(keep.all()) != bias, (name, h)

"""The port's decode step over CPU gloo meshes.

``make_serve_step(mesh=...)`` runs each rank's shard of the cache
(``ShardingRules.cache_pspecs``): KV heads split over ``model`` (or whole
where the rules cannot split them), positions split over ``model`` or over
the whole mesh (batch-1 long context) with the partial softmaxes combined
explicitly, Mamba's conv window and state by ``d_inner``, rows over the
batch axes, ``tp2d``'s gather-on-use weights, the MoE modes and
vocab-parallel logits.  Every case starts from one whole cache (random
K/V, int8 codes and scales, conv windows and states, drawn with numpy)
sharded onto the mesh, and is teacher-forced: both sides take the same
tokens, per-row positions that cross a shard boundary, and a ``commit``
mask that leaves a row out.

Against the port's one-process step on the same weights (for
granite-3-2b the JAX package's ``init_params``, carried across): every rank's logits at every
step within ``TOL`` (rtol 1e-4, atol 1e-4, the bound of
``tests/test_torch_models.py``), and the cache gathered after the last
step within ``TOL``; an int8 cache's codes and scales equal in the first
period, and after it (whose new rows come from a residual stream summed in
another order) scales within 1e-6 relative (5e-3 under expert
parallelism, whose combine is rounded to bf16 as in the reference) and
codes within one step.  Each rank holds the
local shapes the rules give, and ``init_cache(par=...)`` allocates those
and no more.  One case is held to the JAX package's one-device
``decode_step``, and one (a sequence-split int8 cache) to its sharded
``make_serve_step`` on four forced host devices in a subprocess.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import InputShape, get_config
from repro_torch.core.space import MeshSpec, SchedulePlan
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import transformer as ttf
from repro_torch.sharding.parallel import local_shape
from repro_torch.sharding.rules import ShardingRules
from repro_torch.training.train_step import make_serve_step

import torch_dist_cases as dc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
L, STEPS = 16, 4
ARCHS = ("granite-3-2b", "granite-moe-1b-a400m", "falcon-mamba-7b", "jamba-1.5-large-398b")
# per-row starting positions: over 4 position shards of 4, each row crosses
# a boundary (4) within the four steps
START = (3, 2, 1, 3)
LEAVE_OUT = (True, False, True, True)  # commit: row 1 writes nothing

HEADS = dict(param_strategy="tp", mixer_tp=True)
SEQ = dict(param_strategy="replicated", seq_shard=True)
# (name, mesh shape, arch, plan, kv_dtype, B, commit mask)
CASES = [
    ("heads_1x2", (1, 2), "granite-3-2b", HEADS, "bf16", 4, LEAVE_OUT),  # 2 KV heads over 2
    ("heads_1x4", (1, 4), "granite-3-2b", HEADS, "bf16", 4, None),  # 2 KV heads over 4: whole cache
    ("seq_1x4", (1, 4), "granite-3-2b", SEQ, "bf16", 4, LEAVE_OUT),
    ("seq_int8_1x4", (1, 4), "granite-3-2b", SEQ, "int8", 4, LEAVE_OUT),
    ("seq_int8_all_1x4", (1, 4), "granite-3-2b", SEQ, "int8", 4, None),  # held to JAX's sharded step
    # q heads split, positions split over model: every rank attends with every head
    ("heads_seq_1x4", (1, 4), "granite-3-2b", {**HEADS, "seq_shard": True}, "int8", 4, LEAVE_OUT),
    ("moe_tp_1x4", (1, 4), "granite-moe-1b-a400m",
     dict(HEADS, ffn_tp=True, moe_mode="tp", vocab_shard=True, seq_shard=True), "bf16", 4, LEAVE_OUT),
    ("mamba_1x4", (1, 4), "falcon-mamba-7b",
     dict(HEADS, vocab_shard=True, seq_shard=True), "bf16", 4, LEAVE_OUT),
    ("jamba_1x4", (1, 4), "jamba-1.5-large-398b",
     dict(HEADS, ffn_tp=True, seq_shard=True, moe_mode="ep"), "bf16", 4, LEAVE_OUT),
    # the search's granite-moe decode plan: tp2d weights gathered over data, EP, int8 KV
    ("moe_tp2d_ep_2x2", (2, 2), "granite-moe-1b-a400m",
     dict(param_strategy="tp2d", mixer_tp=True, ffn_tp=True, seq_shard=True, moe_mode="ep"),
     "int8", 4, LEAVE_OUT),
    ("batch1_2x2", (2, 2), "granite-3-2b", SEQ, "int8", 1, None),  # positions over the whole mesh
]
NAMES = [c[0] for c in CASES]


def _start_cache(cfg, B: int, kv_dtype: str, rng) -> dict:
    """A whole starting cache: every position and state drawn with numpy."""
    tmpl = ttf.init_cache(cfg, B, L, kv_dtype, device="cpu")
    out = {}
    for b, c in tmpl.items():
        out[b] = {}
        for k, v in c.items():
            shape = tuple(v.shape)
            if v.dtype == torch.int8:
                a = rng.integers(-127, 128, shape).astype(np.int8)
            elif k in ("k_s", "v_s"):
                a = rng.uniform(0.01, 0.05, shape).astype(np.float32)
            else:
                a = (rng.standard_normal(shape) * (0.1 if k == "ssm" else 0.5)).astype(np.float32)
            out[b][k] = a
    return out


def _work(i: int, name, arch, plan, kv_dtype, B, commit) -> dict:
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(100 + i)
    start = np.array(START[:B]) if B > 1 else np.array(2)
    return dict(name=name, arch=arch, plan=plan, kv_dtype=kv_dtype, B=B, L=L,
                cache=_start_cache(cfg, B, kv_dtype, rng),
                tokens=[rng.integers(0, cfg.vocab_size, (B,)) for _ in range(STEPS)],
                cur=[start + t for t in range(STEPS)],
                commit=[None if commit is None else np.array(commit[:B]) for _ in range(STEPS)])


@pytest.fixture(scope="module")
def trees():
    """Whole weights as numpy: the JAX package's ``init_params`` for
    granite-3-2b (the cases held to the JAX steps), the port's seeded ones
    for the others."""
    out = {"granite-3-2b": jax.tree.map(np.asarray, jtf.init_params(
        jax_get_config("granite-3-2b").reduced(), jax.random.PRNGKey(0)))}
    for arch in ARCHS[1:]:
        params = ttf.init_params(get_config(arch).reduced(), 0, device="cpu")
        out[arch] = jax.tree.map(lambda t: t.numpy(), params)
    return out


@pytest.fixture(scope="module")
def work():
    return [_work(i, c[0], *c[2:]) for i, c in enumerate(CASES)]


@pytest.fixture(scope="module")
def meshes(trees, work):
    """One spawn a mesh shape, through all of its cases: per case, every
    rank's result."""
    out = {}
    for shape in sorted({c[1] for c in CASES}):
        idx = [i for i, c in enumerate(CASES) if c[1] == shape]
        ranks = run_on_mesh(MeshSpec(("data", "model"), shape), dc.decode_cases,
                            [work[i] for i in idx], trees, device="cpu")
        for j, i in enumerate(idx):
            out[CASES[i][0]] = [r[j] for r in ranks]
    return out


def _cfg(w):
    cfg = get_config(w["arch"]).reduced()
    return dataclasses.replace(cfg, dtype=w["dtype"]) if w.get("dtype") else cfg


def _one_process(w, trees):
    """The port's one-process serve step from the same whole cache (drawn in
    f32, held in the model cache's dtypes): every step's logits and the cache
    after the last."""
    cfg = _cfg(w)
    plan = SchedulePlan(**w["plan"], kv_dtype=w["kv_dtype"])
    params = convert.params_from_numpy(trees[w.get("tree", w["arch"])], cfg, device="cpu")
    tmpl = ttf.init_cache(cfg, w["B"], w["L"], w["kv_dtype"], device="cpu")
    cache = {b: {k: torch.from_numpy(v.copy()).to(tmpl[b][k].dtype) for k, v in c.items()}
             for b, c in w["cache"].items()}
    step = make_serve_step(cfg, None, plan, device="cpu")
    logits = []
    for tok, cur, commit in zip(w["tokens"], w["cur"], w["commit"]):
        lg, cache = step(params, cache, torch.from_numpy(tok)[:, None], torch.as_tensor(cur),
                         None if commit is None else torch.from_numpy(commit))
        logits.append(lg)
    return torch.stack(logits), cache


class _Sizes:
    """Enough of a mesh for ``local_shape``."""

    def __init__(self, spec):
        self.spec = spec

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.spec.axis(a) for a in axes]))


@pytest.mark.parametrize("i", range(len(CASES)), ids=NAMES)
def test_mesh_decode_matches_one_process(meshes, trees, work, i):
    name = CASES[i][0]
    exp_logits, exp_cache = _one_process(work[i], trees)
    ranks = meshes[name]
    for r, rank in enumerate(ranks):
        assert rank["logits"].shape == exp_logits.shape, r
        np.testing.assert_allclose(rank["logits"].numpy(), exp_logits.numpy(), **TOL,
                                   err_msg=f"{name} rank {r}")
    got = ranks[0]["cache"]
    # expert parallelism rounds its combine to bf16 before the sum over
    # model, as the reference does (``tests/test_torch_sharding.py``'s EP_REL)
    scale_rtol = 5e-3 if CASES[i][3].get("moe_mode") == "ep" else 1e-6
    for b, c in exp_cache.items():
        for k, v in c.items():
            g = got[b][k]
            if v.dtype == torch.int8 or k in ("k_s", "v_s"):
                # the first period's new rows come from the embedding alone:
                # equal; a later period's from a residual stream whose
                # softmax or TP sums were added in another order, so its
                # scale (amax / 127) is within f32 rounding and a code
                # within one step
                assert torch.equal(g[0], v[0]), (name, b, k)
                if v.dtype == torch.int8:
                    assert int((g.int() - v.int()).abs().max()) <= 1, (name, b, k)
                else:
                    np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=scale_rtol,
                                               err_msg=f"{name} {b}.{k}")
            else:
                np.testing.assert_allclose(g.numpy(), v.numpy(), **TOL, err_msg=f"{name} {b}.{k}")


@pytest.mark.parametrize("i", range(len(CASES)), ids=NAMES)
def test_each_rank_holds_the_cache_shard_the_rules_give(meshes, work, i):
    """The shard of the whole cache and ``init_cache(par=...)``'s
    allocation both have the rules' local shapes (a leaf the rules split is
    never whole on a rank)."""
    name, shape, arch, plan, kv_dtype, B, _ = CASES[i]
    cfg = get_config(arch).reduced()
    spec = MeshSpec(("data", "model"), shape)
    rules = ShardingRules(cfg, InputShape("decode", L, B, "decode"),
                          SchedulePlan(**plan, kv_dtype=kv_dtype), spec)
    whole = ttf.init_cache(cfg, B, L, kv_dtype, device="cpu")
    specs = rules.cache_pspecs(whole)
    exp = {f"{b}.{k}": local_shape(tuple(v.shape), specs[b][k], _Sizes(spec))
           for b, c in whole.items() for k, v in c.items()}
    for rank in meshes[name]:
        assert rank["local"] == exp and rank["alloc"] == exp


def test_the_cases_run_the_layouts_they_claim(meshes):
    kv = {n: meshes[n][0]["kv"] for n in NAMES}
    assert kv["heads_1x2"] == ("data", "model", None, None)
    assert kv["heads_1x4"] == ("data", None, None, None)  # 2 KV heads do not split over 4
    assert kv["seq_1x4"] == ("data", None, "model", None)
    assert kv["heads_seq_1x4"] == ("data", None, "model", None)
    assert kv["moe_tp2d_ep_2x2"] == ("data", "model", None, None)
    assert kv["batch1_2x2"] == (None, None, ("data", "model"), None)
    assert not meshes["batch1_2x2"][0]["rows_split"] and meshes["moe_tp2d_ep_2x2"][0]["rows_split"]


def test_mesh_decode_matches_the_jax_one_device_decode_step(meshes, trees, work):
    """The head-split case against the JAX package's ``decode_step`` from
    the same weights and whole starting cache."""
    i = NAMES.index("heads_1x4")
    w = work[i]
    jcfg = jax_get_config(w["arch"]).reduced()
    jparams = jax.tree.map(jnp.asarray, trees[w["arch"]])
    cache = jax.tree.map(jnp.asarray, w["cache"])
    for t, (tok, cur) in enumerate(zip(w["tokens"], w["cur"])):
        jl, cache = jtf.decode_step(jparams, jcfg, cache, jnp.asarray(tok, jnp.int32)[:, None],
                                    jnp.asarray(cur, jnp.int32))
        for rank in meshes["heads_1x4"]:
            np.testing.assert_allclose(rank["logits"][t].numpy(), np.asarray(jl), **TOL)


JAX_SHARDED = """
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {src!r})
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core.space import MeshSpec, SchedulePlan
from repro.launch.mesh import make_mesh_from_spec
from repro.models import transformer
from repro.sharding.rules import ShardingRules
from repro.training.train_step import make_serve_step
d = np.load({inp!r}, allow_pickle=True).item()
cfg = get_config(d["arch"]).reduced()
if d.get("dtype"):  # the model's dtype (the reduced configs are f32)
    cfg = dataclasses.replace(cfg, dtype=d["dtype"])
spec = MeshSpec(("data", "model"), (1, 4))
mesh = make_mesh_from_spec(spec)
shape = InputShape("decode", d["L"], d["B"], "decode")
plan = SchedulePlan(**d["plan"], kv_dtype=d["kv_dtype"])
rules = ShardingRules(cfg, shape, plan, spec)
ns = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                               is_leaf=lambda x: isinstance(x, PartitionSpec))
params = jax.tree.map(jnp.asarray, d["params"])
# the whole cache, drawn in f32, in the dtypes the model's cache holds
tmpl = transformer.init_cache(cfg, d["B"], d["L"], d["kv_dtype"])
cache = jax.tree.map(lambda a, t: jnp.asarray(a, t.dtype), d["cache"], tmpl)
step = jax.jit(make_serve_step(cfg, shape, plan, mesh, spec),
               in_shardings=(ns(rules.param_pspecs(params)), ns(rules.cache_pspecs(cache)),
                             NamedSharding(mesh, rules.batch_spec(2)), NamedSharding(mesh, PartitionSpec())),
               out_shardings=(None, ns(rules.cache_pspecs(cache))))
logits = []
for tok, cur in zip(d["tokens"], d["cur"]):
    lg, cache = step(params, cache, jnp.asarray(tok, jnp.int32)[:, None], jnp.asarray(cur, jnp.int32))
    logits.append(np.asarray(lg))
# what ran: the model and the plan the rules were built for
out = {{"logits": np.stack(logits).astype(np.float32), "cfg_name": cfg.name, "cfg_dtype": cfg.dtype,
        "n_experts": cfg.n_experts, "moe_mode": plan.moe_mode}}
for b, c in cache.items():
    for k, v in c.items():
        out[b + "." + k] = np.asarray(v, np.float32 if v.dtype == jnp.bfloat16 else v.dtype)
np.savez({out!r}, **out)
"""


def _jax_sharded(w, tree, tmp_path, dtype=None) -> dict:
    """The JAX package's ``make_serve_step`` jitted over the rules' specs on
    four forced host devices, in a subprocess: every step's logits and the
    cache after the last (bf16 leaves as f32)."""
    inp, out = str(tmp_path / "in.npy"), str(tmp_path / "out.npz")
    np.save(inp, {**{k: w[k] for k in ("arch", "L", "B", "plan", "kv_dtype", "cache", "tokens", "cur")},
                  "params": tree, "dtype": dtype}, allow_pickle=True)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, "-c", JAX_SHARDED.format(src=os.path.join(ROOT, "src"),
                                                                    inp=inp, out=out)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def test_mesh_decode_matches_the_jax_sharded_serve_step(meshes, trees, work, tmp_path):
    """A sequence-split int8 cache: the port's ranks against the JAX
    package's ``make_serve_step`` jitted over the same specs on four forced
    host devices (GSPMD's partition of the one softmax): logits within
    ``TOL``, the int8 scales within f32 rounding and every code within one
    step."""
    i = NAMES.index("seq_int8_all_1x4")
    w = work[i]
    ref = _jax_sharded(w, trees[w["arch"]], tmp_path)
    for rank in meshes["seq_int8_all_1x4"]:
        np.testing.assert_allclose(rank["logits"].numpy(), ref["logits"], **TOL)
    got = meshes["seq_int8_all_1x4"][0]["cache"]
    for b, c in got.items():
        np.testing.assert_allclose(c["k_s"].numpy(), ref[b + ".k_s"], rtol=1e-6)
        np.testing.assert_allclose(c["v_s"].numpy(), ref[b + ".v_s"], rtol=1e-6)
        for k in ("k", "v"):
            assert int((c[k].int() - torch.from_numpy(ref[b + "." + k]).int()).abs().max()) <= 1, (b, k)


def test_one_device_decode_is_a_mesh_of_size_one(trees, work):
    """On a (1, 1) gloo mesh the serve step computes what one device does,
    bit for bit (every collective the identity)."""
    w = work[NAMES.index("seq_int8_1x4")]
    got = run_on_mesh(MeshSpec(("data", "model"), (1, 1)), dc.decode_cases, [w], trees,
                      device="cpu")[0][0]
    exp_logits, exp_cache = _one_process(w, trees)
    assert torch.equal(got["logits"], exp_logits)
    for b, c in exp_cache.items():
        for k, v in c.items():
            assert torch.equal(got["cache"][b][k], v), (b, k)


# ---------------------------------------------------------------------------
# bf16 (ROADMAP C5): a bf16 mesh drifts from one process by the order of its
# sums.  Does the port's drift more than the reference's?  Reduced
# granite-3-2b in bf16 (weights from the JAX package's init_params at bf16,
# cache drawn in f32 and held in bf16), the head-split plan on a (1, 4)
# mesh: d_port = |port mesh - port one process| / |port one process| and
# d_ref = |JAX sharded make_serve_step - JAX one-device decode_step| / |JAX
# one device|, over the logits of every step.  The two cases draw the same
# tokens and cache and, from one key in one order at the same reduced
# widths, the same embedding and attention weights: only the MLP differs,
# so their whole-run d_ref come out close while each step's differ.
BF16_CASES = [  # (name, arch, plan, commit mask: None, as the JAX steps take none)
    ("heads_1x4_bf16", "granite-3-2b", HEADS, None),
    ("moe_tp_1x4_bf16", "granite-moe-1b-a400m",
     dict(HEADS, ffn_tp=True, moe_mode="tp", vocab_shard=True, seq_shard=True), None),
]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_one_device(w, tree) -> np.ndarray:
    jcfg = dataclasses.replace(jax_get_config(w["arch"]).reduced(), dtype=w["dtype"])
    tmpl = jtf.init_cache(jcfg, w["B"], w["L"], w["kv_dtype"])
    cache = jax.tree.map(lambda a, t: jnp.asarray(a, t.dtype), w["cache"], tmpl)
    jparams = jax.tree.map(jnp.asarray, tree)
    out = []
    for tok, cur in zip(w["tokens"], w["cur"]):
        jl, cache = jtf.decode_step(jparams, jcfg, cache, jnp.asarray(tok, jnp.int32)[:, None],
                                    jnp.asarray(cur, jnp.int32))
        out.append(np.asarray(jl, np.float32))
    return np.stack(out)


@pytest.mark.parametrize("name,arch,plan,commit", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_mesh_decode_drifts_no_more_than_the_reference(tmp_path, name, arch, plan, commit):
    tree = jax.tree.map(np.asarray, jtf.init_params(
        dataclasses.replace(jax_get_config(arch).reduced(), dtype="bfloat16"), jax.random.PRNGKey(0)))
    w = _work(len(CASES), name, arch, plan, "bf16", 4, commit)
    w.update(dtype="bfloat16", tree=name)
    trees = {name: tree}
    ranks = run_on_mesh(MeshSpec(("data", "model"), (1, 4)), dc.decode_cases, [w], trees, device="cpu")
    one, _ = _one_process(w, trees)
    d_port = max(_rel(r[0]["logits"].float().numpy(), one.float().numpy()) for r in ranks)
    ref = _jax_sharded(w, tree, tmp_path, dtype="bfloat16")
    # the subprocess ran this case's arch, dtype and MoE mode
    jcfg = jax_get_config(arch).reduced()
    assert (str(ref["cfg_name"]), str(ref["cfg_dtype"]), int(ref["n_experts"])) == (
        jcfg.name, "bfloat16", jcfg.n_experts)
    assert str(ref["moe_mode"]) == plan.get("moe_mode", SchedulePlan().moe_mode)
    sharded, jax_one = ref["logits"], _jax_one_device(w, tree)
    d_ref = _rel(sharded, jax_one)
    steps = [(_rel(r, o), _rel(s, j)) for r, o, s, j in
             zip(ranks[0][0]["logits"].float().numpy(), one.float().numpy(), sharded, jax_one)]
    print(f"{name}: d_port {d_port:.4g}, d_ref {d_ref:.4g}; per step (port, ref) "
          + ", ".join(f"({a:.4g}, {b:.4g})" for a, b in steps))
    assert d_port > 0 and d_ref > 0  # both meshes sum in another order than one device
    # and both drift by the order of sums alone, far less than another model's
    # logits differ (granite-moe's from granite-3-2b's, ~9e-2, on these inputs)
    assert d_ref < 1e-2, d_ref
    assert d_port <= 2 * d_ref + 1e-3, (d_port, d_ref)

"""The port's train and prefill steps over CPU gloo meshes.

Each mesh runs once per module (``run_on_mesh``: one spawned process a
rank, ``file://`` rendezvous) through every case, with the weights of the
JAX package's ``init_params`` carried across (``convert``).  Against the
port's one-process step and the JAX package's one-device
``make_train_step`` (in-process): the loss within 2e-3 and the parameters
after one update within 5e-3 (the bounds of the reference's
``test_sharded_train_step_matches_single_device``), and, tighter, against
the port's one process: the loss and the global grad norm within 1e-5
relative and every gradient within 1e-4 in relative norm (5e-3 under
expert parallelism, whose combine is rounded to bf16 as in the reference).
Over a data split the one-process step runs the ranks' rows as
microbatches (``microbatches`` x the data size): the MoE dispatches each
rank's rows alone, as the mesh does.  Each rank holds exactly the local
shapes the rules give; the prefill logits match; a checkpoint saved under
one mesh restores bit-equal under others and in one process, and one
saved in one process restores onto a mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxShape
from repro.core.space import SchedulePlan as JaxPlan
from repro.models import transformer as jtf
from repro.training import optimizer as joptim
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import InputShape, get_config
from repro_torch.core.space import MeshSpec, SchedulePlan
from repro_torch.launch.mesh import make_mesh_from_spec, run_on_mesh
from repro_torch.models import transformer as ttf
from repro_torch.models.losses import cross_entropy
from repro_torch.training import optimizer as optim
from repro_torch.training.train_step import (
    make_prefill_step, make_serve_step, make_train_step, shardings_for_train, tiles_from_plan,
)

import torch_dist_cases as dc

torch.set_num_threads(1)

# the plan mcts_1s picks for granite-moe-1b-a400m x train_4k, hw="h100",
# mesh "single" (microbatches cut from 8 to 2 for the reduced batch)
MOE_PLAN = dict(param_strategy="tp", mixer_tp=False, seq_shard=True, ffn_tp=True, moe_mode="dense",
                vocab_shard=False, remat="none", microbatches=2, attn_block=(256, 512),
                grad_comm="int8", opt_dtype="int8")
CASES_22 = [
    # the reference test's case
    dict(arch="granite-3-2b", plan=dict(param_strategy="fsdp_tp", microbatches=2, remat="dots"),
         opt_dtype="float32", B=8, S=32),
    *[dict(arch="granite-moe-1b-a400m", plan={**MOE_PLAN, "moe_mode": m}, opt_dtype="int8", B=4,
           S=16) for m in ("ep", "tp", "dense")],
    # mixer_tp + vocab_shard + seq_shard; int8 moments of in_proj split on its last axis
    dict(arch="falcon-mamba-7b", plan=dict(param_strategy="fsdp_tp", mixer_tp=True, vocab_shard=True,
                                           seq_shard=True, remat="full", microbatches=2),
         opt_dtype="int8", B=4, S=16),
]
CASES_14 = [
    dict(arch="granite-moe-1b-a400m", plan={**MOE_PLAN, "moe_mode": "ep"}, opt_dtype="int8", B=4, S=16),
    # n_kv_heads 2 < tp 4: wk / wv split mid-head, gathered on use
    dict(arch="granite-3-2b", plan=dict(param_strategy="tp", microbatches=1, remat="none",
                                        seq_shard=True), opt_dtype="int8", B=4, S=16),
]
CASES_41 = [dict(arch="granite-3-2b", plan=dict(param_strategy="fsdp", microbatches=1, remat="full",
                                                grad_comm="int8"), opt_dtype="float32", B=8, S=16)]
ARCHS = ("granite-3-2b", "granite-moe-1b-a400m", "falcon-mamba-7b")


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch).reduced()
        out[arch] = (jcfg, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def trees(weights):
    return {arch: jax.tree.map(np.asarray, jp) for arch, (_, jp) in weights.items()}


@pytest.fixture(scope="module")
def one_ckpt(tmp_path_factory, trees):
    """A checkpoint written by one process (granite-3-2b, CASES_14[1]'s
    int8 moments, after one update)."""
    d = str(tmp_path_factory.mktemp("one_ckpt"))
    case = CASES_14[1]
    params, opt, _ = _one_process(case, trees)
    Checkpointer(d).save(3, params, opt)
    return d, params, opt


def _run(shape, cases, trees, ckpt_dir=None, restores=(), trainer_dir=None):
    """One spawn of a mesh: per rank, the cases' results, the restores' and
    the trainer's."""
    ranks = run_on_mesh(MeshSpec(("data", "model"), shape), dc.mesh_run, cases, trees, ckpt_dir,
                        restores, trainer_dir, device="cpu")
    return [r["train"] for r in ranks], [r["restore"] for r in ranks], [r["trainer"] for r in ranks]


@pytest.fixture(scope="module")
def mesh22_run(tmp_path_factory, trees):
    """The (2, 2) spawn: its cases (the first saved to a checkpoint) and the
    trainer."""
    d, d_trainer = (str(tmp_path_factory.mktemp(n)) for n in ("ckpt22", "trainer22"))
    train, _, trainer = _run((2, 2), CASES_22, trees, d, trainer_dir=d_trainer)
    return d, train, trainer, d_trainer


@pytest.fixture(scope="module")
def mesh22(mesh22_run):
    return mesh22_run[:2]


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, mesh22_run):
    """The trainer on the (2, 2) mesh and in one process."""
    return mesh22_run[2], dc.trainer_case(None, str(tmp_path_factory.mktemp("trainer1"))), mesh22_run[3]


@pytest.fixture(scope="module")
def mesh14(mesh22, one_ckpt, trees):
    """Its cases, then the (2, 2) checkpoint and the one-process one restored."""
    train, restore, _ = _run((1, 4), CASES_14, trees,
                             restores=[(CASES_22[0], mesh22[0]), (CASES_14[1], one_ckpt[0])])
    return train, [r[0] for r in restore], [r[1] for r in restore]


@pytest.fixture(scope="module")
def mesh41(mesh22, trees):
    train, restore, _ = _run((4, 1), CASES_41, trees, restores=[(CASES_22[0], mesh22[0])])
    return train, [r[0] for r in restore]


def _one_process(case, trees, dp=1):
    """The port's one-process step on the same weights: its updated params,
    state and metrics, its gradients and the prefill logits."""
    cfg = get_config(case["arch"]).reduced()
    kw = dict(case["plan"])
    n_mb = kw.get("microbatches", 1) * dp
    plan = SchedulePlan(**{**kw, "microbatches": n_mb})
    oc = optim.OptimizerConfig(peak_lr=1e-3, warmup_steps=0, moment_dtype=case["opt_dtype"])
    params = convert.params_from_numpy(trees[case["arch"]], cfg, device="cpu")
    batch = dc.batch_for(cfg, case["B"], case["S"])
    # prefill of each data rank's rows apart: the MoE dispatches a rank's rows alone
    prefill, rows = make_prefill_step(cfg, None, plan, device="cpu"), case["B"] // dp
    logits = torch.cat([prefill(params, {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()})
                        for d in range(dp)])
    # the gradients, as the step takes them
    leaves = [p.requires_grad_(True) for _, p in optim.leaves(params)]
    mb = case["B"] // n_mb
    grads = [torch.zeros(p.shape) for p in leaves]
    for i in range(n_mb):
        rows = slice(i * mb, (i + 1) * mb)
        lg = ttf.forward(params, cfg, batch["inputs"][rows], batch["positions"][rows],
                         tiles=tiles_from_plan(plan))
        loss = cross_entropy(lg[:, :-1], batch["labels"][rows, 1:])
        for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
            acc.add_(g / n_mb)
    grads = optim.tree_from_leaves(params, dict(zip((k for k, _ in optim.leaves(params)), grads)))
    opt = optim.init_opt_state(params, oc)
    params, opt, m = make_train_step(cfg, None, plan, oc, device="cpu")(params, opt, batch)
    return params, opt, {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads,
                         "logits": logits}


_JAX_STEPS: dict = {}


def _jax_step(case, weights, dp=1):
    """The JAX one-device step (one run per distinct one-device program: the
    MoE mode plays no part there)."""
    key = (case["arch"], repr(sorted({**case["plan"], "moe_mode": None}.items())), dp,
           case["opt_dtype"], case["B"], case["S"])
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _jax_step_run(case, weights, dp)
    return _JAX_STEPS[key]


def _jax_step_run(case, weights, dp):
    jcfg, jp = weights[case["arch"]]
    kw = dict(case["plan"])
    jplan = JaxPlan(**{**kw, "microbatches": kw.get("microbatches", 1) * dp})
    joc = joptim.OptimizerConfig(peak_lr=1e-3, warmup_steps=0, moment_dtype=case["opt_dtype"])
    cfg = get_config(case["arch"]).reduced()
    b = dc.batch_for(cfg, case["B"], case["S"])
    batch = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in b.items()}
    step = jax.jit(jax_make_train_step(jcfg, JaxShape("t", case["S"], case["B"], "train"), jplan, joc))
    p, _, m = step(jp, joptim.init_opt_state(jp, joc), batch)
    return jax.tree.map(np.asarray, p), {k: float(v) for k, v in m.items()}


def _leaves(tree):
    return dict(optim.leaves(tree))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check(res, case, trees, weights, dp, spec):
    """The mesh's result for ``case`` against one process and the JAX step."""
    one_p, one_opt, one = _one_process(case, trees, dp)
    ep = case["plan"].get("moe_mode") == "ep"
    grad_tol = 5e-3 if ep else 1e-4
    assert abs(res["loss"] - one["metrics"]["loss"]) <= 1e-5 * abs(one["metrics"]["loss"])
    assert abs(res["metrics"]["loss"] - one["metrics"]["loss"]) <= 1e-5 * abs(one["metrics"]["loss"])
    assert _rel(res["metrics"]["grad_norm"], one["metrics"]["grad_norm"]) < grad_tol
    got_g, exp_g = _leaves(res["grads"]), _leaves(one["grads"])
    assert got_g.keys() == exp_g.keys()
    for k in exp_g:
        assert _rel(got_g[k].detach(), exp_g[k]) < grad_tol, k
    if ep:
        assert _rel(res["logits"], one["logits"]) < grad_tol
    else:
        np.testing.assert_allclose(res["logits"].numpy(), one["logits"].numpy(), rtol=1e-4, atol=1e-4)
    # the reference test's bounds, against one process and the JAX step
    jp, jm = _jax_step(case, weights, dp)
    for ref_loss in (one["metrics"]["loss"], jm["loss"]):
        assert abs(res["metrics"]["loss"] - ref_loss) < 2e-3
    got_p = {k: v.detach() for k, v in _leaves(res["params"]).items()}
    jax_p = {".".join(str(x.key) for x in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for k, v in _leaves(one_p).items():
        assert float((got_p[k] - v.detach()).abs().max()) < 5e-3, k
        assert float(np.abs(got_p[k].numpy() - jax_p[k]).max()) < 5e-3, k
    # the moments: int8 scales are the whole row's, codes within one step
    # (under EP, whose gradients differ by up to 5e-3, within 1e-2 in relative
    # norm: that bound plus the int8 codes it flips, a step of amax / 127 each)
    got_mu, one_mu = _leaves(res["opt"]["mu"]), _leaves(one_opt["mu"])
    for k, m in one_mu.items():
        if isinstance(m, dict):
            np.testing.assert_allclose(got_mu[k]["s"].numpy(), m["s"].numpy(), rtol=grad_tol * 10)
            deq_got = got_mu[k]["q"].float() * got_mu[k]["s"]
            deq_one = m["q"].float() * m["s"]
            if ep:
                assert _rel(deq_got, deq_one) < 1e-2, k
            else:
                assert bool(((deq_got - deq_one).abs() <= m["s"] * 1.01 + 1e-12).all()), k


class _FakeMesh:
    """Enough of a ``Mesh`` for ``shardings_for_train``'s shapes."""

    def __init__(self, spec):
        self.spec = spec

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.spec.axis(a) for a in axes]))

    def index(self, axes):
        return 0


@pytest.mark.parametrize("i", range(len(CASES_22)),
                         ids=[f"{c['arch']}-{c['plan'].get('moe_mode', '')}" for c in CASES_22])
def test_2x2_step_matches_one_device(mesh22, trees, weights, i):
    _, ranks = mesh22
    _check(ranks[0][i], CASES_22[i], trees, weights, dp=2, spec=MeshSpec(("data", "model"), (2, 2)))


@pytest.mark.parametrize("i", range(len(CASES_14)), ids=[c["arch"] for c in CASES_14])
def test_1x4_step_matches_one_device(mesh14, trees, weights, i):
    _check(mesh14[0][0][i], CASES_14[i], trees, weights, dp=1, spec=MeshSpec(("data", "model"), (1, 4)))


def test_4x1_fsdp_step_matches_one_device(mesh41, trees, weights):
    _check(mesh41[0][0][0], CASES_41[0], trees, weights, dp=4, spec=MeshSpec(("data", "model"), (4, 1)))


def test_each_rank_holds_the_local_shapes_the_rules_give(mesh22, mesh14, mesh41):
    runs = [(mesh22[1], CASES_22, (2, 2)), (mesh14[0], CASES_14, (1, 4)), (mesh41[0], CASES_41, (4, 1))]
    runs += [([[r] for r in mesh14[1]], [CASES_22[0]], (1, 4)),
             ([[r] for r in mesh41[1]], [CASES_22[0]], (4, 1))]
    for ranks, case_list, shape in runs:
        spec = MeshSpec(("data", "model"), shape)
        for rank in ranks:
            for res, case in zip(rank, case_list):
                cfg = get_config(case["arch"]).reduced()
                sh = shardings_for_train(cfg, None, SchedulePlan(**case["plan"]), _FakeMesh(spec))
                assert res["local_params"] == sh["local_shapes"]
                for m in ("mu", "nu"):
                    for k, shape in res["local_opt"][m].items():
                        if k.endswith(".s"):  # an int8 moment's scales: one a local row
                            assert shape == sh["local_shapes"][k[:-2]][:-1] + (1,), k
                        else:
                            assert shape == sh["local_shapes"][k.removesuffix(".q")], k
    # the cases run what they claim: a last-axis split of int8 moments, and EP
    falcon = mesh22[1][0][4]
    assert "blocks.b0.mamba.in_proj" in falcon["row_split"]
    assert [r["moe_ep"] for r in mesh22[1][0][1:4]] == [True, False, False]


def test_int8_moment_shards_keep_whole_row_scales(mesh22):
    """A shard of an int8 moment split on its last axis holds codes of the
    local columns and scales of the whole rows (``s`` replicated there)."""
    falcon = mesh22[1]
    whole = falcon[0][4]["opt"]["mu"]["blocks"]["b0"]["mamba"]["in_proj"]
    assert whole["q"].shape[-1] == 2 * get_config("falcon-mamba-7b").reduced().d_inner
    assert whole["s"].shape[-1] == 1


def test_checkpoint_restores_bit_equal_across_meshes_and_one_process(mesh22, mesh14, mesh41):
    ckpt_dir, ranks = mesh22
    saved = ranks[0][0]
    for restored in (mesh14[1][0], mesh41[1][0]):
        assert restored["step"] == 7 and restored["extra"] == {"case": 0}
        for k, v in _leaves(saved["params"]).items():
            assert torch.equal(_leaves(restored["params"])[k], v), k
        for m in ("mu", "nu"):
            for k, v in _leaves(saved["opt"][m]).items():
                assert torch.equal(_leaves(restored["opt"][m])[k], v), k
    # restored shards are the new mesh's
    assert mesh14[1][1]["local_params"] != mesh41[1][1]["local_params"]
    # and in one process, from the mesh's files
    cfg = get_config("granite-3-2b").reduced()
    tmpl = ttf.init_params(cfg, 1, device="cpu")
    tmpl_opt = optim.init_opt_state(tmpl, optim.OptimizerConfig())
    params, opt, step, _ = Checkpointer(ckpt_dir).restore(tmpl, tmpl_opt)
    assert step == 7
    for k, v in _leaves(saved["params"]).items():
        assert torch.equal(_leaves(params)[k], v), k


def test_one_process_checkpoint_restores_onto_a_mesh(one_ckpt, mesh14):
    _, params, opt = one_ckpt
    restored = mesh14[2][0]
    assert restored["step"] == 3
    for k, v in _leaves(params).items():
        assert torch.equal(_leaves(restored["params"])[k], v.detach()), k
    for k, v in _leaves(opt["nu"]).items():
        got = _leaves(restored["opt"]["nu"])[k]
        if isinstance(v, dict):
            assert torch.equal(got["q"], v["q"]) and torch.equal(got["s"], v["s"]), k
        else:
            assert torch.equal(got, v), k


def test_a_mesh_of_more_ranks_than_cards_needs_share_card():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has a card a rank")
    spec = MeshSpec(("data", "model"), (1, 2))
    with pytest.raises(RuntimeError, match="share_card"):
        make_mesh_from_spec(spec, device="cuda")
    with pytest.raises(RuntimeError, match="share_card"):
        run_on_mesh(spec, dc.batch_for, device="cuda")


def test_decode_over_a_mesh_still_names_a8():
    """Decode over a mesh is ported (it raised naming ROADMAP A8 until then;
    ``tests/test_torch_mesh_decode.py`` runs it): the step needs the cell's
    shape, and takes the rules' decode layout from it."""
    cfg = get_config("granite-3-2b").reduced()
    mesh = _FakeMesh(MeshSpec(("data", "model"), (1, 4)))
    with pytest.raises(ValueError, match="InputShape"):
        make_serve_step(cfg, None, SchedulePlan(), mesh=mesh)
    seq = SchedulePlan(param_strategy="replicated", seq_shard=True)
    step = make_serve_step(cfg, InputShape("d", 16, 4, "decode"), seq, mesh=mesh)
    assert step.par.kv == ("data", None, "model", None) and step.par.rows_split
    heads = SchedulePlan(param_strategy="tp", mixer_tp=True)
    step = make_serve_step(cfg, InputShape("d", 16, 4, "decode"), heads, mesh=mesh)
    assert step.par.kv == ("data", None, None, None)  # 2 KV heads do not split over 4


def test_a_rank_that_raises_fails_the_run_with_its_traceback(trees):
    bad = dict(CASES_22[0], B=6)  # 3 rows a data rank do not split into 2 microbatches
    with pytest.raises(RuntimeError, match="microbatches"):
        run_on_mesh(MeshSpec(("data", "model"), (2, 1)), dc.train_cases, [bad], trees, device="cpu")


def test_trainer_over_a_mesh_matches_one_process_and_only_rank_0_logs(trainer_runs):
    """``Trainer(mesh=...)``: each rank trains its shards from the seed's
    weights, rank 0 alone logs, the losses and weights equal the one-process
    trainer's, and its checkpoints carry the mesh."""
    import json
    import os

    ranks, one, d_mesh = trainer_runs
    assert [len(r["log"]) for r in ranks] == [2, 0, 0, 0]
    for got, exp in zip(ranks[0]["log"], one["log"]):
        assert got["step"] == exp["step"]
        assert abs(got["loss"] - exp["loss"]) <= 1e-5 * abs(exp["loss"])
        assert abs(got["grad_norm"] - exp["grad_norm"]) <= 1e-4 * exp["grad_norm"]
    for k, v in _leaves(one["params"]).items():
        assert float((_leaves(ranks[0]["params"])[k].detach() - v.detach()).abs().max()) < 5e-3, k
    with open(os.path.join(d_mesh, "step_00000002.json")) as f:
        assert json.load(f)["mesh"] == {"names": ["data", "model"], "shape": [2, 2]}

"""The port's schedule search against the JAX package's.

Under ``hw="tpu-v5e"`` (the JAX package's spec, pods and tile options) the
port's ``autotune`` must give the JAX package's result bit for bit: plan,
cost, evaluation count and decision trace, in float equality.  Under the
port's default ``hw="h100"`` every tile the space offers must launch on the
port's kernels, and every mesh must price every default plan.
"""
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import DECODE_CELL, MOE_TRAIN_CELL, make_cell_mdp
from repro.core.autotuner import autotune as jax_autotune
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.core.autotuner import autotune, make_mdp
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.hardware import H100, TPU_V5E
from repro_torch.core.mdp import ScheduleMDP
from repro_torch.core.space import MESHES, SINGLE_POD, ScheduleSpace, get_mesh
from repro_torch.kernels import geometry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELLS = {"moe_train": MOE_TRAIN_CELL, "decode": DECODE_CELL,
         # model coverage: a dense arch past granite, and head_dim 160 on a prefill shape
         "nemotron_train": ("nemotron-4-15b", "train_4k"), "stablelm_prefill": ("stablelm-12b", "prefill_32k")}
ALGOS = ("mcts_1s", "beam", "evolve", "portfolio")
SMALL = dict(n_standard=2, n_greedy=1)  # tests/test_differential.py's ensemble size


def _port_mdp(arch, shape_name, *, pricing=None, mesh=SINGLE_POD, hw=TPU_V5E, reduced=True):
    cfg, shape = get_config(arch), get_shape(shape_name)
    cfg = cfg.reduced() if reduced else cfg
    return ScheduleMDP(ScheduleSpace(cfg, shape, mesh, hw),
                       AnalyticCostModel(cfg, shape, mesh, hw, pricing=pricing))


def _trace(res):
    """The decision trace without its host times."""
    return [{k: v for k, v in d.items() if k != "wall_time_s"} for d in res.decisions]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("cell", list(CELLS))
def test_autotune_on_tpu_v5e_equals_the_jax_search(cell, algo):
    arch, shape_name = CELLS[cell]
    ref = jax_autotune(arch, shape_name, algo=algo, seed=0, mdp=make_cell_mdp(arch, shape_name),
                       **SMALL)
    got = autotune(arch, shape_name, algo=algo, seed=0, hw="tpu-v5e",
                   mdp=_port_mdp(arch, shape_name), **SMALL)
    assert got.plan.to_dict() == ref.plan.to_dict()
    assert got.cost == ref.cost
    assert got.n_evals == ref.n_evals
    assert _trace(got) == _trace(ref)
    if algo == "mcts_1s":
        assert [(d["action"], d["best_cost"], d["winner_tree"]) for d in got.decisions] == [
            (d["action"], d["best_cost"], d["winner_tree"]) for d in ref.decisions]


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_cost_model_terms_and_batches_equal_the_jax_model(cell, reduced):
    """64 numpy-seeded random plans: scalar ``terms`` and the columnar
    ``cost_batch`` kernel give the JAX package's values bit for bit (at
    full width some plans overflow a v5e's memory and take the penalty)."""
    arch, shape_name = CELLS[cell]
    ref = make_cell_mdp(arch, shape_name, pricing="scalar", reduced=reduced)
    ref_col = make_cell_mdp(arch, shape_name, columnar_min_batch=1, reduced=reduced)
    port = _port_mdp(arch, shape_name, pricing="scalar", reduced=reduced)
    port_col = _port_mdp(arch, shape_name, reduced=reduced)
    port_col.cost_model.columnar_min_batch = 1  # every batch through the column kernel
    stages = port.space.stages
    assert [(s.name, s.options) for s in stages] == [(s.name, s.options) for s in ref.space.stages]
    rng = np.random.default_rng(0)
    actions = [[int(rng.integers(len(s.options))) for s in stages] for _ in range(64)]
    ref_plans = [ref.space.plan_from_actions(a) for a in actions]
    plans = [port.space.plan_from_actions(a) for a in actions]
    assert [p.to_dict() for p in plans] == [p.to_dict() for p in ref_plans]
    for p, rp in zip(plans, ref_plans):
        assert port.cost_model.terms(p).to_dict() == ref.cost_model.terms(rp).to_dict()
    got = port_col.cost_model.cost_batch(plans)
    assert got == ref_col.cost_model.cost_batch(ref_plans)
    assert got == [port.cost_model.cost(p) for p in plans]


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "no-shm"])
def test_parallel_search_equals_the_sequential_run(shm):
    arch, shape_name = MOE_TRAIN_CELL
    seq = autotune(arch, shape_name, algo="mcts_1s", seed=1,
                   mdp=_port_mdp(arch, shape_name, mesh=get_mesh("h100", "single"), hw=H100),
                   **SMALL)
    par = autotune(arch, shape_name, algo="mcts_1s", seed=1, parallel=True, n_workers=2, shm=shm,
                   mdp=_port_mdp(arch, shape_name, mesh=get_mesh("h100", "single"), hw=H100),
                   **SMALL)
    assert par.plan == seq.plan
    assert par.cost == seq.cost
    assert [(d["action"], d["best_cost"], d["winner_tree"]) for d in par.decisions] == [
        (d["action"], d["best_cost"], d["winner_tree"]) for d in seq.decisions]
    assert par.stats["shm"] is shm


def test_search_import_chain_loads_no_torch_jax_or_repro():
    """``pick_mp_context`` preloads ``repro_torch.core.ensemble`` into the
    forkserver: a process that has initialised torch (CUDA, OpenMP threads)
    must never be forked, and the port imports nothing of JAX."""
    code = ("import sys, repro_torch.core.ensemble\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'jax', 'repro'}))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def _full_and_reduced():
    return [(a, r) for a in ARCH_IDS for r in (False, True)]


@pytest.mark.parametrize("arch,reduced", _full_and_reduced(),
                         ids=[f"{a}{'-reduced' if r else ''}" for a, r in _full_and_reduced()])
def test_every_h100_tile_option_launches(arch, reduced):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    seen = set()
    for shape in SHAPES.values():
        space = ScheduleSpace(cfg, shape, get_mesh("h100", "card"))
        for st in space.stages:
            if st.name == "attn_block":
                for bq, bkv in st.options:
                    geometry.flash_launch(1, cfg.n_heads, shape.seq_len, shape.seq_len,
                                          cfg.resolved_head_dim, cfg.dtype, bq, bkv)
            elif st.name == "scan_chunk":
                for ch in st.options:
                    assert shape.seq_len % ch == 0
                    geometry.scan_launch(1, shape.seq_len, cfg.d_inner, cfg.ssm_state, cfg.dtype,
                                         ch, 256)
            else:
                continue
            assert st.options
            seen.add(st.name)
    assert seen == ({"attn_block"} if cfg.n_heads else set()) | ({"scan_chunk"} if cfg.is_ssm else set())


def test_h100_attn_block_options_at_head_dim_64_and_128():
    moe = ScheduleSpace(get_config("granite-moe-1b-a400m"), get_shape("train_4k"),
                        get_mesh("h100", "card"))
    opts = dict((s.name, s.options) for s in moe.stages)["attn_block"]
    assert len(opts) == 6 and all(bq in (128, 256) for bq, _ in opts)
    assert tuple(geometry.launchable_attn_blocks(128, "bfloat16")) == ((128, 128), (128, 256))
    tpu = ScheduleSpace(get_config("granite-moe-1b-a400m"), get_shape("train_4k"), SINGLE_POD,
                        TPU_V5E)
    assert len(dict((s.name, s.options) for s in tpu.stages)["attn_block"]) == 9


@pytest.mark.parametrize("hw,mesh", [(hw, m) for hw, ms in (("h100", MESHES[H100.name]),
                                                             ("tpu-v5e", MESHES[TPU_V5E.name]))
                                     for m in ms])
def test_every_mesh_prices_every_default_plan_finite(hw, mesh):
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            mdp = make_mdp(arch, shape_name, mesh, hw=hw)
            plan = mdp.space.plan_from_actions(mdp.space.default_actions())
            assert math.isfinite(mdp.cost_model.cost(plan)) and mdp.cost_model.cost(plan) > 0


def test_h100_meshes_and_spec():
    assert get_mesh("h100", "single").shape == (1, 8)
    assert get_mesh("h100", "multi").names == ("pod", "data", "model")
    assert get_mesh("h100", "multi").shape == (2, 1, 8)
    assert get_mesh("h100", "card").size == 1
    assert H100.vmem_bytes == geometry.SMEM_PER_BLOCK
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes) == (989e12, 3.35e12, 80 * 2**30)
    assert make_mdp("granite-moe-1b-a400m", "train_4k").cost_model.hw is H100  # the default
    with pytest.raises(KeyError, match="card"):
        get_mesh("tpu-v5e", "card")


def test_unported_paths_raise_naming_their_roadmap_items(tmp_path):
    """No search-side path raises any more.  The paths that raised naming A5
    and A10 run: ``pricing="jit"``, ``cost="learned"|"hybrid"`` for
    ``mcts_1s`` and ``beam``, and ``plan_store=`` (a repeat request served
    from disk); A8's measurement over a mesh is the dry run
    (``test_measured_search_on_a_mesh_is_served_by_dry_runs``)."""
    from repro_torch.core.cost_model import JIT_PRICING_TAG, JIT_RTOL
    from repro_torch.service.store import PlanStore

    jit = make_mdp("granite-3-2b", "decode_32k", pricing="jit", device="cpu").cost_model
    exact = make_mdp("granite-3-2b", "decode_32k")
    assert jit.pricing_tag == JIT_PRICING_TAG
    plans = [exact.space.random_plan(random.Random(s)) for s in range(16)]
    np.testing.assert_allclose(jit.cost_batch(plans), exact.cost_model.cost_batch(plans),
                               rtol=JIT_RTOL, atol=0.0)
    for cost in ("learned", "hybrid"):
        for algo in ("mcts_1s", "beam"):
            res = autotune("granite-3-2b", "decode_32k", algo=algo, cost=cost, device="cpu",
                           **SMALL)
            assert res.plan is not None and math.isfinite(res.cost)
            assert res.cost_mode == (cost if algo == "mcts_1s" else "analytic")
    store = PlanStore(str(tmp_path / "store"))
    first = autotune("granite-3-2b", "decode_32k", algo="mcts_1s", plan_store=store, **SMALL)
    again = autotune("granite-3-2b", "decode_32k", algo="mcts_1s", plan_store=store, **SMALL)
    assert not first.from_store and again.from_store
    assert (again.plan, again.cost, again.hw) == (first.plan, first.cost, "h100")


def test_measured_search_on_a_mesh_is_served_by_dry_runs(tmp_path):
    """``mcts_cost+real_1s`` on mesh ``single`` (the tuner's default) re-ranks
    its candidates by the production-mesh dry run's records, as the JAX
    package's search re-ranks by its dry run: every measurement is a
    ``source: "dryrun"`` record of the 1 x 8 node, none fails and none falls
    back to the analytic cost."""
    from repro_torch.core import measure
    from repro_torch.launch.measure import CardTarget

    target, records = CardTarget(), []

    def dry_run(req):
        records.append(target(req))
        return records[-1]

    fn = measure.make_measure_fn("granite-3-2b", "decode_32k", "single", cache_dir=str(tmp_path),
                                 target=dry_run)
    res = autotune("granite-3-2b", "decode_32k", algo="mcts_cost+real_1s", measure_fn=fn, **SMALL)
    assert res.n_measurements > 0 and res.n_measure_failures == 0
    assert res.measured is not None and math.isfinite(res.measured)
    assert records and all(r["source"] == "dryrun" and r["mesh"] == "single" and r["chips"] == 8
                           for r in records)
    assert res.measured in {r["step_s"] for r in records}

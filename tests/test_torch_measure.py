"""The port's measurement layer on the CPU: the cache, the subprocess client,
the fleet's fault tolerance, the stub against the JAX package's, and the
card's measurement (``repro_torch.launch.measure``) on ``--device cpu``.

The fleet and cache tests are the JAX package's
(``tests/test_fault_tolerance.py``) against the port's stub target; under
``hw="tpu-v5e"`` the port's stub record and its ``mcts_cost+real_1s`` search
must equal the JAX package's bit for bit.
"""
import dataclasses
import json
import os

import pytest
import torch

from conftest import DECODE_CELL, MOE_TRAIN_CELL, make_cell_mdp
from repro.core.autotuner import autotune as jax_autotune
from repro.core.measure_stub import stub_measure as jax_stub_measure
from repro_torch.configs import get_config, get_shape
from repro_torch.core import measure
from repro_torch.core.autotuner import autotune, make_mdp
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.ensemble import ProTuner
from repro_torch.core.hardware import TPU_V5E, get_hardware
from repro_torch.core.mcts import MCTSConfig
from repro_torch.core.mdp import ScheduleMDP
from repro_torch.core.measure import make_request, measure_cell, request_key
from repro_torch.core.measure_fleet import MeasurementFleet
from repro_torch.core.measure_stub import failing_measure, stub_measure
from repro_torch.core.space import SINGLE_POD, SchedulePlan, ScheduleSpace, get_mesh
from repro_torch.launch import measure as card

torch.set_num_threads(1)

CELL = ("granite-3-2b", "train_4k")
CELLS = {"moe_train": MOE_TRAIN_CELL, "decode": DECODE_CELL}
SMALL = dict(n_standard=2, n_greedy=1)
CPU_CUT = {"reduced": True, "seq": 32}  # the card measurement's CPU test cut


def _fleet(tmp_path, n=2, **kw):
    kw.setdefault("cache_dir", str(tmp_path / "fleet_cache"))
    kw.setdefault("target", stub_measure)
    kw.setdefault("timeout", 30.0)
    kw.setdefault("grace_s", 10.0)
    kw.setdefault("backoff_s", 0.05)
    return MeasurementFleet(n, **kw)


# ---------------------------------------------------------------------------
# the on-disk cache and its key
@pytest.mark.parametrize("corrupt", ['{"step_s": 0.0', "not json at all", '{"plan": null}'],
                         ids=["truncated", "garbage", "no-step_s"])
def test_measure_cache_poisoning_quarantined(tmp_path, corrupt):
    """A corrupt record at the cache path (a torn write) is quarantined and
    re-measured — not served as a hit, not a crash — and the re-measured
    record then serves as a clean hit."""
    cache = str(tmp_path / "cache")
    rec = measure_cell(*CELL, cache_dir=cache, target=stub_measure)
    path = os.path.join(cache, request_key(make_request(*CELL)) + ".json")
    with open(path, "w") as f:
        f.write(corrupt)
    assert measure_cell(*CELL, cache_dir=cache, target=stub_measure) == rec
    calls = {"n": 0}

    def counting(req):
        calls["n"] += 1
        return stub_measure(req)

    assert measure_cell(*CELL, cache_dir=cache, target=counting) == rec
    assert calls["n"] == 0


def test_cache_key_includes_devices():
    base = request_key(make_request(*CELL))
    assert request_key(make_request(*CELL, devices=8)) != base
    assert request_key(make_request(*CELL, devices=16)) != request_key(
        make_request(*CELL, devices=8))
    # extras are transport-only: they must never perturb the key
    assert request_key(make_request(*CELL, extras={"inject": {}})) == base


def test_cache_key_includes_hw_device_kind_and_cut():
    plan = SchedulePlan()
    keys = {
        request_key(make_request(*CELL, "card", plan)),
        request_key(make_request(*CELL, "card", plan, hw="tpu-v5e")),
        request_key(make_request(*CELL, "card", plan, device="cuda")),
        request_key(make_request(*CELL, "card", plan, device="cpu")),  # never a card record
        request_key(make_request(*CELL, "card", plan, device="cuda", cut={"layers": 6})),
        request_key(make_request(*CELL, "card", plan, device="cuda", cut={"layers": 12})),
    }
    assert len(keys) == 6
    # the spec's name or its hw= name: one key
    assert request_key(make_request(*CELL, hw="h100")) == request_key(make_request(*CELL))


# fields the card's step never reads on a 1x1 mesh, by cell kind
IGNORED = {
    "train": dict(batch_axes="pod_data", param_strategy="fsdp", mixer_tp=False, seq_shard=True,
                  ffn_tp=False, moe_mode="ep", vocab_shard=False, overlap=0.9, kv_dtype="int8",
                  grad_comm="rs_ag"),
    "prefill": dict(remat="full", microbatches=4, opt_dtype="int8", grad_comm="int8",
                    overlap=0.0, kv_dtype="int8", moe_mode="tp"),
    "decode": dict(remat="dots", attn_block=(128, 128), scan_chunk=64, microbatches=8,
                   opt_dtype="int8", param_strategy="replicated"),
}
READ = {
    "train": dict(remat="full", microbatches=2, opt_dtype="int8", grad_comm="int8",
                  attn_block=(128, 256), scan_chunk=64),
    "prefill": dict(attn_block=(256, 512), scan_chunk=256),
    "decode": dict(kv_dtype="int8"),
}
KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


@pytest.mark.parametrize("kind", list(KIND_SHAPE))
def test_card_key_is_the_program(kind):
    """On mesh ``card`` a real measurement keys on the fields the card's step
    reads: plans that differ elsewhere share one key, any read field makes a
    new one, and ``microbatches`` counts only up to the cut's rows."""
    arch, shape = "granite-moe-1b-a400m", KIND_SHAPE[kind]

    def key(plan, **kw):
        return request_key(make_request(arch, shape, "card", plan, device="cuda", **kw))

    base = SchedulePlan()
    assert key(dataclasses.replace(base, **IGNORED[kind])) == key(base)
    for field, value in READ[kind].items():
        assert key(dataclasses.replace(base, **{field: value})) != key(base), field
    if kind == "train":
        assert key(dataclasses.replace(base, microbatches=4)) == key(
            dataclasses.replace(base, microbatches=16))  # both run 2 microbatches of 1 row
    # the stub (no device) and other meshes key on the whole plan
    other = dataclasses.replace(base, **IGNORED[kind])
    assert request_key(make_request(arch, shape, "card", other)) != request_key(
        make_request(arch, shape, "card", base))


def test_program_of_reads_the_kinds_fields():
    plan = SchedulePlan(microbatches=16, attn_block=(256, 512))
    assert measure.program_of(plan, "train") == {
        "remat": plan.remat, "microbatches": 2, "opt_dtype": plan.opt_dtype,
        "grad_comm": plan.grad_comm, "attn_block": [256, 512], "scan_chunk": plan.scan_chunk}
    assert measure.program_of(plan.to_dict(), "decode") == {"kv_dtype": plan.kv_dtype}
    for comm, program in (("fp32", "fp32"), ("rs_ag", "fp32"), ("int8", "int8")):
        got = measure.program_of(dataclasses.replace(plan, grad_comm=comm), "train")
        assert got["grad_comm"] == program
    assert measure.program_of(plan, "prefill") == {"attn_block": [256, 512],
                                                      "scan_chunk": plan.scan_chunk}


# ---------------------------------------------------------------------------
# the subprocess client through the port's stub CLI
def test_timeout_surfaces_runtime_error_without_residue(tmp_path, monkeypatch):
    """``subprocess.TimeoutExpired`` surfaces as the standard RuntimeError
    (naming the timeout) and leaves nothing on disk."""
    monkeypatch.setattr(measure, "DRYRUN_MODULE", "repro_torch.launch.dryrun_stub")
    monkeypatch.setenv("REPRO_STUB_SLEEP_S", "30")
    cache = str(tmp_path / "cache")
    with pytest.raises(RuntimeError, match="timed out after 1s"):
        measure.measure_cell(*CELL, cache_dir=cache, timeout=1.0)
    assert os.listdir(cache) == []  # no partial record, no tmp residue


@pytest.mark.parametrize("hw", ["h100", "tpu-v5e"])
def test_stub_cli_record_equals_the_in_process_stub(tmp_path, monkeypatch, hw):
    monkeypatch.setattr(measure, "DRYRUN_MODULE", "repro_torch.launch.dryrun_stub")
    plan = SchedulePlan(remat="full", microbatches=4)
    got = measure.measure_cell(*CELL, plan=plan, cache_dir=str(tmp_path), timeout=120.0, hw=hw)
    req = make_request(*CELL, plan=plan, hw=hw)
    assert got == json.loads(json.dumps(stub_measure(req)))
    assert got["step_s"] == AnalyticCostModel(
        get_config(CELL[0]), get_shape(CELL[1]), get_mesh(hw, "single"),
        get_hardware(hw)).terms(plan).step_s


# ---------------------------------------------------------------------------
# the fleet
@pytest.mark.parametrize("kind", ["kill", "sleep"])
def test_fleet_injected_fault_retries_identical_to_serial(tmp_path, kind):
    """A worker SIGKILLed mid-request (``kill``), or stalled past its
    deadline and killed by the watchdog (``sleep``), is respawned; the
    request re-dispatches within the retry budget and the cache record is
    byte-identical to the serial ``measure_cell`` path's."""
    timeout = 30.0 if kind == "kill" else 0.4
    grace = 10.0 if kind == "kill" else 0.4
    with _fleet(tmp_path, n=2 if kind == "kill" else 1, timeout=timeout, grace_s=grace) as fleet:
        marker = str(tmp_path / f"{kind}.marker")
        inject = {"marker": marker, "kind": kind, "sleep_s": 30}
        req = make_request(*CELL, timeout=timeout, extras={"inject": inject})
        out = fleet.measure_many([req])[0]
        assert out.ok and out.retries == 1
        assert (out.worker_deaths, out.timeouts) == ((1, 0) if kind == "kill" else (0, 1))
        assert fleet.n_worker_restarts == 1 and fleet.n_timeouts == (kind == "sleep")
        serial_cache = str(tmp_path / "serial_cache")
        assert out.record == measure_cell(*CELL, cache_dir=serial_cache, target=stub_measure)
        key = request_key(req)
        with open(os.path.join(fleet.cache_dir, key + ".json"), "rb") as f:
            fleet_bytes = f.read()
        with open(os.path.join(serial_cache, key + ".json"), "rb") as f:
            assert f.read() == fleet_bytes


def test_fleet_quarantines_corrupt_cache_entry(tmp_path):
    with _fleet(tmp_path) as fleet:
        req = make_request(*CELL)
        os.makedirs(fleet.cache_dir, exist_ok=True)
        path = os.path.join(fleet.cache_dir, request_key(req) + ".json")
        with open(path, "w") as f:
            f.write("not json at all")
        out = fleet.measure_many([req])[0]
        assert out.ok and not out.from_cache
        assert fleet.n_measured == 1 and fleet.n_cache_hits == 0
        with open(path) as f:
            assert json.load(f)["step_s"] == out.record["step_s"]


def test_fleet_single_flight_dedup(tmp_path):
    """Five concurrent requests for the same plan run once; all five share
    the record.  A second batch is pure cache hits."""
    with _fleet(tmp_path) as fleet:
        outs = fleet.measure_many([make_request(*CELL) for _ in range(5)])
        assert all(o.ok for o in outs)
        assert fleet.n_measured == 1 and fleet.n_deduped == 4
        assert len({id(o) for o in outs}) == 1  # one shared outcome
        again = fleet.measure_many([make_request(*CELL)])
        assert again[0].from_cache and fleet.n_measured == 1


def test_fleet_exhausted_retries_fail_without_raising(tmp_path):
    with _fleet(tmp_path, n=1, target=failing_measure, max_retries=1) as fleet:
        out = fleet.measure_many([make_request(*CELL)])[0]
        assert not out.ok and out.retries == 1
        assert "deliberate failure" in out.error
        assert fleet.n_failures == 1
        assert os.listdir(fleet.cache_dir) == []  # failures never cached
        with pytest.raises(RuntimeError, match="deliberate failure"):
            fleet.measure_cell(*CELL)


def test_card_measurements_take_a_one_worker_fleet(tmp_path):
    with _fleet(tmp_path, n=2) as fleet:
        with pytest.raises(ValueError, match="one-worker"):
            fleet.bind(*CELL, mesh="card", device="cuda")
        fleet.bind(*CELL, mesh="card", device="cpu")  # the CPU may take more
    with _fleet(tmp_path, n=1) as fleet:
        fm = fleet.bind(*CELL, mesh="card", device="cuda", cut={"layers": 6})
        assert fm._request(SchedulePlan())["cut"] == {"layers": 6}


@pytest.mark.parametrize("hw", ["tpu-v5e", "h100"])
def test_measure_failure_degrades_to_analytic(hw):
    """A raising measure_fn inside mcts_cost+real_* must not kill the run:
    the candidate re-ranks by its exact analytic cost and the failure is
    counted on TuneResult.n_measure_failures.  The run's schedule costs what
    a plain un-measured run's does; on tpu-v5e it is that schedule, while
    the H100 spec prices several of the cell's plans alike (sharding choices
    that cost the same), and the re-rank's candidate order may take another
    of them."""
    calls = {"n": 0}

    def flaky(plan):
        calls["n"] += 1
        raise RuntimeError("the card run exploded")

    cfg = MCTSConfig(iters_per_decision=4)
    res = ProTuner(make_mdp(*CELL, hw=hw), n_standard=2, n_greedy=1, mcts_config=cfg, seed=3,
                   measure_fn=flaky).run()
    assert calls["n"] > 0
    assert res.n_measure_failures > 0
    assert res.measured is None  # degraded analytic values are not
    assert res.cost > 0          # reported as real measurements
    plain = ProTuner(make_mdp(*CELL, hw=hw), n_standard=2, n_greedy=1, mcts_config=cfg,
                     seed=3).run()
    assert res.cost == plain.cost
    if hw == "tpu-v5e":
        assert res.plan == plain.plan


def test_fleet_backend_batches_ensemble_measurements(tmp_path):
    """measure_backend= threads a fleet through the ensemble: candidate
    measurements prefetch through measure_plans, and the results match the
    serial measure_fn path."""

    def serial_fn(plan):
        return stub_measure(make_request(*CELL, plan=plan))["step_s"]

    cfg = MCTSConfig(iters_per_decision=4)
    serial = ProTuner(make_mdp(*CELL), n_standard=2, n_greedy=1, mcts_config=cfg,
                      seed=5, measure_fn=serial_fn).run()
    with _fleet(tmp_path) as fleet:
        res = ProTuner(make_mdp(*CELL), n_standard=2, n_greedy=1, mcts_config=cfg,
                       seed=5, measure_backend=fleet.bind(*CELL)).run()
        assert fleet.n_measured > 0  # prefetches actually hit the fleet
    assert res.plan == serial.plan
    assert res.measured == pytest.approx(serial.measured)
    assert res.n_measure_failures == 0
    assert res.n_measurements == serial.n_measurements


# ---------------------------------------------------------------------------
# the stub and the measured search against the JAX package's, on tpu-v5e
def _plans(arch, shape_name):
    space = ScheduleSpace(get_config(arch), get_shape(shape_name), SINGLE_POD, TPU_V5E)
    default = space.plan_from_actions(space.default_actions())
    return [None, default, dataclasses.replace(default, remat="full", microbatches=4,
                                               kv_dtype="int8", overlap=0.9)]


@pytest.mark.parametrize("cell", list(CELLS))
def test_stub_record_on_tpu_v5e_equals_the_jax_stub(cell):
    arch, shape_name = CELLS[cell]
    for plan in _plans(arch, shape_name):
        d = None if plan is None else plan.to_dict()
        for mesh in ("single", "multi"):
            got = stub_measure(make_request(arch, shape_name, mesh, d, hw="tpu-v5e"))
            ref = jax_stub_measure({"arch": arch, "shape": shape_name, "mesh": mesh, "plan": d,
                                    "devices": None})
            assert got == ref


@pytest.mark.parametrize("cell", list(CELLS))
def test_measured_search_on_tpu_v5e_equals_the_jax_search(cell, tmp_path):
    """``mcts_cost+real_1s`` with the stub as ``measure_fn`` (the port's
    through ``make_measure_fn`` and its on-disk cache): the same plan, cost,
    measured time, measurement count and decision trace as the JAX
    package's, in float equality."""
    arch, shape_name = CELLS[cell]
    port_fn = measure.make_measure_fn(arch, shape_name, cache_dir=str(tmp_path),
                                      target=stub_measure, hw="tpu-v5e")

    def jax_fn(plan):
        return jax_stub_measure({"arch": arch, "shape": shape_name, "mesh": "single",
                                 "plan": plan.to_dict(), "devices": None})["step_s"]

    cfg, shape = get_config(arch).reduced(), get_shape(shape_name)
    port_mdp = ScheduleMDP(ScheduleSpace(cfg, shape, SINGLE_POD, TPU_V5E),
                           AnalyticCostModel(cfg, shape, SINGLE_POD, TPU_V5E))
    ref = jax_autotune(arch, shape_name, algo="mcts_cost+real_1s", seed=0,
                       mdp=make_cell_mdp(arch, shape_name), measure_fn=jax_fn, **SMALL)
    got = autotune(arch, shape_name, algo="mcts_cost+real_1s", seed=0, hw="tpu-v5e",
                   mdp=port_mdp, measure_fn=port_fn, **SMALL)
    assert got.n_measurements == ref.n_measurements > 0
    assert got.plan.to_dict() == ref.plan.to_dict()
    assert (got.cost, got.measured) == (ref.cost, ref.measured)
    assert got.n_measure_failures == ref.n_measure_failures == 0
    strip = lambda r: [{k: v for k, v in d.items() if k != "wall_time_s"}  # noqa: E731
                       for d in r.decisions]
    assert strip(got) == strip(ref)


@pytest.mark.parametrize("hw", ["tpu-v5e", "h100"])
def test_combine_terms_is_the_jax_formula(hw):
    from repro.core.measure import combine_terms as jax_combine_terms

    spec = get_hardware(hw)
    args = (3.1e18, 2.2e15, 4.0e11, 256, 0.5)
    got = measure.combine_terms(*args, hw=hw)
    if hw == "tpu-v5e":
        assert got == jax_combine_terms(*args)
    assert got["compute_s"] == 3.1e18 / (256 * spec.peak_flops)
    assert got["step_s"] == max(got["compute_s"], got["memory_s"]) + 0.5 * got["collective_s"]


# ---------------------------------------------------------------------------
# the card's measurement, run on the CPU
RECORD_FIELDS = {
    "arch", "shape", "mesh", "devices", "hw", "plan", "program", "cut", "projection",
    "measured_s", "measured_runs_s", "spread_s", "step_s", "compute_s", "memory_s",
    "collective_s", "model_step_s", "dominant", "feasible", "terms_source", "model_flops",
    "chips", "mfu", "peak_bytes", "fits_hbm", "device", "source",
}


@pytest.mark.parametrize("kind", list(KIND_SHAPE))
def test_launch_measure_on_cpu_returns_every_field(kind):
    arch, shape_name = "granite-moe-1b-a400m", KIND_SHAPE[kind]
    plan = SchedulePlan(microbatches=4, opt_dtype="int8", kv_dtype="int8", attn_block=(16, 32))
    rec = card.evaluate_cell(arch, shape_name, "card", plan, device="cpu", cut=CPU_CUT,
                             verbose=False)
    assert set(rec) == RECORD_FIELDS
    assert rec["source"] == "cpu" and rec["device"]["name"] == "cpu"
    assert rec["program"] == measure.program_of(plan, kind)
    shape, cfg = get_shape(shape_name), get_config(arch).reduced()
    assert rec["cut"]["rows"] == measure.CUT_ROWS[kind] and rec["cut"]["seq"] == 32
    assert rec["cut"]["layers"] == rec["cut"]["n_layers"] == cfg.n_layers
    factor = shape.global_batch / measure.CUT_ROWS[kind] * shape.seq_len / 32
    assert rec["projection"]["factor"] == pytest.approx(factor)
    assert rec["step_s"] == pytest.approx(rec["measured_s"] * factor)
    assert len(rec["measured_runs_s"]) >= 2 and rec["measured_s"] > 0
    terms = AnalyticCostModel(cfg, shape, get_mesh("h100", "card"),
                              get_hardware("h100")).terms(plan)
    assert rec["model_step_s"] == terms.step_s and rec["compute_s"] == terms.compute_s
    assert rec["mfu"] == pytest.approx(rec["model_flops"] / (rec["step_s"] * 989e12))
    json.dumps(rec)  # a JSON record


def test_launch_measure_depth_cut_projects_in_layers():
    rec = card.evaluate_cell("granite-moe-1b-a400m", "prefill_32k", "card", None, device="cpu",
                             cut={"reduced": True, "seq": 32, "layers": 1}, verbose=False)
    assert rec["cut"]["layers"] == 1 and rec["projection"]["layers"] == rec["cut"]["n_layers"]
    with pytest.raises(ValueError, match="multiple of its period"):
        card.evaluate_cell("jamba-1.5-large-398b", "prefill_32k", "card", None, device="cpu",
                           cut={"reduced": True, "seq": 32, "layers": 3}, verbose=False)


@pytest.mark.parametrize("kind", list(KIND_SHAPE))
def test_launch_measure_takes_an_embeddings_arch(kind):
    """qwen2-vl-72b takes (rows, seq, d) embeddings and M-RoPE ids, as the
    JAX dry run's input specs have it; every kind of step measures."""
    rec = card.evaluate_cell("qwen2-vl-72b", KIND_SHAPE[kind], "card", None, device="cpu",
                             cut=CPU_CUT, verbose=False)
    assert set(rec) == RECORD_FIELDS and rec["measured_s"] > 0


DRYRUN_FIELDS = {
    "arch", "shape", "mesh", "devices", "plan", "hw", "source", "chips", "rank", "step_s",
    "compute_s", "memory_s", "collective_s", "dominant", "flops_per_device", "dot_flops_per_device",
    "aten_flops_per_device", "kernel_flops_per_device", "flops_total", "hbm_bytes_total",
    "coll_bytes_per_chip", "coll_wire_bytes_per_chip", "coll_by_kind", "coll_counts", "memory",
    "bytes_per_device", "fits_hbm", "launches", "model_flops", "useful_flops_ratio", "mfu",
    "dryrun_s",
}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_launch_measure_of_a_mesh_returns_a_dry_run_record(mesh, tmp_path):
    """Meshes ``single`` and ``multi`` take the production-mesh dry run: one
    rank's step of the full config counted on the meta device, whatever
    device the request names; it takes no cut, and its request key carries
    its source and neither device nor cut."""
    arch, shape = "granite-moe-1b-a400m", "decode_32k"
    rec = card.evaluate_cell(arch, shape, mesh, None, device="cpu", verbose=False)
    assert set(rec) == DRYRUN_FIELDS and rec["source"] == "dryrun" and rec["mesh"] == mesh
    assert rec["chips"] == {"single": 8, "multi": 16}[mesh] and rec["step_s"] > 0
    assert rec["launches"]["moe_gemm"] == 3 * get_config(arch).n_layers
    assert rec["coll_by_kind"]["all-reduce"] > 0
    with pytest.raises(ValueError, match="no cut"):
        card.evaluate_cell(arch, shape, mesh, None, device="cpu", cut=CPU_CUT, verbose=False)
    out = tmp_path / "rec.json"
    assert card.main(["--arch", arch, "--shape", shape, "--mesh", mesh, "--device", "cpu",
                      "--json-out", str(out)]) == 0
    assert json.loads(out.read_text())["step_s"] == rec["step_s"]
    plan = SchedulePlan(kv_dtype="int8")
    key = request_key(make_request(arch, shape, mesh, plan))
    assert key == request_key(make_request(arch, shape, mesh, plan, device="cuda", cut={"layers": 6}))
    assert key != request_key(make_request(arch, shape, mesh, SchedulePlan()))
    assert key != request_key(make_request(arch, shape, "card", plan))


def test_launch_measure_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        card.evaluate_cell("granite-moe-1b-a400m", "train_4k", "card", None, cut=CPU_CUT)
    with pytest.raises(ValueError, match="names its device"):
        card.CardTarget()(make_request("granite-moe-1b-a400m", "train_4k", "card"))


def test_card_target_in_a_one_worker_fleet_on_cpu(tmp_path):
    """The card target in a persistent worker: two plans of one program are
    measured once (the second resolves on the key), a decode request with an
    int8 cache runs too, and the records say where they were measured."""
    arch = "granite-moe-1b-a400m"
    with _fleet(tmp_path, n=1, target=card.CardTarget(), timeout=300.0) as fleet:
        fm = fleet.bind(arch, "train_4k", "card", device="cpu", cut=CPU_CUT)
        a = SchedulePlan(microbatches=4, opt_dtype="int8")
        b = dataclasses.replace(a, microbatches=16, moe_mode="ep", overlap=0.9)
        times = fm.measure_plans([a, b])
        assert times[0] == times[1] is not None
        assert fleet.n_measured == 1 and fleet.n_deduped == 1
        rec = fleet.measure_cell(arch, "decode_32k", "card", SchedulePlan(kv_dtype="int8"),
                                 hw="h100", device="cpu", cut=CPU_CUT)
        assert rec["program"] == {"kv_dtype": "int8"} and rec["source"] == "cpu"
        assert fleet.n_failures == 0 and fleet.n_worker_restarts == 0


def test_measure_cli_subprocess_on_cpu(tmp_path):
    """``measure_request`` -> ``python -m repro_torch.launch.measure``: exit
    code 0 and the ``--json-out`` record, cut flags passed through."""
    req = make_request("granite-moe-1b-a400m", "decode_32k", "card",
                       SchedulePlan(kv_dtype="int8"), timeout=300.0, device="cpu", cut=CPU_CUT)
    rec = measure.measure_request(req)
    assert set(rec) == RECORD_FIELDS and rec["source"] == "cpu"
    assert rec["cut"]["reduced"] and rec["cut"]["seq"] == 32
    assert rec["plan"]["kv_dtype"] == "int8"

"""The production-mesh dry run (``repro_torch.launch.dryrun_impl``) on the CPU.

(a) Against the JAX package's dry run: its ``_lower_*`` and ``_extract`` on
four forced host devices in a subprocess, for the reduced configs of
granite-3-2b, granite-moe-1b-a400m and falcon-mamba-7b, train, prefill and
decode, on meshes (1,1) and (2,2): ``dot_flops_per_device`` is its
``flops_per_device``, the parameters' and optimizer state's bytes its
arguments' less the batch and the step counter, and the collectives by kind
are pinned on both sides where the port's explicit ones differ from XLA's.
(b) Against a real CPU step of the port, on one device and on a (2,2) gloo
mesh: launches by kernel (the CUDA branch's, counted by
``torch_dist_cases.plain_kernels_counted``), ``FlopCounterMode`` FLOPs and
collective bytes by kind, exactly.  (c) A tile the card cannot launch
raises.  (d) Full-size cells finish with every field: in
``tests/test_torch_dryrun_cells.py``, a file of their own so that a
parallel run takes them beside these.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import torch_dist_cases as dc
from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.space import MeshSpec, SchedulePlan
from repro_torch.kernels import _build, geometry, ops, work
from repro_torch.launch import dryrun, dryrun_impl
from repro_torch.launch.mesh import abstract_mesh, run_on_mesh
from repro_torch.sharding import collectives as cc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-2b", "granite-moe-1b-a400m", "falcon-mamba-7b")
KINDS = ("train", "prefill", "decode")
MESHES = {"1x1": (1, 1), "2x2": (2, 2)}
B, S = 8, 32  # granite-moe's capacity at 256 tokens (C 256, 128 a data rank) splits into its tiles
RECORD_FIELDS = {
    "compute_s", "memory_s", "collective_s", "step_s", "dominant", "flops_per_device",
    "dot_flops_per_device", "aten_flops_per_device", "kernel_flops_per_device", "flops_total",
    "hbm_bytes_total", "coll_bytes_per_chip", "coll_wire_bytes_per_chip", "coll_by_kind",
    "coll_counts", "memory", "bytes_per_device", "fits_hbm", "launches", "model_flops",
    "useful_flops_ratio", "mfu", "chips", "rank", "hw", "source", "dryrun_s",
}
MEMORY_FIELDS = {"params_bytes", "opt_state_bytes", "cache_bytes", "batch_bytes", "resident_bytes",
                 "peak_bytes"}


def _plan(arch: str, mesh: str) -> dict:
    """Expert parallelism for the MoE on (2,2): the reference's shard_map
    path, whose products the port's EP runs as they are; its dense and tp
    modes leave the partition of the experts to XLA."""
    return {"moe_mode": "ep"} if arch == "granite-moe-1b-a400m" and mesh == "2x2" else {}


CELLS = [(a, k, m) for a in ARCHS for k in KINDS for m in MESHES]
IDS = [f"{a}-{k}-{m}" for a, k, m in CELLS]

JAX_DRYRUN = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {src!r})
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core.space import MeshSpec, SchedulePlan
from repro.launch.mesh import make_mesh_from_spec
from repro.launch import dryrun_impl as D
out = {{}}
for arch, kind, mesh, plan in {cells!r}:
    cfg = get_config(arch).reduced()
    shape = InputShape(kind, {S}, {B}, kind)
    spec = MeshSpec(("data", "model"), tuple(mesh))
    lower = {{"train": D._lower_train, "prefill": D._lower_prefill, "decode": D._lower_decode}}[kind]
    rec = D._extract(lower(cfg, shape, SchedulePlan(**plan), make_mesh_from_spec(spec), spec).compile(),
                     cfg, shape, SchedulePlan(**plan), spec)
    out["/".join([arch, kind, "x".join(map(str, mesh))])] = dict(
        flops=rec["flops_per_device"], args=rec["memory_analysis"]["argument_size_in_bytes"],
        coll=rec["coll_by_kind"])
json.dump(out, open({out!r}, "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's dry-run records of ``CELLS``, from one subprocess."""
    out = str(tmp_path_factory.mktemp("jax_dryrun") / "records.json")
    cells_ = [(a, k, list(MESHES[m]), _plan(a, m)) for a, k, m in CELLS]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    code = JAX_DRYRUN.format(src=os.path.join(ROOT, "src"), cells=cells_, S=S, B=B, out=out)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def _dry(arch, kind, mesh_shape, plan, rank=0, local=False):
    cfg = get_config(arch).reduced()
    return dryrun_impl.dry_run(cfg, InputShape(kind, S, B, kind), SchedulePlan(**plan),
                               MeshSpec(("data", "model"), tuple(mesh_shape)), rank=rank, local=local)


@pytest.fixture(scope="module")
def port():
    return {f"{a}/{k}/{m}": _dry(a, k, MESHES[m], _plan(a, m)) for a, k, m in CELLS}


# ---------------------------------------------------------------------------
# (a) against the JAX package's dry run
def _scan_outer_products(arch, kind, mesh):
    """The one named difference in FLOPs: autograd of the plain scan's
    ``y_t = <x_t, C_t>`` gives ``dx_t = gy_t C_t^T``, an outer product that
    torch runs as a ``bmm`` with a contraction of one (counted, 2 B Di N a
    step) and XLA folds into a multiply (no ``dot``): 2 (B/dp) L (Di/tp) N a
    Mamba layer of a train step."""
    cfg = get_config(arch).reduced()
    if kind != "train" or cfg.family != "ssm":
        return 0
    dp, tp = MESHES[mesh]
    return 2 * (B // dp) * S * (cfg.d_inner // tp) * cfg.ssm_state * cfg.n_layers


@pytest.mark.parametrize("arch,kind,mesh", CELLS, ids=IDS)
def test_dot_flops_equal_the_reference(reference, port, arch, kind, mesh):
    key = f"{arch}/{kind}/{mesh}"
    got, ref = port[key]["dot_flops_per_device"], reference[key]["flops"]
    assert got == ref + _scan_outer_products(arch, kind, mesh)
    if (arch, kind, mesh) == ("granite-3-2b", "train", "1x1"):
        assert ref == 155_189_248  # at 8 x 32 (343,932,928 at 8 x 64)


@pytest.mark.parametrize("arch,kind,mesh", CELLS, ids=IDS)
def test_resident_bytes_equal_the_reference_arguments(reference, port, arch, kind, mesh):
    """The reference's arguments are the parameters, optimizer state and
    cache, the rank's rows of the batch in int32 (the port's ids are
    int64), the train step's 4-byte counter and decode's 4-byte ``cur``;
    ``jax.jit`` drops an argument the step never reads: an arch without
    positions (falcon-mamba) passes neither the positions nor ``cur``."""
    key = f"{arch}/{kind}/{mesh}"
    mem = port[key]["memory"]
    dp = MESHES[mesh][0]
    positions = get_config(arch).pos_kind != "none"
    tensors, seq = {"train": (2 + positions, S), "prefill": (1 + positions, S), "decode": (1, 1)}[kind]
    batch_i32 = B // dp * seq * tensors * 4
    scalar = {"train": 4, "prefill": 0, "decode": 4 * positions}[kind]
    assert (mem["params_bytes"] + mem["opt_state_bytes"] + mem["cache_bytes"] + batch_i32 + scalar
            == reference[key]["args"])
    assert mem["resident_bytes"] == (mem["params_bytes"] + mem["opt_state_bytes"]
                                     + mem["cache_bytes"] + mem["batch_bytes"])


# XLA's partitioner re-lays activations with all-to-all and collective-permute
# (the port never re-lays them: each rank holds the layout its use needs) and
# sums the FSDP gradients and the tensor-parallel partial sums in all-reduces
# of its own sizes, where the port gathers weights on use (the backward a
# reduce-scatter) and all-reduces what Megatron's regions leave: both pinned.
COLL_22 = {
    ("granite-3-2b", "train"): (
        {"all-gather": 180224.0, "all-reduce": 395992.0, "reduce-scatter": 212992.0}, 682714.0,
        {"all-gather": 196608.0, "all-reduce": 707348.0, "collective-permute": 512.0,
         "all-to-all": 65536.0}),
    ("granite-3-2b", "prefill"): (
        {"all-gather": 172032.0, "all-reduce": 163840.0}, 335872.0,
        {"all-gather": 122880.0, "all-reduce": 131072.0, "collective-permute": 512.0,
         "all-to-all": 32768.0}),
    ("granite-3-2b", "decode"): (
        {"all-gather": 112640.0, "all-reduce": 5120.0}, 117760.0,
        {"all-gather": 90128.0, "all-reduce": 5120.0, "collective-permute": 16.0, "all-to-all": 1024.0}),
    ("granite-moe-1b-a400m", "train"): (
        {"all-gather": 475136.0, "all-reduce": 367320.0, "reduce-scatter": 507904.0}, 1096410.0,
        {"all-gather": 491520.0, "all-reduce": 611092.0, "reduce-scatter": 393216.0,
         "collective-permute": 512.0, "all-to-all": 65536.0}),
    ("granite-moe-1b-a400m", "prefill"): (
        {"all-gather": 319488.0, "all-reduce": 131072.0}, 450560.0,
        {"all-gather": 270336.0, "all-reduce": 131072.0, "collective-permute": 512.0,
         "all-to-all": 32768.0}),
    ("granite-moe-1b-a400m", "decode"): (
        {"all-gather": 260096.0, "all-reduce": 4096.0}, 264192.0,
        {"all-gather": 237584.0, "all-reduce": 5120.0, "collective-permute": 16.0,
         "all-to-all": 1024.0}),
    ("falcon-mamba-7b", "train"): (
        {"all-gather": 153600.0, "all-reduce": 274140.0, "reduce-scatter": 186368.0}, 520926.0,
        {"all-gather": 163840.0, "collective-permute": 267264.0, "all-reduce": 268064.0,
         "all-to-all": 327680.0}),
    ("falcon-mamba-7b", "prefill"): (
        {"all-gather": 158720.0, "all-reduce": 122880.0}, 281600.0,
        {"all-gather": 106496.0, "collective-permute": 133120.0, "all-reduce": 92160.0,
         "all-to-all": 32768.0}),
    ("falcon-mamba-7b", "decode"): (
        {"all-gather": 99328.0, "all-reduce": 3840.0}, 103168.0,
        {"all-gather": 72720.0, "collective-permute": 4112.0, "all-reduce": 3840.0,
         "all-to-all": 1792.0}),
}


@pytest.mark.parametrize("arch,kind,mesh", CELLS, ids=IDS)
def test_collectives_against_the_reference(reference, port, arch, kind, mesh):
    key = f"{arch}/{kind}/{mesh}"
    rec, ref = port[key], reference[key]["coll"]
    if mesh == "1x1":
        assert rec["coll_by_kind"] == ref == {} and rec["coll_wire_bytes_per_chip"] == 0
        return
    by_kind, wire, ref_by_kind = COLL_22[(arch, kind)]
    assert rec["coll_by_kind"] == by_kind and rec["coll_wire_bytes_per_chip"] == wire
    assert ref == ref_by_kind
    assert rec["coll_bytes_per_chip"] == sum(by_kind.values())


def test_collective_counts_follow_the_ring_formulas():
    """Each raw collective on meta counts the reference's operand and wire
    bytes (``core/hlo_analysis.py``'s ring formulas) at its group's size, and
    returns the shape that size implies."""
    mesh = abstract_mesh(MeshSpec(("pod", "data", "model"), (2, 3, 4)), rank=17)
    x = torch.empty((12, 8), dtype=torch.bfloat16, device="meta")
    s = 12 * 8 * 2
    cc.reset_counters()
    assert cc.all_gather_raw(x, mesh, "model", 0).shape == (48, 8)
    assert cc.reduce_scatter_raw(x, mesh, ("pod", "data"), 0).shape == (2, 8)
    assert cc.all_reduce_(x, mesh, "data") is x
    assert cc.ppermute(x, mesh, "model").shape == x.shape
    assert cc.all_gather_raw(x, mesh, ("pod",), 1).shape == (12, 16)
    out = cc.softmax_combine(torch.empty((3, 5), device="meta"), torch.empty((3,), device="meta"),
                             mesh, "model")
    assert out.shape == (3, 5)
    assert cc.COLL == {
        ("all-gather", 4): [1, s, s * 3], ("all-gather", 2): [1, s, s * 1],
        ("reduce-scatter", 6): [1, s, s * 5 / 6],
        ("all-reduce", 3): [1, s, 2 * s * 2 / 3],
        ("all-reduce", 4): [2, 3 * 4 + (3 * 5 + 3) * 4, 2 * (3 * 4 + (3 * 5 + 3) * 4) * 3 / 4],
        ("collective-permute", 4): [1, s, s],
    }
    cc.reset_counters()
    assert cc.all_gather_raw(x, mesh, (), 0) is x and cc.COLL == {}  # a group of one moves nothing


# ---------------------------------------------------------------------------
# (b) against a real CPU step of the port
REAL_CASES = [
    dict(arch="granite-3-2b", kind="train", plan=dict(opt_dtype="int8", grad_comm="int8"), B=B, S=S),
    dict(arch="granite-moe-1b-a400m", kind="train", plan=dict(moe_mode="ep"), B=B, S=S),
    dict(arch="falcon-mamba-7b", kind="train", plan=dict(remat="full"), B=B, S=S),
    dict(arch="granite-3-2b", kind="decode", plan=dict(kv_dtype="int8"), B=B, S=S),
    dict(arch="granite-moe-1b-a400m", kind="prefill", plan=dict(moe_mode="ep"), B=B, S=S),
]
REAL_IDS = [f"{c['arch']}-{c['kind']}" for c in REAL_CASES]


def _assert_equal(real: dict, rec: dict) -> None:
    assert rec["launches"] == real["launches"]
    assert rec["dot_flops_per_device"] == real["flops"]
    assert rec["coll_by_kind"] == real["coll"]["by_kind"]
    assert rec["coll_counts"] == real["coll"]["counts"]
    assert rec["coll_wire_bytes_per_chip"] == real["coll"]["wire"]


@pytest.mark.parametrize("case", REAL_CASES, ids=REAL_IDS)
def test_dry_run_equals_a_real_cpu_step(case):
    real = dc.real_counts(None, case)
    rec = _dry(case["arch"], case["kind"], (1, 1), case["plan"], local=True)
    assert sum(real["launches"].values()) > 0
    _assert_equal(real, rec)


@pytest.fixture(scope="module")
def gloo_22():
    return run_on_mesh(MeshSpec(("data", "model"), (2, 2)), dc.real_counts_cases, REAL_CASES,
                       device="cpu")


@pytest.mark.parametrize("i", range(len(REAL_CASES)), ids=REAL_IDS)
def test_dry_run_equals_a_real_gloo_step(gloo_22, i):
    case = REAL_CASES[i]
    for rank in range(4):
        rec = _dry(case["arch"], case["kind"], (2, 2), case["plan"], rank=rank)
        assert rec["coll_by_kind"], "a (2,2) step runs collectives"
        _assert_equal(gloo_22[rank][i], rec)


def test_no_meta_tensor_reaches_a_launch(monkeypatch):
    """Every kernel's meta branch records its launch and never resolves a
    ``ctypes`` launcher."""
    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached a ctypes launch")

    monkeypatch.setattr(_build, "launcher", refuse)
    seen = set()
    for case in REAL_CASES:
        rec = _dry(case["arch"], case["kind"], (2, 2), case["plan"])
        seen |= {k for k, v in rec["launches"].items() if v}
    assert seen == set(ops.COUNTERS)  # every kernel of the port
    assert sum(work.DRY.launches.values()) > 0


# ---------------------------------------------------------------------------
# work.py: the bound columns' formulas
def test_work_formulas_are_the_bound_columns():
    """``work.py`` against the bounds ``PERF.md`` section 6 states (H100:
    3.35 TB/s, 989 TFLOP/s bf16, 67 f32)."""
    hbm, peak = 3.35e12, {"bfloat16": 989e12, "float32": 67e12}
    for Sq, Skv in ((4096, 4096), (1, 4096), (17, 5), (5, 17), (256, 300)):
        loop = sum(min(Skv, max(0, Skv - Sq + i + 1)) for i in range(Sq))
        assert work.visible_pairs(Sq, Skv, True) == loop
    fa = work.flash_attention(1, 32, 8, 4096, 4096, 64, "bfloat16")
    assert fa.flops == 4 * 64 * (4096 * 4097 // 2) * 32
    assert work.bound_ms(fa, hbm, peak) == pytest.approx((0.0695, "operations"), abs=5e-5)
    bwd = work.flash_attention_backward(1, 32, 8, 4096, 4096, 160, "bfloat16")
    assert bwd.flops == pytest.approx(429.6e9, rel=1e-3)
    assert work.bound_ms(bwd, hbm, peak)[0] == pytest.approx(0.4344, abs=5e-5)
    ms, by = work.bound_ms(work.rmsnorm(4096 * 2048, 2048, "bfloat16"), hbm, peak)
    assert (round(ms, 4), by) == (0.0100, "bytes")
    ms, by = work.bound_ms(work.selective_scan(1, 4096, 8192, 16, "bfloat16"), hbm, peak)
    assert (round(ms, 4), by) == (0.0603, "bytes")
    ms, by = work.bound_ms(work.quantize_int8(92160, 13824, "float32"), hbm, peak)
    assert (round(ms, 4), by) == (1.9016, "bytes")
    ms, by = work.bound_ms(work.quantize_int8(5120, 100352, "bfloat16"), hbm, peak)
    assert (round(ms, 4), by) == (0.4601, "bytes")
    ms, by = work.bound_ms(work.dequantize_int8(5120, 100352, "float32"), hbm, peak)
    assert (round(ms, 4), by) == (0.7669, "bytes")
    assert work.moe_gemm(32, 256, 1024, 512, "bfloat16") == work.Work(
        2 * 32 * 256 * 1024 * 512, (32 * 256 * 1024 + 32 * 1024 * 512 + 32 * 256 * 512) * 2,
        "bfloat16")
    assert work.rmsnorm_backward(10, 5, "float32") == work.Work(100, 3 * 10 * 4 + 2 * 5 * 4, "float32")
    assert work.selective_scan_backward(1, 2, 3, 4, "float32") == work.Work(
        25 * 24, (5 * 6 + 4 * 8) * 4 + 2 * (12 + 3) * 4, "float32")


# ---------------------------------------------------------------------------
# (c) what the card cannot launch raises here too
def test_tiles_the_card_cannot_launch_raise():
    # the (256, 256) flash tile at head_dim 128 needs 640 threads
    cfg = get_config("nemotron-4-15b")
    assert cfg.resolved_head_dim == 128
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    plan = SchedulePlan(attn_block=(256, 256))
    with pytest.raises(ValueError, match="640 threads"):
        dryrun_impl.dry_run(cfg1, InputShape("p", 4096, 1, "prefill"), plan,
                            MeshSpec(("data", "model"), (1, 1)), local=True)
    dryrun_impl.dry_run(cfg1, InputShape("p", 4096, 1, "prefill"), SchedulePlan(attn_block=(128, 256)),
                        MeshSpec(("data", "model"), (1, 1)), local=True)
    # granite-moe at 2,048 tokens: capacity C 640, which the backward's
    # dw = x^T dy takes as its contraction against block_d 256
    moe = get_config("granite-moe-1b-a400m")
    moe1 = dataclasses.replace(moe, n_layers=1)
    with pytest.raises(ValueError, match=r"does not divide \(C=\d+, f=\d+, d=640\)"):
        dryrun_impl.dry_run(moe1, InputShape("t", 2048, 1, "train"), SchedulePlan(remat="none"),
                            MeshSpec(("data", "model"), (1, 1)), local=True)
    with pytest.raises(ValueError):
        geometry.moe_gemm_launch(32, 1024, 640, 512, "bfloat16", 128, 256, 256)


# ---------------------------------------------------------------------------
# the CLI and the cells (the full-size cells: tests/test_torch_dryrun_cells.py)
def test_cli_writes_a_record(tmp_path):
    out = tmp_path / "rec.json"
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k", "--mesh", "multi",
                        "--json-out", str(out), "--plan-json", '{"kv_dtype": "int8"}']) == 0
    rec = json.loads(out.read_text())
    assert rec["mesh"] == "multi" and rec["chips"] == 16 and rec["plan"]["kv_dtype"] == "int8"
    assert rec["launches"]["quantize_int8"] > 0 and RECORD_FIELDS <= set(rec)
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k", "--devices", "4"]) == 2
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k"]) == 1


def test_cells_are_the_reference_cells():
    got = [(c.name, s.name) for c, s in cells()]
    assert ("deepseek-67b", "long_500k") not in got and ("falcon-mamba-7b", "long_500k") in got
    assert len([c for c, s in cells(include_skipped=True)]) == len(ARCH_IDS) * len(SHAPES)
    assert {a for a, _ in got} == set(ARCH_IDS)


def test_the_scans_plain_products_extend_from_two_steps():
    """``work.per_step``: the plain scan's products (forward, and autograd's
    backward) counted from its first two steps equal a walk of every step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.ref import selective_scan as plain

    B, L, Di, N = 2, 37, 16, 4
    ins = [torch.empty(s, device="meta") for s in ((B, L, Di), (B, L, Di), (Di, N), (B, L, N),
                                                    (B, L, N), (Di,))]
    needs = (True,) * 6
    fwd = work.per_step(L, lambda l: work.plain_products(
        ("test-fwd", l), lambda: plain(*(t[:, :l] if t.ndim == 3 else t for t in ins))))
    bwd = work.per_step(L, lambda l: work.autograd_products(
        ("test", l), plain, [t[:, :l] if t.ndim == 3 else t for t in ins], needs,
        torch.empty((B, l, Di), device="meta")))
    counter = FlopCounterMode(display=False)
    with counter:
        plain(*ins)
    assert fwd == counter.get_total_flops() == 2 * B * L * Di * N
    grads = [t.detach().requires_grad_() for t in ins]
    counter = FlopCounterMode(display=False)
    with counter:
        torch.autograd.grad(plain(*grads), grads, torch.empty((B, L, Di), device="meta"))
    assert fwd + bwd == counter.get_total_flops()

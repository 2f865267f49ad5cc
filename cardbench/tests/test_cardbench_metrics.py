"""The metric arithmetic on synthetic profiler events and run records."""
import types

import numpy as np
import pytest

from cardbench import bench, trace, work


def test_cardbench_merge_intervals():
    got = trace.merge(np.array([[5, 9], [0, 3], [2, 4], [9, 12], [20, 21]]))
    assert got.tolist() == [[0, 4], [5, 12], [20, 21]]


def test_cardbench_summary_busy_gaps_and_names():
    device = [("k_a", 0, 10), ("k_b", 5, 20), ("selective_scan_kernel", 30, 40), ("k_a", 60, 70)]
    host = [("step", 0, 80, True), ("aten::mm", 18, 35, False), ("aten::add", 22, 24, False),
            ("tokens_to_host", 40, 80, True), ("aten::copy_", 41, 79, False)]
    s = trace.summarize(device, host, window_s=80e-9)
    assert s.busy_s == pytest.approx(40e-9)
    assert s.device_ops["k_a"] == pytest.approx(20e-9)
    names = dict(s.idle_gaps)
    assert names["tokens_to_host/aten::copy_"] == pytest.approx(20e-9)
    assert names["step/aten::mm"] == pytest.approx(10e-9)
    b = s.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(20e-9)] and len(b["idle_gaps"]) == 2


def test_cardbench_summary_refuses_an_empty_trace():
    with pytest.raises(RuntimeError):
        trace.summarize([], [("step", 0, 1, True)], 1.0)


def _run(**kw):
    """A run of falcon-mamba-7b's 4,096-token training mix, which no cell of
    the benchmark holds yet: its files alone."""
    cell = bench.Cell(name="falcon-mamba-7b.train-4k", chips=1,
                      config=bench.load_json(bench.HERE / "configs" / "falcon-mamba-7b.json"),
                      traffic=bench.load_json(bench.HERE / "traffic" / "train-4k-1row.json"),
                      limits={}, end_to_end=[], per_layer=[], root=bench.HERE)
    run = bench.Run(cell, 1, 10.0, True, "cuda")
    run.cfg = types.SimpleNamespace(dtype="bfloat16")
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _read(name, run):
    return bench.load_module(bench.HERE / "metrics" / f"{name}.py").read(run)


def test_cardbench_end_to_end_arithmetic():
    run = _run(window_start=0.0, step_starts=[0.0, 2.0, 4.0], step_ends=[2.0, 4.0, 6.5],
               step_tokens=[4096] * 3, peak_bytes=3 * 2**30, setup_s=12.5)
    assert _read("train_tokens_per_s", run) == pytest.approx(3 * 4096 / 6.5)
    assert _read("peak_gib", run) == 3.0 and _read("setup_s", run) == 12.5
    steps = [0.1] * 95 + [0.2] * 5
    ends = list(np.cumsum(steps))
    run = _run(window_start=0.0, step_starts=[0.0] + ends[:-1], step_ends=ends, step_tokens=[16] * 100)
    assert _read("decode_tokens_per_s", run) == pytest.approx(1600 / sum(steps))
    assert 100 < _read("decode_step_p95_ms", run) < 200.0001


def test_cardbench_shares():
    sizes = bench.load_json(bench.HERE / "configs" / "falcon-mamba-7b.json")["sizes"]
    flops = work.train_flops(sizes, 4096)
    run = _run(step_starts=[0.0, 2.0], step_ends=[2.0, 4.0], work={"step_flops": flops})
    assert _read("mfu.train", run) == pytest.approx(100 * flops / 989e12 / 2.0)
    summary = trace.Summary(window_s=4.0, busy_s=3.0, device_ops={
        "selective_scan_kernel": 0.010, "selective_scan_bwd_kernel": 0.020, "gemm": 1.0},
        idle_gaps=[], n_device_events=3)
    run = _run(trace=summary, launches={"selective_scan": 4, "selective_scan_backward": 2})
    fwd = work.bound_s(work.selective_scan(1, 4096, 8192, 16, "bfloat16"))[0]
    bwd = work.bound_s(work.selective_scan_backward(1, 4096, 8192, 16, "bfloat16"))[0]
    assert _read("selective_scan_roofline.train", run) == pytest.approx(100 * (4 * fwd + 2 * bwd) / 0.030)
    assert _read("device_idle_share.train", run) == pytest.approx(25.0)
    assert _read("selective_scan_roofline.train", _run(trace=None)) is None


def test_cardbench_a_reader_that_finds_nothing_returns_nothing():
    run = _run()
    run.traced = False
    for name in ("selective_scan_roofline.train", "device_idle_share.train", "mfu.train"):
        assert _read(name, run) is None

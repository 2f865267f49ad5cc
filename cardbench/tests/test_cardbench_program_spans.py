"""The readers of the program's spans (``host_step_ms.decode``,
``host_wait_ms.decode``, ``host_syncs.decode``) on synthetic span lists."""
import sys

import pytest

from cardbench import bench, trace
from repro_torch.runtime import tracing
from repro_torch.runtime.tracing import Span

CELL = "granite-moe-1b-a400m.decode-32k"
READERS = ("host_step_ms.decode", "host_wait_ms.decode", "host_syncs.decode")


def _run(traced=True):
    run = bench.Run(bench.find_cell(CELL), 1, 10.0, traced, "cuda")
    if traced:
        run.trace = trace.Summary(window_s=1.0, busy_s=0.5, device_ops={"k": 0.5}, idle_gaps=[],
                                  n_device_events=1)
    return run


def _read(name, run):
    return bench.load_module(bench.HERE / "metrics" / f"{name}.py").read(run)


def _steps(durations_ms, waits_ms):
    """One ``serve_step`` a duration, each holding its step's waits (ms) as
    ``sync.moe_counts`` spans of two reads each inside a ``moe.dispatch``;
    then a wait outside any step, which no reader counts."""
    out, t = [], 0
    for step, (d, waits) in enumerate(zip(durations_ms, waits_ms)):
        root = len(out)
        out.append(Span(tracing.ROOT, t, t + int(d * 1e6), None, step))
        out.append(Span("moe.dispatch", t, t + int(d * 1e6), root, step))
        at = t
        for w in waits:
            out.append(Span("sync.moe_counts", at, at + int(w * 1e6), root + 1, step, 2))
            at += int(w * 1e6)
        t += int(d * 1e6) + 1000
    out.append(Span("sync.moe_counts", t, t + 10 ** 9, None, None, 2))
    return out


@pytest.fixture
def spans(monkeypatch):
    def use(recorded):
        monkeypatch.setattr(tracing, "spans", lambda: list(recorded))
    return use


def test_cardbench_program_span_readers_arithmetic(spans):
    spans(_steps([200.0, 250.0, 210.0, 900.0], [[2.0, 3.0], [1.0, 4.0], [5.0, 0.5], [10.0, 1.5]]))
    run = _run()
    assert _read("host_step_ms.decode", run) == pytest.approx(230.0)  # the median of four
    assert _read("host_wait_ms.decode", run) == pytest.approx(27.0 / 4)
    assert _read("host_syncs.decode", run) == 4  # two spans a step, two reads each


def test_cardbench_program_span_readers_read_zero_waits(spans):
    spans(_steps([100.0, 120.0, 140.0], [[], [], []])[:-1])
    run = _run()
    assert _read("host_step_ms.decode", run) == pytest.approx(120.0)
    assert _read("host_wait_ms.decode", run) == 0 and _read("host_syncs.decode", run) == 0


def test_cardbench_program_span_readers_find_nothing(spans):
    spans(_steps([100.0, 120.0], [[1.0], [1.0]]))
    for name in READERS:
        assert _read(name, _run(traced=False)) is None
    spans([Span("moe.route", 0, 10, None, None), Span("sync.moe_counts", 20, 30, None, None)])
    for name in READERS:
        assert _read(name, _run()) is None


def test_cardbench_program_span_readers_on_a_program_without_spans(monkeypatch):
    import repro_torch.runtime

    monkeypatch.delattr(repro_torch.runtime, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    for name in READERS:
        assert _read(name, _run()) is None

"""The port's spans (``runtime.tracing``): off unless the profiler records,
the decode step's layers and host waits under it, on the profiler's clock."""
import time
import traceback
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.space import SchedulePlan
from repro_torch.kernels import ops
from repro_torch.models import moe, transformer
from repro_torch.runtime import graphs, tracing
from repro_torch.runtime.tracing import Span
from repro_torch.training.train_step import make_serve_step, tiles_from_plan

torch.set_num_threads(1)

ATTN = ("attn.project", "attn.cache_write", "attn.attend", "attn.out")
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def _decode(device="cpu", kv_dtype="int8", rows=2):
    """The reduced granite-moe config's serve step, and a call of it; the
    call's ``eager`` is the same step run as it is, inside a ``serve_step``
    span, never through a CUDA graph."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = transformer.init_params(cfg, 0, device=device)
    cache = transformer.init_cache(cfg, rows, 16, kv_dtype=kv_dtype, device=device)
    plan = SchedulePlan(kv_dtype=kv_dtype)
    step = make_serve_step(cfg, None, plan, device=device)
    tok = torch.arange(3, 3 + rows, device=device)[:, None]
    cur = torch.arange(2, 2 + rows, device=device)

    def call():
        return step(params, cache, tok, cur)

    def eager():
        with tracing.span(tracing.ROOT):
            return transformer.decode_step(params, cfg, cache, tok, cur, tiles=tiles_from_plan(plan))

    call.eager = eager
    return cfg, call


@pytest.fixture(scope="module")
def traced():
    """Two serve steps under the profiler: the spans, and the profiler's
    user annotations ``(name, start ns)``."""
    cfg, call = _decode()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()  # the profiler's first annotations carry its own set-up
        ops.reset_counters()
        since = time.time_ns()
        call()
        call()
    notes = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.start_ns() > since]
    return cfg, tracing.spans(), notes


def test_spans_record_nothing_while_the_profiler_is_off():
    _, call = _decode()
    ops.reset_counters()
    call()
    assert tracing.spans() == [] and not tracing.recording()
    assert tracing.span("a") is tracing.span("b")


def test_serve_step_records_its_layers_and_waits(traced):
    cfg, spans, _ = traced
    roots = [i for i, s in enumerate(spans) if s.name == tracing.ROOT]
    assert [spans[i].step for i in roots] == [0, 1]
    assert all(spans[i].parent is None for i in roots)
    n_moe = sum(spec.mlp == "moe" for spec in cfg.layer_plan()) * cfg.n_periods
    n_attn = sum(spec.mixer == "attn" for spec in cfg.layer_plan()) * cfg.n_periods
    for step, root in enumerate(roots):
        mine = [s for s in spans if s.step == step]
        assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in mine)
        under = [s.name for s in mine if s.parent == root]
        assert under == (["decode.embed"] + [*ATTN, *MOE] * n_attn + ["decode.logits"])
        # the experts' counts are a scatter-add on the device: a step waits nowhere
        assert n_moe and not [s for s in mine if s.name.startswith(tracing.SYNC)]
        assert all(spans[root].start_ns <= s.start_ns and s.end_ns <= spans[root].end_ns for s in mine)


def test_spans_share_the_profilers_clock(traced):
    _, spans, notes = traced
    names = {s.name for s in spans}
    for name in names:
        mine = sorted(s.start_ns for s in spans if s.name == name)
        theirs = sorted(t for n, t in notes if n == name)
        assert len(mine) == len(theirs), name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000, name


def test_summary_self_time_subtracts_the_union_of_children():
    spans = [
        Span("serve_step", 0, 100, None, 0),
        Span("moe.dispatch", 10, 50, 0, 0),
        Span("sync.moe_counts", 20, 30, 1, 0),
        Span("sync.moe_counts", 25, 40, 1, 0),  # overlaps its sibling: counted once
        Span("decode.logits", 45, 60, 0, 0),  # overlaps moe.dispatch's tail
        Span("moe.route", 200, 230, None, None),
    ]
    got = tracing.summary(spans)
    assert got["serve_step"] == (1, 100, 100 - 50)
    assert got["moe.dispatch"] == (1, 40, 40 - 20)
    assert got["sync.moe_counts"] == (2, 25, 25)
    assert got["decode.logits"] == (1, 15, 15)
    assert got["moe.route"] == (1, 30, 30)


def test_reset_counters_empties_the_spans():
    ops.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span(tracing.ROOT):
            with tracing.span("moe.route"):
                pass
    assert [(s.name, s.parent, s.step) for s in tracing.spans()] == [
        (tracing.ROOT, None, 0), ("moe.route", 0, 0)]
    ops.reset_counters()
    assert tracing.spans() == [] and tracing.summary() == {}


def test_moe_outside_a_serve_step_records_no_step():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    p = moe.init(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 8, cfg.d_model)
    ops.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        moe.forward(p, cfg, x, tiles=tiles_from_plan(SchedulePlan()))
    spans = tracing.spans()
    assert [s.name for s in spans] == ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    assert all(s.step is None and s.parent is None for s in spans)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_every_host_wait_of_a_cuda_serve_step_lies_in_a_sync_span(kv_dtype):
    """No host wait at all: not in the step run as it is, nor in a replay of
    its CUDA graph (``runtime.graphs``), so no ``sync.*`` span either."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, call = _decode("cuda", kv_dtype, rows=4)
    call()  # builds the kernels; the serve step's first call runs as it is
    call()  # captures its graph and replays it
    torch.cuda.synchronize()
    waits = []

    def seen(message, *args, **kwargs):
        if "synchronizing" in str(message):
            waits.append("".join(traceback.format_stack(limit=12)[:-1]))

    ops.reset_counters()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                torch.ones(1, device="cuda").item()  # a wait the mode must see
                assert waits, "the sync debug mode did not report a wait"
                waits.clear()
                call.eager()
                assert not waits, "host waits in an eager step:\n" + "\n---\n".join(waits)
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    assert not waits, "host waits in a replayed step:\n" + "\n---\n".join(waits)
    recorded = tracing.spans()
    assert not [s for s in recorded if s.name.startswith(tracing.SYNC)]
    assert [s.name for s in recorded if s.name.startswith(tracing.ROOT)] == [
        tracing.ROOT, tracing.ROOT, graphs.REPLAY]

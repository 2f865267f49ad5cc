"""The reader of ``graph_replay_share.decode`` on synthetic span lists."""
import sys

import pytest

from cardbench.tests.test_cardbench_program_spans import _read, _run, spans  # noqa: F401
from repro_torch.runtime import tracing
from repro_torch.runtime.tracing import Span

NAME = "graph_replay_share.decode"


def _graphed_steps(replays):
    """A ``serve_step`` a flag, holding a ``serve_step.replay`` where the flag
    is set (a ``serve_step.capture`` before it on the first), else the
    step's own spans; then a replay outside any step, which is not counted."""
    out, t = [], 0
    for step, replayed in enumerate(replays):
        root = len(out)
        out.append(Span(tracing.ROOT, t, t + 100, None, step))
        if replayed and step == 0:
            out.append(Span("serve_step.capture", t + 1, t + 40, root, step))
        out.append(Span("serve_step.replay" if replayed else "decode.embed", t + 50, t + 90, root, step))
        t += 1000
    out.append(Span("serve_step.replay", t, t + 10, None, None))
    return out


@pytest.mark.parametrize("replays,share", [
    ([True] * 4, 100.0),
    ([False, True, True, True], 75.0),
    ([False] * 3, 0.0),
])
def test_cardbench_graph_replay_share_reader(spans, replays, share):  # noqa: F811
    spans(_graphed_steps(replays))
    assert _read(NAME, _run()) == pytest.approx(share)
    assert _read(NAME, _run(traced=False)) is None


def test_cardbench_graph_replay_share_finds_nothing(spans, monkeypatch):  # noqa: F811
    spans([Span("serve_step.replay", 0, 10, None, None)])
    assert _read(NAME, _run()) is None  # no step
    spans(_graphed_steps([True, True]))
    import repro_torch.runtime

    monkeypatch.delattr(repro_torch.runtime, "graphs", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.graphs", None)  # a program without graphs
    assert _read(NAME, _run()) is None

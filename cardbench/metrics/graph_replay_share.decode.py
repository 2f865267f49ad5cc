"""``graph_replay_share.decode``: the share of the window's decode steps (the
program's ``serve_step`` spans) that replayed a CUDA graph of the step, that
is, that hold a ``serve_step.replay`` span (``repro_torch.runtime.graphs``,
recorded while the profiler records), in percent: a share of steps, not of
a peak, so its unit is not ``%``, which the schema keeps for shares of a
roofline or a peak.  Read after the window, from the spans it recorded.  Nothing untraced, nor where the program keeps no
``serve_step`` span or has no graphs of its step."""


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.runtime import graphs, tracing
    except ImportError:
        return None
    spans = tracing.spans()
    steps = {i for i, s in enumerate(spans) if s.name == tracing.ROOT and s.end_ns is not None}
    if not steps:
        return None
    replayed = {s.parent for s in spans if s.name == graphs.REPLAY and s.parent in steps}
    return 100.0 * len(replayed) / len(steps)

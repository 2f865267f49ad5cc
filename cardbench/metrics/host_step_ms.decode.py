"""``host_step_ms.decode``: the median, over the window's decode steps, of
the program's ``serve_step`` span on the host clock: from the call to its
return, every launch issued and every wait for the device inside it
(``repro_torch.runtime.tracing``, recorded while the profiler records).
Nothing where the program keeps no such span."""
import statistics


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    steps = [s.end_ns - s.start_ns for s in tracing.spans() if s.name == tracing.ROOT and s.end_ns is not None]
    return statistics.median(steps) * 1e-6 if steps else None

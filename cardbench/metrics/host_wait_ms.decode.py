"""``host_wait_ms.decode``: the mean time a decode step of the window spends
inside the program's ``sync.*`` spans, where the host waits for the device
(``repro_torch.runtime.tracing``, recorded while the profiler records): their
total over the number of ``serve_step`` spans.  0 where steps ran and no
such span was entered; nothing where the program keeps no ``serve_step``
span."""


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    steps = sum(s.name == tracing.ROOT and s.end_ns is not None for s in spans)
    if not steps:
        return None
    waits = [s.end_ns - s.start_ns for s in spans
             if s.name.startswith(tracing.SYNC) and s.step is not None and s.end_ns is not None]
    return sum(waits) * 1e-6 / steps

"""``host_syncs.decode``: the times the host waits for the device (a read of
a device value to the host each) per ``serve_step`` span of the window: the
``waits`` of the program's ``sync.*`` spans inside the steps, summed
(``repro_torch.runtime.tracing``, recorded while the profiler records).  0
where steps ran and no such span was entered; nothing where the program
keeps no ``serve_step`` span."""


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
    return sum(s.waits for s in spans if s.name.startswith(tracing.SYNC) and s.step is not None) / steps

"""``mamba_host_ms.hybrid_decode``: the mean host time a decode step of the
window spends inside the program's ``mamba.*`` spans (the Mamba layers'
projection, conv, SSM step, output and state writes;
``repro_torch.runtime.tracing``, recorded while the profiler records): their
total over the number of ``serve_step`` spans.  Nothing where the program
keeps no ``serve_step`` span or no ``mamba.*`` span inside one."""

PREFIX = "mamba."


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    steps = sum(s.name == tracing.ROOT and s.end_ns is not None for s in spans)
    inside = [s.end_ns - s.start_ns for s in spans
              if s.name.startswith(PREFIX) and s.step is not None and s.end_ns is not None]
    if not steps or not inside:
        return None
    return sum(inside) * 1e-6 / steps

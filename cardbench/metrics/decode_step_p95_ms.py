"""``decode_step_p95_ms``: the 95th percentile, over every decode step of the
window, of a step's time from its launch to its tokens on the host: the gap
between two tokens of a streamed session.  Percentiles by
``statistics.quantiles(..., n=100, method="inclusive")``."""
import statistics


def read(run):
    steps = run.step_seconds()
    if len(steps) < 2:
        return None
    return statistics.quantiles(steps, n=100, method="inclusive")[94] * 1e3

"""``device_idle_share.decode``: the share of the traced window in which no
operation ran on the device (``trace.Summary``: the union of the device
events' intervals against the window's host time)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

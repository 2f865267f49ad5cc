"""``selective_scan_roofline.train``: the least time of the window's scan
launches, forward and backward (``work.selective_scan`` and
``work.selective_scan_backward`` at the cell's shapes, a call each launch
the program counted), over the device time of the scan's kernels in the
trace (every device operation whose name holds ``selective_scan``)."""
from cardbench import work


def read(run):
    if run.trace is None:
        return None
    fwd, bwd = run.launches.get("selective_scan", 0), run.launches.get("selective_scan_backward", 0)
    device_s = sum(s for name, s in run.trace.device_ops.items() if "selective_scan" in name)
    if not (fwd or bwd) or not device_s:
        return None
    s, tr = run.cell.config["sizes"], run.cell.traffic
    shape = (tr["rows"], tr["seq_len"], s["d_inner"], s["ssm_state"], run.cfg.dtype)
    least = (fwd * work.bound_s(work.selective_scan(*shape))[0]
             + bwd * work.bound_s(work.selective_scan_backward(*shape))[0])
    return 100.0 * least / device_s

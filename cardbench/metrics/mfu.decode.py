"""``mfu.decode``: a decode step's least time on the card -- the larger of
its FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s
(``work.decode_work`` at the window's mean positions) -- over the window's
mean step time, as a share."""
from cardbench import work


def read(run):
    mean = run.mean_step_s()
    if not mean or "step_bytes" not in run.work:
        return None
    least, _ = work.bound_s(work.Work(run.work["step_flops"], run.work["step_bytes"], "bfloat16"))
    return 100.0 * least / mean

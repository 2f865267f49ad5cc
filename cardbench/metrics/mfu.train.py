"""``mfu.train``: a training step's model FLOPs (``work.train_flops``: six
times the parameters that multiply, times the step's tokens) over the
window's mean step time, as a share of 989 TFLOP/s (bf16, dense)."""
from cardbench import work


def read(run):
    mean = run.mean_step_s()
    if not mean or "step_flops" not in run.work:
        return None
    return 100.0 * run.work["step_flops"] / work.PEAK_BF16 / mean

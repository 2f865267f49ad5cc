"""``tune_s``: the host's seconds in the set-up's call of the port's search
(``autotune``), which picks the cell's plan."""


def read(run):
    return run.tune_s

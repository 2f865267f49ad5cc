"""``setup_s``: seconds from the process's start to the first timed step --
imports, the program's libraries (built on the first run of a checkout),
the search, weights, inputs and warm-up."""


def read(run):
    return run.setup_s

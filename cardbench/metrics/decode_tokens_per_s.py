"""``decode_tokens_per_s``: the tokens every slot was served in the window,
over the window's time from its start to the last step's tokens reaching
the host."""


def read(run):
    if not run.step_ends:
        return None
    return sum(run.step_tokens) / (run.step_ends[-1] - run.window_start)

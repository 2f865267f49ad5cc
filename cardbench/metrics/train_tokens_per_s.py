"""``train_tokens_per_s``: the tokens of every step completed in the window,
over the window's time from its start to the last step's completion."""


def read(run):
    if not run.step_ends:
        return None
    return sum(run.step_tokens) / (run.step_ends[-1] - run.window_start)

"""Tokens of all training steps completed in the window over the window's
seconds: every stall, every step that races a drain and every wait for a
previous snapshot's commit is inside it."""


def read(run):
    steps = run.in_window("step")
    return len(steps) * run.numbers["tokens_per_step"] / run.window_s if steps else None

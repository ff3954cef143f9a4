"""Mean seconds from ``async_take``'s return to ``wait()``'s return, over
the window's takes that committed before it closed."""

from portbench.lib.readers import committed_in_window, mean


def read(run):
    return mean(op.info["t_commit"] - op.t1 for op in committed_in_window(run))

"""Mean host wall time of ``Snapshot.async_take`` up to its return, over
the window's takes."""

from portbench.lib.readers import mean_over


def read(run):
    return mean_over(run, "async_take", lambda op: op.t1 - op.t0)

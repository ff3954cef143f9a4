"""Mean over the window's restores of the union of the memory plugin's
``storage.read`` spans."""

from portbench.lib.readers import mean_over, span_union_s


def read(run):
    return mean_over(run, "restore", lambda op: span_union_s(op, ("storage.read",)))

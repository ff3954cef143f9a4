"""Mean over the window's takes of the union of the memory plugin's
``storage.write`` and ``storage.write_stream`` spans."""

from portbench.lib.readers import mean_over, span_union_s


def read(run):
    return mean_over(run, "take", lambda op: span_union_s(op, ("storage.write", "storage.write_stream")))

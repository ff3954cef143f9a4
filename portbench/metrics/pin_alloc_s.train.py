"""Per async take that committed in the window: the union of its session's
``stage.pin_alloc`` spans, the D2H lanes' pinned host allocations
(``d2h.py``); the mean over those takes. None where the program ran no
probe: a session with the probe's ``host.gil_wait_s`` counter comes from a
program that records these spans, so a take of one with none (on the CPU)
spent nothing on them."""

from portbench.lib.readers import committed_in_window, mean, span_union_s


def read(run):
    return mean(
        span_union_s(op, ("stage.pin_alloc",))
        for op in committed_in_window(run)
        if op.info.get("tm") is not None and "host.gil_wait_s" in op.info["tm"].metrics.as_dict()
    )

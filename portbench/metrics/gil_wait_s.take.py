"""Per take of the window: the summed ``host.gil_wait`` spans of its
session (``telemetry/hostprobe.py``), the seconds by which the
interpreter-lock probe woke late while the take's pipeline ran; the mean
over the takes. None where the program ran no probe (its session has no
``host.gil_wait_s`` counter)."""

from portbench.lib.readers import mean_over


def waited(op):
    tm = op.info.get("tm")
    if tm is None or "host.gil_wait_s" not in tm.metrics.as_dict():
        return None
    return sum(s.dur for s in tm.spans(name="host.gil_wait"))


def read(run):
    return mean_over(run, "take", waited)

"""Per async take that committed in the window: the summed ``host.gil_wait``
spans of its session (``telemetry/hostprobe.py``) that begin between
``async_take``'s return and its commit, the seconds by which the
interpreter-lock probe woke late while the drain raced the steps; the mean
over those takes. None where the program ran no probe (its session has no
``host.gil_wait_s`` counter)."""

from portbench.lib.readers import committed_in_window, mean


def read(run):
    waited = []
    for op in committed_in_window(run):
        tm = op.info.get("tm")
        if tm is None or "host.gil_wait_s" not in tm.metrics.as_dict():
            continue
        waited.append(sum(s.dur for s in tm.spans(name="host.gil_wait") if op.t1 <= s.ts < op.info["t_commit"]))
    return mean(waited)

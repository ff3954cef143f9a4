"""Per take: the summed wall time of the steps that overlap its drain
(``async_take``'s return to ``wait()``'s return), less as many times the
median of the window's steps that overlap no drain; the mean over the
takes that committed in the window."""

from statistics import median

from portbench.lib.readers import committed_in_window, mean


def read(run):
    takes = committed_in_window(run)
    steps = run.in_window("step")
    drains = [(op.t1, op.info["t_commit"]) for op in run.in_window("async_take") if op.info.get("t_commit")]
    calm = [s.t1 - s.t0 for s in steps if not any(s.t1 > a and s.t0 < b for a, b in drains)]
    if not takes or not calm:
        return None
    base = median(calm)
    excess = []
    for op in takes:
        racing = [s.t1 - s.t0 for s in steps if s.t1 > op.t1 and s.t0 < op.info["t_commit"]]
        excess.append(sum(racing) - len(racing) * base)
    return mean(excess)

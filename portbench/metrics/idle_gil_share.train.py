"""100 x the device's idle seconds in the window that lie under a
``host.gil_wait`` span (``telemetry/hostprobe.py``) of any of the window's
telemetry sessions, over all its idle seconds: how much of the idle card
waited on a host whose interpreter lock was held. The reference's copies
are out of both, as in ``device_idle.train``. None without a device trace
or where the program ran no probe (no session has a ``host.gil_wait_s``
counter)."""

from portbench.lib import trace


def probed_sessions(run):
    """The sessions of the window's operations that ran the probe."""
    t0, t1 = run.window
    out = []
    for op in run.ops:
        tm = op.info.get("tm")
        if tm is not None and t0 <= op.t0 <= t1 and "host.gil_wait_s" in tm.metrics.as_dict():
            out.append(tm)
    return out


def _spans(sessions, names):
    return trace.merge((s.ts, s.ts + s.dur) for tm in sessions for s in tm.spans() if s.name in names)


def _both(a, b):
    """The parts of ``a`` that ``b`` covers too, both sorted and disjoint:
    one sweep, since a traced window's idle gaps number in the tens of
    thousands."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            out.append((max(lo, b[k][0]), min(hi, b[k][1])))
            k += 1
    return out


def idle_share(run, also=()):
    """The share of the idle seconds under a ``host.gil_wait`` span and,
    where ``also`` names spans, under one of those too."""
    sessions = probed_sessions(run)
    if not run.device_events or not sessions:
        return None
    t0, t1 = run.window
    idle = trace.subtract(trace.idle_gaps(trace.busy_intervals(run.device_events), t0, t1), run.excluded())
    idle_s = trace.length(idle)
    if idle_s <= 0:
        return None
    under = _both(idle, _spans(sessions, {"host.gil_wait"}))
    if also:
        under = _both(under, _spans(sessions, set(also)))
    return 100.0 * trace.length(under) / idle_s


def read(run):
    return idle_share(run)

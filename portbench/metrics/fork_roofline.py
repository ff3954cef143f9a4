"""The fork's share of its byte bound: a device copy of the configuration's
device state (read once, written once at 3.35 TB/s), over the device time
of the work launched inside each async take's ``capture`` phase (the
union of the device events that start in its host interval), summed over
the window's takes. It counts the work the fork needs, whatever does it."""

from portbench.lib import arith, trace


def read(run):
    if not run.device_events:
        return None
    device_s, n = 0.0, 0
    for op in run.in_window("async_take"):
        tm = op.info.get("tm")
        spans = [s for s in tm.spans(name="capture", cat="take.phase")] if tm is not None else []
        if not spans:
            continue
        lo, hi = spans[0].ts, spans[0].ts + spans[0].dur
        device_s += trace.union_s((e.t0, e.t1) for e in run.device_events if lo <= e.t0 < hi)
        n += 1
    if device_s <= 0:
        return None
    return arith.share_pct(n * arith.copy_bound_s(run.numbers["device_state_bytes"]), device_s)

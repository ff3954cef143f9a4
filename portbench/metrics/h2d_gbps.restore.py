"""Host-to-device bytes of the window's restores over the device time of
their host-to-device memcpys (the union of the intervals of those that
start inside a restore), 10^9 bytes per second. The bytes are the state's
bytes on the card, which each restore has to bring over once."""

from portbench.lib import trace


def read(run):
    restores = run.in_window("restore")
    if not run.device_events or not restores:
        return None
    spans = [(op.t0, op.t1) for op in restores]
    h2d = [e for e in run.device_events if "HtoD" in e.name and any(a <= e.t0 < b for a, b in spans)]
    busy = trace.union_s((e.t0, e.t1) for e in h2d)
    return len(restores) * run.numbers["device_state_bytes"] / busy / 1e9 if busy else None

"""State bytes of all ``Snapshot.restore`` calls of the window, into the
live tensors, over its seconds (10^9 bytes per second)."""


def read(run):
    restores = run.in_window("restore")
    return len(restores) * run.numbers["state_bytes"] / run.window_s / 1e9 if restores else None

"""State bytes of all ``Snapshot.take`` calls of the window over its
seconds (10^9 bytes per second); the deletion of each previous snapshot is
inside the window."""


def read(run):
    takes = run.in_window("take")
    return len(takes) * run.numbers["state_bytes"] / run.window_s / 1e9 if takes else None

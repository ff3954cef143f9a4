"""``"op": "restore"``: set-up takes one snapshot and restores it once
(a restarted process's first restore, ``first_restore_s``); the window
restores it back to back into the live tensors, each first overwritten
with a byte pattern. The check judges the state the window's last restore
left."""

import time


def set_up(runner):
    runner.take()
    runner.copy_reference()
    runner.state.fill(0)
    t0 = time.monotonic()
    runner.restore(runner.committed)
    runner.run.setup["first_restore_s"] = time.monotonic() - t0


def operation(runner, k):
    runner.record("fill", lambda: runner.state.fill(k))
    runner.restore(runner.committed)


def check(runner):
    return runner.compare()

"""``"op": "async_take"``: ``Snapshot.async_take`` of the whole state. A
take first waits for the previous one to commit (the wait counts); the
plain reference copies the state, outside the window's time, just before
the program is asked to capture it."""


def set_up(runner):
    runner.async_take()
    runner.state.step()
    runner.finish()


def operation(runner, k):
    runner.async_take()

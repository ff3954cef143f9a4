"""``"op": "take"``: ``Snapshot.take`` of the whole state, back to back;
the state does not change, so set-up's reference copy holds for every
take."""


def set_up(runner):
    runner.take()
    runner.copy_reference()


def operation(runner, k):
    runner.take()

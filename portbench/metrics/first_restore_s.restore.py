"""Wall time of the process's first restore, made in set-up: what a
restarted process pays once before its restores reach the steady state."""


def read(run):
    return run.setup.get("first_restore_s")

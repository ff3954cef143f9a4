"""Mean over the window's takes of the planning phases of
``snapshot.LAST_TAKE_PHASES``: flatten, fingerprint, preflight, prepare and
plan."""

from portbench.lib.readers import mean_over

PHASES = ("flatten", "fingerprint", "preflight", "prepare", "plan")


def read(run):
    return mean_over(run, "take", lambda op: sum(op.info["phases"].get(p, 0.0) for p in PHASES))

"""Mean of ``snapshot.LAST_TAKE_PHASES["capture"]`` over the window's async
takes: ``io_preparer.capture_flattened``, which forks the state on the
card (K2)."""

from portbench.lib.readers import mean_over


def read(run):
    return mean_over(run, "async_take", lambda op: op.info["phases"].get("capture"))

"""Mean over the window's takes of ``snapshot.LAST_SYNC_DRAIN_STATS
["stage_d2h_s"]``: the device-to-host staging (``d2h.py``)."""

from portbench.lib.readers import mean_over


def read(run):
    return mean_over(run, "take", lambda op: op.info["stats"].get("stage_d2h_s"))

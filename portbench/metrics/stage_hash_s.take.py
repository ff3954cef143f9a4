"""Mean over the window's takes of ``snapshot.LAST_SYNC_DRAIN_STATS
["stage_hash_s"]``: checksums and digests (``hashing.py``)."""

from portbench.lib.readers import mean_over


def read(run):
    return mean_over(run, "take", lambda op: op.info["stats"].get("stage_hash_s"))

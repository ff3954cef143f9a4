"""What the ``recycled_share`` readers share: the share of one operation's
storage copies that the port's memory plugin wrote into buffers recycled
from a deleted snapshot (``storage.memory.recycled_bytes``) against those
it wrote into new ones (``storage.memory.fresh_bytes``)."""

from __future__ import annotations

from typing import Optional

from .workload import Op

RECYCLED, FRESH = "storage.memory.recycled_bytes", "storage.memory.fresh_bytes"


def share(op: Op) -> Optional[float]:
    """Recycled bytes over recycled and new bytes in ``op``'s session; None
    where it has no session (an untraced run), the program counts neither
    (one without the pool), or nothing was copied."""
    tm = op.info.get("tm")
    if tm is None:
        return None
    counters = tm.metrics.as_dict()
    if RECYCLED not in counters and FRESH not in counters:
        return None
    recycled = counters.get(RECYCLED, 0)
    total = recycled + counters.get(FRESH, 0)
    return recycled / total if total else None

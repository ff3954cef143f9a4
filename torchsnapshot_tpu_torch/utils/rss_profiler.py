"""Background RSS-delta sampler (the JAX package's ``utils/rss_profiler.py``).

Used by benchmarks and tests to check that the scheduler's memory budget
holds::

    deltas = []
    with measure_rss_deltas(rss_deltas=deltas):
        snapshot = Snapshot.take(...)
    assert max(deltas) < budget + slack

The resident set size is read from ``/proc/self/statm`` (Linux), so the
port needs no ``psutil``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Generator, List

_PAGE_BYTES = os.sysconf("SC_PAGE_SIZE")


def rss_bytes() -> int:
    """This process's resident set size in bytes."""
    with open("/proc/self/statm", "rb") as f:
        return int(f.read().split()[1]) * _PAGE_BYTES


@contextlib.contextmanager
def measure_rss_deltas(
    rss_deltas: List[int], interval_ms: float = 100.0
) -> Generator[None, None, None]:
    baseline = rss_bytes()
    stop = threading.Event()

    def sample() -> None:
        while not stop.is_set():
            rss_deltas.append(rss_bytes() - baseline)
            time.sleep(interval_ms / 1000)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()
        rss_deltas.append(rss_bytes() - baseline)

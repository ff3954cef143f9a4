"""Transient-error retry shared by the storage plugins (fs, GCS, S3) and
the read pipeline's fetch.

One classification of transient local errors (:data:`TRANSIENT_OS_ERRNOS`),
one backoff policy (:func:`backoff_s`) and one give-up rule: the
collective-progress window (:class:`CollectiveProgress`). Each retry adds
one to ``cloud_retry.<label>.retries`` and its sleep to
``cloud_retry.<label>.backoff_s``.
"""

from __future__ import annotations

import asyncio
import errno
import logging
import random
import time
from typing import Optional

from .. import telemetry

logger = logging.getLogger(__name__)

BASE_BACKOFF_S = 0.5
MAX_BACKOFF_S = 8.0
PROGRESS_WINDOW_S = 120.0

# Errors a network file system gives for a moment and then not: a stale
# handle after a server fail-over, a timed-out round trip, a busy inode.
# Permanent conditions (ENOSPC, EACCES, EROFS, ENOENT, ...) are absent:
# retrying them only delays the real error.
TRANSIENT_OS_ERRNOS = frozenset(
    e
    for e in (
        errno.ESTALE,
        errno.ETIMEDOUT,
        errno.EAGAIN,
        errno.EBUSY,
        errno.EINTR,
        getattr(errno, "EREMOTEIO", None),
    )
    if e is not None
)


def is_transient_os_error(e: BaseException) -> bool:
    return isinstance(e, OSError) and e.errno in TRANSIENT_OS_ERRNOS


class CollectiveProgress:
    """A retry deadline shared by every operation of one plugin or one
    read pipeline: an operation's start or success refreshes it, and a
    transient error gives up only once nothing has started or succeeded
    for ``window_s``. Congestion that still makes progress never expires
    it; a total outage does, ``window_s`` after the last activity."""

    def __init__(self, window_s: float = PROGRESS_WINDOW_S) -> None:
        self.window_s = window_s
        self._last = time.monotonic()

    def note_progress(self) -> None:
        self._last = time.monotonic()

    def out_of_time(self) -> bool:
        return time.monotonic() - self._last > self.window_s

    def remaining_s(self) -> float:
        """Seconds until the window expires with no further activity (never
        negative): the longest a retry should sleep."""
        return max(0.0, self.window_s - (time.monotonic() - self._last))


def backoff_s(attempt: int, base_backoff_s: Optional[float] = None) -> float:
    """Jittered exponential backoff. Reads the module constants at call
    time (tests shrink them); an explicit ``base_backoff_s`` wins."""
    base = BASE_BACKOFF_S if base_backoff_s is None else base_backoff_s
    return min(MAX_BACKOFF_S, base * (2**attempt)) * (0.5 + random.random())


async def retry_transient(
    run,
    is_transient,
    progress: CollectiveProgress,
    label: str,
    base_backoff_s: Optional[float] = None,
):
    """``await run()``, retrying errors ``is_transient`` accepts until
    ``progress``'s window expires. Each sleep is clamped to the window's
    remaining time (plus 50 ms, so the check after it lands past the
    deadline), and the window is checked again after the sleep: a retry
    loop overshoots its give-up time by at most that epsilon."""
    attempt = 0
    progress.note_progress()
    while True:
        try:
            result = await run()
        except Exception as e:  # noqa: BLE001 - classified by the caller
            if not is_transient(e) or progress.out_of_time():
                raise
            attempt += 1
            backoff = min(backoff_s(attempt, base_backoff_s), progress.remaining_s() + 0.05)
            telemetry.counter_add(f"cloud_retry.{label.lower()}.retries")
            telemetry.counter_add(f"cloud_retry.{label.lower()}.backoff_s", backoff)
            logger.warning(
                "Transient %s error (attempt %d, retrying in %.1fs while the "
                "plugin makes collective progress): %s",
                label, attempt, backoff, e,
            )
            await asyncio.sleep(backoff)
            if progress.out_of_time():
                raise
        else:
            progress.note_progress()
            return result

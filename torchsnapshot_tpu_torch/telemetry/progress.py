"""Live progress counters + stall watchdog for in-flight snapshots.

The write pipeline (``scheduler._WritePipeline``) feeds a
:class:`ProgressTracker` as it stages and writes: bytes staged, bytes
written, requests done — all strictly monotonic, updated from the pipeline's
event-loop thread and read from any thread (``PendingSnapshot.progress()``
is the public surface). ``snapshot()`` derives instantaneous and EWMA write
rates and an ETA from the raw counters, so a 55-second background drain is
a progress bar instead of a black box.

The :class:`StallWatchdog` is the liveness half: an opt-in asyncio task
(knob ``TSS_TORCH_STALL_WARN_S``, read by the scheduler — this
module takes the threshold as a constructor argument) that watches the
tracker and logs ONE structured warning per stall naming the stuck stage,
re-arming when byte progress resumes.

Stdlib-only, like the rest of the telemetry package: importable before
torch/numpy and from every layer without cycles.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import threading
import time
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

# Time constant for the EWMA write rate: recent ~10 s dominate, so the ETA
# reacts to a throughput change within a few polls without jittering on
# single slow requests.
_EWMA_TAU_S = 10.0


class ProgressTracker:
    """Thread-safe monotonic counters for one write pipeline.

    Totals start as the sum of the scheduler's staging-cost *estimates* and
    are corrected to actual byte counts as staging completes (estimates can
    be off for compressed payloads), so at pipeline end
    ``bytes_written == bytes_total`` — the invariant the acceptance test
    asserts. The byte counters themselves only ever increase.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.begin_ts = time.monotonic()
        self.bytes_staged = 0
        self.bytes_written = 0
        self.bytes_total = 0
        self.requests_done = 0
        self.requests_total = 0
        # Rate state: updated by snapshot() calls (poll-driven).
        self._rate_ts = self.begin_ts
        self._rate_bytes = 0
        self._ewma_bps = 0.0

    def set_totals(self, requests: int, bytes_: int) -> None:
        with self._lock:
            self.requests_total = int(requests)
            self.bytes_total = int(bytes_)

    def note_staged(self, nbytes: int, estimate: Optional[int] = None) -> None:
        """One buffer/chunk finished staging. ``estimate`` is the admission
        estimate this staging corrects: the total is adjusted by the
        difference so it converges on the actual payload size."""
        with self._lock:
            self.bytes_staged += max(0, int(nbytes))
            if estimate is not None:
                self.bytes_total += int(nbytes) - int(estimate)

    def note_written(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_written += max(0, int(nbytes))

    def note_request_done(self) -> None:
        with self._lock:
            self.requests_done += 1

    def adjust_total_bytes(self, delta: int) -> None:
        """Correct the byte total by ``delta`` (streamed requests learn
        their actual size only when the stream ends)."""
        with self._lock:
            self.bytes_total += int(delta)

    def activity_marker(self) -> Any:
        """Opaque value that changes whenever bytes move (staged OR
        written) — what the watchdog compares between polls."""
        with self._lock:
            return (self.bytes_staged, self.bytes_written)

    def counters(self) -> Dict[str, int]:
        """Raw monotonic counters, no derived rates."""
        with self._lock:
            return {
                "bytes_staged": self.bytes_staged,
                "bytes_written": self.bytes_written,
                "bytes_total": self.bytes_total,
                "requests_done": self.requests_done,
                "requests_total": self.requests_total,
            }

    def snapshot(self) -> Dict[str, Any]:
        """Counters plus derived rates/ETA.

        The instantaneous rate covers the window since the previous
        ``snapshot()`` call (poll-driven: callers that never poll pay
        nothing); the EWMA folds it in with a ~10 s time constant. ``eta_s``
        is remaining bytes over the EWMA rate, ``None`` until a rate exists.
        """
        now = time.monotonic()
        with self._lock:
            dt = now - self._rate_ts
            inst_bps = 0.0
            if dt > 0:
                inst_bps = (self.bytes_written - self._rate_bytes) / dt
                alpha = 1.0 - math.exp(-dt / _EWMA_TAU_S)
                self._ewma_bps += alpha * (inst_bps - self._ewma_bps)
                self._rate_ts = now
                self._rate_bytes = self.bytes_written
            remaining = max(0, self.bytes_total - self.bytes_written)
            eta_s: Optional[float] = None
            if remaining == 0:
                eta_s = 0.0
            elif self._ewma_bps > 0:
                eta_s = remaining / self._ewma_bps
            return {
                "bytes_staged": self.bytes_staged,
                "bytes_written": self.bytes_written,
                "bytes_total": self.bytes_total,
                "requests_done": self.requests_done,
                "requests_total": self.requests_total,
                "bytes_per_s_instant": inst_bps,
                "bytes_per_s_ewma": self._ewma_bps,
                "eta_s": eta_s,
                "elapsed_s": now - self.begin_ts,
            }


class StallWatchdog:
    """Logs one structured warning per stall of the drain.

    A stall is ``warn_s`` seconds without the tracker's byte counters
    moving. The warning names the stuck stage (derived from the pipeline's
    occupancy callback: requests sitting in io/streaming point at storage,
    in staging at D2H/serialize) and fires EXACTLY ONCE per stall — the
    watchdog re-arms only after progress resumes, so a wedged storage
    backend produces one line, not one per poll. ``fired`` counts warnings
    for tests and for the ``scheduler.stall_warnings`` metric (recorded by
    the scheduler, which owns metric emission).
    """

    def __init__(
        self,
        tracker: ProgressTracker,
        warn_s: float,
        occupancy: Optional[Callable[[], Dict[str, int]]] = None,
        rank: int = 0,
        on_fire: Optional[Callable[[], None]] = None,
    ) -> None:
        self.tracker = tracker
        self.warn_s = float(warn_s)
        self.occupancy = occupancy
        self.rank = rank
        self.on_fire = on_fire
        self.fired = 0

    @staticmethod
    def _stuck_stage(occ: Dict[str, int]) -> str:
        for stage in ("io", "streaming", "staging", "ready_for_io", "pending"):
            if occ.get(stage, 0) > 0:
                return stage
        return "unknown"

    def _fire(self, now: float, last_change: float) -> None:
        self.fired += 1
        occ = dict(self.occupancy()) if self.occupancy else {}
        counters = self.tracker.counters()
        payload = {
            "event": "snapshot_stall",
            "rank": self.rank,
            "stalled_s": round(now - last_change, 3),
            "stuck_stage": self._stuck_stage(occ),
            "occupancy": occ,
            "bytes_written": counters["bytes_written"],
            "bytes_total": counters["bytes_total"],
            "requests_done": counters["requests_done"],
            "requests_total": counters["requests_total"],
        }
        # Peer attribution via the fleet bus: when the stall is a wait ON
        # someone (a barrier straggler, a dead bcast reader, a held QoS
        # class), name the peer and its last-beaconed phase instead of
        # leaving the operator to diff per-process logs. [] when the bus
        # is off; never fails the watchdog.
        try:
            from . import fleet

            blocked = fleet.blocked_detail()
        except Exception:  # noqa: BLE001 - diagnostics must not fail
            blocked = []
        if blocked:
            payload["blocked_on"] = blocked
        logger.warning(
            "snapshot drain stalled: %s", json.dumps(payload, sort_keys=True)
        )
        if self.on_fire is not None:
            self.on_fire()

    def _tick(
        self, state: Dict[str, Any]
    ) -> None:
        """One poll round over mutable loop state {last, last_change,
        warned} — shared by the asyncio and thread run modes."""
        cur = self.tracker.activity_marker()
        now = time.monotonic()
        if cur != state["last"]:
            state["last"] = cur
            state["last_change"] = now
            state["warned"] = False
            return
        if not state["warned"] and now - state["last_change"] >= self.warn_s:
            state["warned"] = True
            self._fire(now, state["last_change"])

    def _poll_s(self) -> float:
        return max(0.02, min(self.warn_s / 4.0, 1.0))

    async def run(self) -> None:
        """Poll until cancelled; the owner retains and cancels this task."""
        poll = self._poll_s()
        state: Dict[str, Any] = {
            "last": self.tracker.activity_marker(),
            "last_change": time.monotonic(),
            "warned": False,
        }
        while True:
            await asyncio.sleep(poll)
            self._tick(state)

    def run_blocking(self, stop: threading.Event) -> None:
        """Thread-mode poll loop (same tick) for synchronous waits with no
        event loop — the commit/restore barrier holds. Runs until ``stop``
        is set; pair with :func:`watchdog_thread`."""
        poll = self._poll_s()
        state: Dict[str, Any] = {
            "last": self.tracker.activity_marker(),
            "last_change": time.monotonic(),
            "warned": False,
        }
        while not stop.wait(poll):
            self._tick(state)


def watchdog_thread(
    watchdog: StallWatchdog,
) -> "tuple[threading.Thread, threading.Event]":
    """Start ``watchdog`` on a daemon thread; returns ``(thread, stop)``.
    The owner sets ``stop`` and joins when the guarded wait finishes."""
    stop = threading.Event()
    thread = threading.Thread(
        target=watchdog.run_blocking,
        args=(stop,),
        name="torchsnapshot-stall-watchdog",
        daemon=True,
    )
    thread.start()
    return thread, stop

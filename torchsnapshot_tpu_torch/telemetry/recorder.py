"""The job-lifetime flight recorder: a process-wide, bounded ring-buffer
time-series sampler.

Per-op telemetry (``core.py`` sessions, ``artifact.py`` persistence) answers
"where did THIS take's time go"; the flight recorder answers "what has the
engine been doing all job" — it outlives any single operation and keeps the
most recent ``TSS_TORCH_RECORDER_CAPACITY`` samples of the dataflow
engine's introspection surface (pool occupancy, budget high-water,
admissions, per-class QoS demand, preemption/pause waves, stall-watchdog
firings). The engine feeds it from its wait loop (rate-limited by
``TSS_TORCH_RECORDER_INTERVAL_S``); discrete events bypass the rate
limit. ``python -m torchsnapshot_tpu_torch monitor`` renders the ring live via
the optional ``TSS_TORCH_RECORDER_DUMP`` mirror file.

Always-on by default, and deliberately cheap enough for that: recording one
sample is one short ``threading.Lock`` hold and one slot assignment into a
pre-sized ring (no per-sample list growth); when the knob disables it,
every feed site reduces to one module-global ``is None`` check — no
allocation, no time read. Lock-light, not lock-free: samples arrive from an
event-loop thread at wait-round granularity, so contention is nil.

Stdlib-only at module level, like the rest of the telemetry package:
importable before torch/numpy and from every layer (the engine imports this
module) without cycles.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

DUMP_SCHEMA_VERSION = 1

# The dump mirror rewrites the whole ring; once a second bounds the cost to
# ~capacity * sample-size bytes/s regardless of sample rate.
_DUMP_MIN_INTERVAL_S = 1.0


class FlightRecorder:
    """One bounded ring of ``{"ts", "kind", ...fields}`` samples.

    ``ts`` is unix time (samples from different processes/ranks align on a
    common axis, like the persisted artifacts). The ring never grows past
    ``capacity``; ``dropped`` counts overwritten samples.
    """

    def __init__(
        self,
        capacity: int,
        interval_s: float = 0.0,
        dump_path: Optional[str] = None,
    ) -> None:
        self.capacity = max(16, int(capacity))
        self.interval_s = float(interval_s)
        self.dump_path = dump_path
        self._lock = threading.Lock()
        self._ring: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._next = 0  # total samples ever recorded
        # Per-source rate-limit state (source -> last sample monotonic ts).
        self._last_sample: Dict[str, float] = {}
        self._last_dump = 0.0
        self._dump_warned = False

    # ------------------------------------------------------------ recording

    def record(self, kind: str, fields: Dict[str, Any]) -> None:
        """Append one sample unconditionally (events: pause/resume waves,
        watchdog firings, admissions milestones)."""
        sample = {"ts": round(time.time(), 6), "kind": kind}
        sample.update(fields)
        with self._lock:
            self._ring[self._next % self.capacity] = sample
            self._next += 1
        self._maybe_dump()

    def sample(self, source: str, kind: str, fields: Dict[str, Any]) -> None:
        """Append one time-series sample, rate-limited per ``source`` by the
        recorder's interval (one engine = one source; two concurrent engines
        never starve each other's series)."""
        now = time.monotonic()
        with self._lock:
            # None, not 0.0, is "never sampled": the monotonic clock can be
            # smaller than the interval right after boot, and `now - 0.0`
            # would suppress a source's FIRST sample for the whole gap.
            last = self._last_sample.get(source)
            if last is not None and now - last < self.interval_s:
                return
            self._last_sample[source] = now
        self.record(kind, fields)

    # ------------------------------------------------------------- reading

    @property
    def dropped(self) -> int:
        """Samples overwritten by ring wrap-around."""
        with self._lock:
            return max(0, self._next - self.capacity)

    def snapshot(self) -> List[Dict[str, Any]]:
        """The ring's live samples, oldest first."""
        with self._lock:
            n = self._next
            if n <= self.capacity:
                return [s for s in self._ring[:n] if s is not None]
            head = n % self.capacity
            out = self._ring[head:] + self._ring[:head]
            return [s for s in out if s is not None]

    def series(self, kind: str) -> List[Dict[str, Any]]:
        return [s for s in self.snapshot() if s.get("kind") == kind]

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._next = 0
            self._last_sample.clear()

    # ---------------------------------------------------------------- dump

    def dump(self, path: str) -> None:
        """Write the ring to ``path`` atomically (tmp + replace): one JSON
        object the ``monitor`` CLI renders."""
        payload = {
            "schema_version": DUMP_SCHEMA_VERSION,
            "pid": os.getpid(),
            "written_unix": round(time.time(), 6),
            "capacity": self.capacity,
            "dropped": self.dropped,
            "samples": self.snapshot(),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def _maybe_dump(self) -> None:
        path = self.dump_path
        if path is None:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump < _DUMP_MIN_INTERVAL_S:
                return
            self._last_dump = now
        try:
            self.dump(path)
        except Exception:  # noqa: BLE001 - diagnostics must not fail the op
            if not self._dump_warned:
                self._dump_warned = True
                logger.warning(
                    "flight-recorder dump to %s failed (recording "
                    "continues in memory)", path, exc_info=True,
                )


# --------------------------------------------------------------------------
# Process-wide instance. `_RECORDER is None` IS the disabled state: every
# feed site loads one module global and branches — no allocation, no time
# read — which the off-mode zero-allocation test asserts.
# --------------------------------------------------------------------------

_RECORDER: Optional[FlightRecorder] = None
_INITIALIZED = False
_INIT_LOCK = threading.Lock()


def _init() -> None:
    global _RECORDER, _INITIALIZED
    from ..utils import knobs

    with _INIT_LOCK:
        if _INITIALIZED:
            return
        if knobs.is_recorder_enabled():
            _RECORDER = FlightRecorder(
                capacity=knobs.get_recorder_capacity(),
                interval_s=knobs.get_recorder_interval_s(),
                dump_path=knobs.get_recorder_dump_path(),
            )
        _INITIALIZED = True


def get_recorder() -> Optional[FlightRecorder]:
    """The process-wide recorder, or None when the knob disables it. Knobs
    are read once, at first use; tests that override them call
    :func:`reset` to re-evaluate."""
    if not _INITIALIZED:
        _init()
    return _RECORDER


def reset() -> None:
    """Drop the process-wide instance and re-read the knobs at next use
    (test hook; production jobs configure the recorder via env at start)."""
    global _RECORDER, _INITIALIZED
    with _INIT_LOCK:
        _RECORDER = None
        _INITIALIZED = False


def record_event(kind: str, fields: Dict[str, Any]) -> None:
    """Record one discrete event (no rate limit). No-op when disabled."""
    r = _RECORDER
    if r is None:
        if _INITIALIZED:
            return
        r = get_recorder()
        if r is None:
            return
    r.record(kind, fields)


def sample_engine(engine: Any) -> None:
    """Feed one engine introspection sample (rate-limited per engine).
    Called from the engine's wait loop; when the recorder is disabled this
    is one global load + branch."""
    r = _RECORDER
    if r is None:
        if _INITIALIZED:
            return
        r = get_recorder()
        if r is None:
            return
    source = f"engine:{id(engine)}"
    now = time.monotonic()
    with r._lock:
        last = r._last_sample.get(source)  # None = never sampled (see sample())
        if last is not None and now - last < r.interval_s:
            return
        r._last_sample[source] = now
    r.record("engine.sample", engine.introspect())

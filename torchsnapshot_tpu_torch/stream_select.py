"""Streaming by measurement (``TSS_TORCH_STREAM_WRITES=auto``, the default).

A port of ``torchsnapshot_tpu/stream_select.py``. Whether streaming a large
object chunk by chunk beats staging it whole and writing it once depends
on the host and the storage plugin: per-chunk staging can cost more than
the overlap buys. So each plugin keeps a scorecard of measured throughput
on both sides, fed by the write pipeline:

- :func:`note_streamed`: bytes and seconds of each streamed append, and
  (:func:`note_stream_stage`) each chunk's staging seconds;
- :func:`note_whole`: bytes and seconds of each whole-buffer write, and
  (:func:`note_whole_stage`) each request's staging seconds.

A side's rate is bytes per busy second, staging included: the per-chunk
staging overhead is exactly what the decision must weigh.

:func:`resolve` (once per write pipeline) returns the knob when it is
forced ``on`` or ``off``; under ``auto`` it streams iff the streamed
side's rate is at least the whole side's, and streams while either side
lacks credible evidence (enough bytes and operations). Each decision is
recorded (:func:`last_decision`) and mirrored into
``knobs.is_stream_writes_enabled``. :func:`ab_probe` buys evidence up
front: one object streamed and one written whole at a destination, then
deleted.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from . import telemetry
from .io_types import WriteIO
from .utils import knobs

logger = logging.getLogger(__name__)

# A side is credible once this many bytes and operations were measured.
MIN_CREDIBLE_BYTES = 64 * 1024 * 1024
MIN_CREDIBLE_OPS = 2


def storage_label(storage) -> str:
    """``FSStoragePlugin`` -> ``fs``."""
    name = type(storage).__name__
    if name.endswith("StoragePlugin"):
        name = name[: -len("StoragePlugin")]
    return name.lower() or "unknown"


@dataclass
class _SideStats:
    bytes: int = 0
    seconds: float = 0.0
    ops: int = 0

    def rate(self) -> Optional[float]:
        return self.bytes / self.seconds if self.seconds > 0 else None

    def credible(self) -> bool:
        return self.bytes >= MIN_CREDIBLE_BYTES and self.ops >= MIN_CREDIBLE_OPS and self.seconds > 0


_LOCK = threading.Lock()
# {plugin label: {"stream" | "whole": _SideStats}}
_SCORE: Dict[str, Dict[str, _SideStats]] = {}
# {plugin label: last resolve() record}; "" holds the most recent one.
_DECISIONS: Dict[str, dict] = {}


def _side(label: str, side: str) -> _SideStats:
    return _SCORE.setdefault(label, {}).setdefault(side, _SideStats())


def _note(label: str, side: str, nbytes: int, seconds: float) -> None:
    if seconds <= 0 or nbytes < 0:
        return
    with _LOCK:
        s = _side(label, side)
        s.seconds += seconds
        if nbytes:
            s.bytes += nbytes
            s.ops += 1


def note_streamed(label: str, nbytes: int, seconds: float) -> None:
    """One streamed append's bytes and seconds."""
    if nbytes > 0:
        _note(label, "stream", nbytes, seconds)


def note_whole(label: str, nbytes: int, seconds: float) -> None:
    """One whole-buffer write's bytes and seconds."""
    if nbytes > 0:
        _note(label, "whole", nbytes, seconds)


def note_stream_stage(label: str, seconds: float) -> None:
    """One streamed chunk's staging seconds (its bytes count at its append)."""
    _note(label, "stream", 0, seconds)


def note_whole_stage(label: str, seconds: float) -> None:
    """One whole request's staging seconds (its bytes count at its write)."""
    _note(label, "whole", 0, seconds)


def resolve(storage) -> bool:
    """The streaming decision of one write pipeline."""
    mode = knobs.get_stream_writes_mode()
    label = storage_label(storage)
    supports = bool(getattr(storage, "supports_streaming", False))
    if mode != "auto":
        enabled = mode == "on"
        _record(label, mode, enabled and supports, None, None, "forced")
        return enabled
    if not supports:
        # Nothing to decide; a non-decision must not overwrite a real one.
        return False
    with _LOCK:
        sides = _SCORE.get(label, {})
        s = sides.get("stream", _SideStats())
        w = sides.get("whole", _SideStats())
        if s.credible() and w.credible():
            enabled = s.rate() >= w.rate()
            reason = "measured"
        else:
            enabled = True
            reason = "insufficient-evidence"
        srate, wrate = s.rate(), w.rate()
    _record(label, mode, enabled, srate, wrate, reason)
    knobs.note_stream_auto_resolution(enabled)
    return enabled


def _record(label: str, mode: str, enabled: bool, stream_bps, whole_bps, reason: str) -> None:
    rec = {
        "plugin": label,
        "mode": mode,
        "enabled": enabled,
        "stream_bps": stream_bps,
        "whole_bps": whole_bps,
        "reason": reason,
    }
    with _LOCK:
        _DECISIONS[label] = rec
        _DECISIONS[""] = rec
    telemetry.gauge_set("scheduler.stream_auto_on", 1.0 if enabled else 0.0)
    if mode == "auto" and reason == "measured" and not enabled:
        logger.debug(
            "stream auto-select: off for %s (streamed %.3f GB/s < whole %.3f GB/s)",
            label, (stream_bps or 0) / 1e9, (whole_bps or 0) / 1e9,
        )


def last_decision(label: Optional[str] = None) -> Optional[dict]:
    """The most recent :func:`resolve` record (of ``label``, or overall)."""
    with _LOCK:
        rec = _DECISIONS.get(label if label is not None else "")
        return dict(rec) if rec is not None else None


def scorecard(label: str) -> Dict[str, dict]:
    """``{side: {bytes, seconds, ops, rate_bps}}`` of one plugin."""
    with _LOCK:
        return {
            side: {"bytes": s.bytes, "seconds": s.seconds, "ops": s.ops, "rate_bps": s.rate()}
            for side, s in _SCORE.get(label, {}).items()
        }


def reset() -> None:
    """Drop all evidence and decisions."""
    with _LOCK:
        _SCORE.clear()
        _DECISIONS.clear()
    knobs.note_stream_auto_resolution(None)


def ab_probe(url_path: str, nbytes: int = 128 * 1024 * 1024, reps: int = 1) -> Optional[dict]:
    """Write a probe of ``nbytes`` at ``url_path`` streamed (at the stream
    chunk size) and whole, ``reps`` times each, feed both into the
    scorecard and delete the probes. Returns the rates, or None when the
    plugin does not stream or the probe failed (evidence is optional)."""
    from .storage_plugin import url_to_storage_plugin

    loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin(url_path)
        try:
            if not getattr(storage, "supports_streaming", False):
                return None
            label = storage_label(storage)
            chunk = knobs.get_stream_chunk_bytes()
            payload = memoryview(bytearray(nbytes))
            stream_s = whole_s = 0.0
            for rep in range(max(1, reps)):
                stream_s += loop.run_until_complete(
                    _probe_streamed(storage, f".probe/stream_ab.on.{rep}", payload, chunk)
                )
                whole_s += loop.run_until_complete(
                    _probe_whole(storage, f".probe/stream_ab.off.{rep}", payload)
                )
            total = nbytes * max(1, reps)
            note_streamed(label, total, stream_s)
            note_whole(label, total, whole_s)
            return {
                "plugin": label,
                "probe_bytes": total,
                "stream_bps": total / stream_s if stream_s > 0 else None,
                "whole_bps": total / whole_s if whole_s > 0 else None,
            }
        finally:
            storage.sync_close(loop)
    except Exception:  # noqa: BLE001 - evidence is optional, never fatal
        logger.warning("stream A/B probe against %s failed", url_path, exc_info=True)
        return None
    finally:
        loop.close()


async def _probe_streamed(storage, path: str, payload: memoryview, chunk: int) -> float:
    t0 = time.monotonic()
    stream = await storage.write_stream(path)
    try:
        for off in range(0, payload.nbytes, chunk):
            await stream.append(payload[off : off + chunk])
        await stream.commit()
    except BaseException:
        await stream.abort()
        raise
    dt = time.monotonic() - t0
    await storage.delete(path)
    return dt


async def _probe_whole(storage, path: str, payload: memoryview) -> float:
    t0 = time.monotonic()
    await storage.write(WriteIO(path=path, buf=payload))
    dt = time.monotonic() - t0
    await storage.delete(path)
    return dt

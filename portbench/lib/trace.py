"""The device trace of a ``--trace 1`` run and the interval arithmetic the
per-layer readers share.

``DeviceTrace`` runs ``torch.profiler`` with CUDA activity only (kernels,
memcpys, memsets) over the measured window. Kineto stamps events on the
wall clock in nanoseconds; they are moved onto ``time.monotonic()``, the
clock of the harness's host spans and of the port's telemetry spans, by
the offset between the two clocks read at start and stop.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


class DeviceEvent:
    __slots__ = ("t0", "t1", "name")

    def __init__(self, t0: float, t1: float, name: str) -> None:
        self.t0, self.t1, self.name = t0, t1, name


def _clock_offset_s() -> float:
    """Wall clock minus monotonic clock, in seconds."""
    return (time.time_ns() - time.monotonic_ns()) / 1e9


class DeviceTrace:
    """``start()`` / ``stop()`` around the window; ``stop`` returns the
    device events in monotonic seconds."""

    def __init__(self) -> None:
        import torch

        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._offset0 = 0.0

    def start(self) -> None:
        import torch

        self._prof.start()
        self._offset0 = _clock_offset_s()
        # A marker kernel launched at a known host time: ``stop`` reports
        # how far after it the trace places the kernel's start.
        torch.cuda.synchronize()
        self._mark = time.monotonic()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.marker_lag_s: Optional[float] = None

    def stop(self) -> List[DeviceEvent]:
        import torch

        torch.cuda.synchronize()
        offset = (self._offset0 + _clock_offset_s()) / 2
        self._prof.stop()
        out = []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            t0 = e.start_ns() / 1e9 - offset
            if self.marker_lag_s is None and "spin" in e.name():
                self.marker_lag_s = t0 - self._mark
            out.append(DeviceEvent(t0, t0 + e.duration_ns() / 1e9, e.name()))
        return out


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def clip(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """``intervals`` cut to ``[lo, hi]``."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def subtract(intervals: Sequence[Interval], cut: Sequence[Interval]) -> List[Interval]:
    """``intervals`` (merged) less every part that ``cut`` covers."""
    out = []
    cut = merge(cut)
    for a, b in merge(intervals):
        for c, d in cut:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append((a, b))
    return out


def union_s(intervals: Iterable[Interval], lo: Optional[float] = None, hi: Optional[float] = None) -> float:
    """Seconds covered by the union of ``intervals``, within ``[lo, hi]``
    where given."""
    merged = merge(intervals)
    if lo is not None and hi is not None:
        merged = clip(merged, lo, hi)
    return length(merged)


def busy_intervals(events: Sequence[DeviceEvent]) -> List[Interval]:
    return merge((e.t0, e.t1) for e in events)


def idle_gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of ``[lo, hi]`` that ``busy`` (merged) leaves uncovered."""
    gaps, cur = [], lo
    for a, b in clip(busy, lo, hi):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        gaps.append((cur, hi))
    return gaps


def top_device_ops(events: Sequence[DeviceEvent], lo: float, hi: float, n: int = 10) -> List[List]:
    """[name, seconds] of the ``n`` device operations that took most time
    in ``[lo, hi]``, summed by name (cut to its first 120 characters)."""
    by_name: Dict[str, float] = {}
    for e in events:
        if e.t1 > lo and e.t0 < hi:
            name = e.name[:120]
            by_name[name] = by_name.get(name, 0.0) + min(e.t1, hi) - max(e.t0, lo)
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host_span(
    gaps: Sequence[Interval], spans: Sequence[Tuple[str, float, float]], n: int = 10
) -> List[List]:
    """[host span name, idle seconds]: the device's idle time attributed to
    what the host was doing (``spans``: name, start, end, one after another
    on the loop's thread; time under no span is ``bench.other``), the
    ``n`` largest."""
    spans = sorted(spans, key=lambda s: s[1])
    ends = [s[2] for s in spans]
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        covered = 0.0
        for i in range(bisect.bisect_right(ends, g0), len(spans)):
            name, s0, s1 = spans[i]
            if s0 >= g1:
                break
            part = min(g1, s1) - max(g0, s0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                covered += part
        if g1 - g0 - covered > 0:
            out["bench.other"] = out.get("bench.other", 0.0) + g1 - g0 - covered
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]

"""Interval algebra for the engine's stream-overlap stats.

The engine records one ``(t0, t1)`` interval per node execution, and the
drain statistics (how much of the wall time staging and storage writes
were in flight, and overlapped) are derived from those intervals by union
and intersection. A copy of ``torchsnapshot_tpu/engine/intervals.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Interval = Tuple[float, float]


def merge_intervals(intervals: List[Interval]) -> List[Interval]:
    """Sorted union of possibly-overlapping intervals."""
    out: List[Interval] = []
    for t0, t1 in sorted(i for i in intervals if i[1] > i[0]):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def clip_merged(
    merged: List[Interval], w0: float, w1: float
) -> List[Interval]:
    return [
        (max(t0, w0), min(t1, w1)) for t0, t1 in merged if t1 > w0 and t0 < w1
    ]


def measure(merged: List[Interval]) -> float:
    return sum(t1 - t0 for t0, t1 in merged)


def intersect_merged(
    a: List[Interval], b: List[Interval]
) -> List[Interval]:
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        t0 = max(a[i][0], b[j][0])
        t1 = min(a[i][1], b[j][1])
        if t1 > t0:
            out.append((t0, t1))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def stream_stats(
    windows: List[Interval],
    stage_intervals: List[Interval],
    io_intervals: List[Interval],
) -> Dict[str, float]:
    """wall/stage_busy/io_busy/overlap/idle over the given accounting
    windows. Only activity inside a window is attributed (matching the old
    wait-loop accounting: the gap between an async take's capture point and
    its background drain is nobody's time)."""
    stage = merge_intervals(stage_intervals)
    io = merge_intervals(io_intervals)
    both = intersect_merged(stage, io)
    wall = stage_busy = io_busy = overlap = 0.0
    for w0, w1 in windows:
        wall += w1 - w0
        stage_busy += measure(clip_merged(stage, w0, w1))
        io_busy += measure(clip_merged(io, w0, w1))
        overlap += measure(clip_merged(both, w0, w1))
    union = stage_busy + io_busy - overlap
    return {
        "wall_s": wall,
        "stage_busy_s": stage_busy,  # D2H + serialize stream in flight
        "io_busy_s": io_busy,  # storage-write stream in flight
        "overlap_s": overlap,  # both streams concurrently in flight
        "idle_s": max(0.0, wall - union),  # neither stream active
    }

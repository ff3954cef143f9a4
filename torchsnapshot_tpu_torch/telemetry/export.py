"""Exporters: Chrome/Perfetto trace-event JSON and the flat metrics dict.

The trace format is the Chrome trace-event JSON object form —
``{"traceEvents": [...], "otherData": {...}}`` with complete ("ph": "X")
events — which https://ui.perfetto.dev and chrome://tracing both open
directly. Timestamps/durations are microseconds rebased to the session's
``t0`` so traces start near zero.

``spans_from_chrome_trace`` is the inverse used by tests (schema round-trip)
and the CLI's summary printer; it intentionally tolerates foreign events
(no ``args.span_id``) by synthesizing ids, so externally produced Chrome
traces still parse.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from .core import Span, Telemetry

TRACE_FORMAT_VERSION = 1


def _counter_events(
    tm: Telemetry, recorder_samples: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Perfetto counter ("C") tracks derived from the flight recorder's
    ``engine.sample`` ring: per-engine write rate (derivative of
    ``bytes_done`` between consecutive samples) and budget high-water mark,
    rendered beside the span tracks. Sample ``ts`` is unix time; span
    timestamps are monotonic rebased to ``tm.t0`` — the unix→monotonic
    anchor below aligns the two on one axis (exact within one process)."""
    events: List[Dict[str, Any]] = []
    anchor = time.time() - time.monotonic()  # unix clock at monotonic zero
    last: Dict[str, Dict[str, Any]] = {}
    for s in sorted(
        (s for s in recorder_samples if s.get("kind") == "engine.sample"),
        key=lambda s: s.get("ts") or 0.0,
    ):
        eng = str(s.get("engine") or "engine")
        ts = s.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        ts_us = max(0.0, (ts - anchor - tm.t0) * 1e6)
        prev = last.get(eng)
        bps = 0.0
        if prev is not None and ts > prev["ts"]:
            bps = max(
                0.0,
                ((s.get("bytes_done") or 0) - (prev.get("bytes_done") or 0))
                / (ts - prev["ts"]),
            )
        events.append(
            {
                "name": f"{eng}.bytes_per_s",
                "ph": "C",
                "pid": tm.pid,
                "ts": ts_us,
                "args": {"bytes_per_s": round(bps, 3)},
            }
        )
        events.append(
            {
                "name": f"{eng}.budget_hwm",
                "ph": "C",
                "pid": tm.pid,
                "ts": ts_us,
                "args": {"budget_hwm": s.get("budget_hwm") or 0},
            }
        )
        last[eng] = s
    return events


def to_chrome_trace(
    tm: Telemetry,
    recorder_samples: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    events: List[Dict[str, Any]] = []
    spans = tm.buffer.snapshot()
    # Thread-name metadata events make Perfetto's track labels readable.
    for tid in sorted({s.tid for s in spans}):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": tm.pid,
                "tid": tid,
                "args": {"name": f"thread-{tid}"},
            }
        )
    for s in spans:
        args = dict(s.attrs)
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append(
            {
                "name": s.name,
                "cat": s.cat or "default",
                "ph": "X",
                "ts": max(0.0, (s.ts - tm.t0) * 1e6),
                "dur": (s.dur or 0.0) * 1e6,
                "pid": tm.pid,
                "tid": s.tid,
                "args": args,
            }
        )
    if recorder_samples:
        # Opt-in counter tracks. "C" events are invisible to
        # spans_from_chrome_trace (it keeps only "X"), so the round-trip
        # contract is unchanged.
        events.extend(_counter_events(tm, recorder_samples))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "format_version": TRACE_FORMAT_VERSION,
            "producer": "torchsnapshot_tpu_torch.telemetry",
            "rank": tm.rank,
            "dropped_spans": tm.buffer.dropped,
            "metrics": tm.metrics.as_dict(),
        },
    }


def write_chrome_trace(
    tm: Telemetry,
    path: str,
    recorder_samples: Optional[List[Dict[str, Any]]] = None,
) -> None:
    """Atomic (tmp + replace): a crashed export never leaves a torn trace
    for a trace viewer or a concurrent reader to choke on."""
    write_trace_obj(to_chrome_trace(tm, recorder_samples=recorder_samples), path)


def write_trace_obj(trace: Dict[str, Any], path: str) -> None:
    """Atomically write an already-built trace object (fleet beacon
    timelines, merged traces)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    os.replace(tmp, path)


def fleet_beacon_trace(history: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace over accumulated fleet beacons (``monitor --fleet
    --watch --trace``): ``pid`` = rank — the same per-rank process layout
    as :func:`aggregate.merged_chrome_trace` — with counter tracks for the
    write rate and instant events at phase changes. Timestamps rebase to
    the earliest beacon seen."""
    recs = [
        b
        for b in history
        if isinstance(b, dict) and isinstance(b.get("rank"), int)
    ]
    events: List[Dict[str, Any]] = []
    if recs:
        t0 = min(b.get("ts_unix") or 0.0 for b in recs)
        for r in sorted({b["rank"] for b in recs}):
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": r,
                    "tid": 0,
                    "args": {"name": f"rank {r}"},
                }
            )
        last_phase: Dict[int, Any] = {}
        seen: set = set()
        for b in sorted(recs, key=lambda x: x.get("ts_unix") or 0.0):
            r = b["rank"]
            fence = (r, b.get("pid"), b.get("seq"))
            if fence in seen:
                continue  # the same beacon generation read twice
            seen.add(fence)
            ts = max(0.0, ((b.get("ts_unix") or t0) - t0) * 1e6)
            prog = b.get("progress") or {}
            if prog:
                events.append(
                    {
                        "name": "progress.bytes_per_s",
                        "ph": "C",
                        "pid": r,
                        "ts": ts,
                        "args": {
                            "bytes_per_s": prog.get("bytes_per_s_ewma") or 0.0
                        },
                    }
                )
            events.append(
                {
                    "name": "blocked_peers",
                    "ph": "C",
                    "pid": r,
                    "ts": ts,
                    "args": {"blocked_peers": len(b.get("blocked_on") or ())},
                }
            )
            phase = b.get("phase") or b.get("op")
            if phase and phase != last_phase.get(r):
                last_phase[r] = phase
                events.append(
                    {
                        "name": str(phase),
                        "cat": "fleet.phase",
                        "ph": "i",
                        "s": "p",
                        "pid": r,
                        "tid": 0,
                        "ts": ts,
                    }
                )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "format_version": TRACE_FORMAT_VERSION,
            "producer": "torchsnapshot_tpu_torch.telemetry.fleet",
            "beacons": len(recs),
        },
    }


def spans_from_chrome_trace(trace: Dict[str, Any]) -> List[Span]:
    """Rebuild Span records from an exported (or foreign) Chrome trace.

    Only complete ("X") events become spans; metadata events are skipped.
    ``ts``/``dur`` come back in seconds (matching live Span records), so a
    round-trip preserves names, cats, durations, attrs, and parent links.
    """
    out: List[Span] = []
    synthetic_id = -1
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args") or {})
        span_id = args.pop("span_id", None)
        parent_id = args.pop("parent_id", None)
        if span_id is None:
            span_id = synthetic_id
            synthetic_id -= 1
        sp = Span(
            name=ev.get("name", ""),
            cat="" if ev.get("cat") in (None, "default") else ev["cat"],
            ts=float(ev.get("ts", 0.0)) / 1e6,
            span_id=int(span_id),
            parent_id=None if parent_id is None else int(parent_id),
            attrs=args,
        )
        sp.dur = float(ev.get("dur", 0.0)) / 1e6
        tid = ev.get("tid")
        if isinstance(tid, int):
            sp.tid = tid
        out.append(sp)
    return out


def metrics_from_chrome_trace(trace: Dict[str, Any]) -> Dict[str, Any]:
    return dict((trace.get("otherData") or {}).get("metrics") or {})

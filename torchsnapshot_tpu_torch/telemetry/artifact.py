"""Persisted per-rank telemetry artifacts.

Every take/async_take/restore persists a compact, schema-versioned JSON
artifact at ``.telemetry/rank_<k>.json`` (restores:
``.telemetry/restore_rank_<k>.json``) INSIDE the snapshot, written through
the snapshot's own :class:`~..io_types.StoragePlugin` — so it works on
fs/gs/s3/memory alike, and, because it is written before the commit
barrier, every committed snapshot carries the record of how it was written.
Artifact persistence is fail-open end to end: a build or write failure logs
once and never fails (or meaningfully delays) the checkpoint.

The artifact carries no spans — it is the compact aggregate (phase
durations with wall-clock timestamps, merged stage/io busy intervals,
byte/request counters, the full metrics dump, and an environment
fingerprint), sized in KB regardless of checkpoint size. Cross-rank
merging, straggler attribution, and the multi-rank Perfetto export live in
``aggregate.py``; the operator surface is
``python -m torchsnapshot_tpu_torch stats <snapshot>``.

Monotonic timestamps are rebased to the unix epoch at build time
(``unix = monotonic + (time.time() - time.monotonic())``) so ranks align on
a common axis; ranks on one host share a clock exactly, across hosts the
alignment is as good as NTP — good enough for straggler attribution, which
operates at checkpoint-duration scale.

Module-level imports are stdlib-only (package imports are lazy): this file
must be importable from ``telemetry/__init__`` before torch/numpy and without
cycles through the storage layer.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
from typing import Any, Dict, Iterable, List, Optional

SCHEMA_VERSION = 1
ARTIFACT_DIR = ".telemetry"


def artifact_path(rank: int, op: str = "take") -> str:
    """Storage path of one rank's artifact. ``take`` and ``async_take``
    share the ``rank_<k>.json`` name (one take per snapshot path — the
    ``op`` field inside distinguishes them); restores write alongside under
    ``restore_rank_<k>.json`` so they never clobber the take's record."""
    if op in ("take", "async_take"):
        return f"{ARTIFACT_DIR}/rank_{rank}.json"
    return f"{ARTIFACT_DIR}/{op}_rank_{rank}.json"


def _round_intervals(
    intervals: Iterable, offset: float
) -> List[List[float]]:
    return [[round(t0 + offset, 6), round(t1 + offset, 6)] for t0, t1 in intervals]


def build_artifact(
    op: str,
    rank: int,
    world_size: int,
    tm: Optional[Any] = None,
    phase_spans: Optional[Iterable[Any]] = None,
    io_summary: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble one rank's artifact dict.

    ``tm``: the op's :class:`~.core.Telemetry` session (metrics dump +
    dropped-span count), or None. ``phase_spans``: the op's
    :class:`~.core.PhaseTracker` spans (or any completed Span iterable) —
    they become wall-clock-stamped phase records. ``io_summary``: the write
    pipeline's summary (``scheduler.PendingIOWork.telemetry_io_summary``).
    """
    from ..utils import knobs
    from ..version import __version__

    offset = time.time() - time.monotonic()
    artifact: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "op": op,
        "rank": int(rank),
        "world_size": int(world_size),
        "created_unix": round(time.time(), 6),
        "library_version": __version__,
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "python": sys.version.split()[0],
        "env": {"knobs": knobs.env_fingerprint()},
        "phases_s": {},
        "phase_spans": [],
    }
    for sp in phase_spans or ():
        dur = sp.dur or 0.0
        artifact["phase_spans"].append(
            {
                "name": sp.name,
                "ts_unix": round(sp.ts + offset, 6),
                "dur_s": round(dur, 6),
            }
        )
        artifact["phases_s"][sp.name] = round(
            artifact["phases_s"].get(sp.name, 0.0) + dur, 6
        )
    if io_summary is not None:
        artifact["pipeline_stats_s"] = {
            k: round(v, 6) for k, v in (io_summary.get("pipeline_stats_s") or {}).items()
        }
        artifact["drain_stats_s"] = {
            k: round(v, 6) for k, v in (io_summary.get("drain_stats_s") or {}).items()
        }
        artifact["bytes"] = dict(io_summary.get("bytes") or {})
        artifact["requests"] = dict(io_summary.get("requests") or {})
        artifact["intervals"] = {
            "windows": _round_intervals(io_summary.get("windows") or (), offset),
            "stage": _round_intervals(io_summary.get("stage_intervals") or (), offset),
            "io": _round_intervals(io_summary.get("io_intervals") or (), offset),
        }
        # stage_busy decomposition: merged d2h/serialize/hash sub-stream
        # intervals (additive, schema v1-compatible — readers that don't
        # know them ignore extra keys). The scalar views live in
        # pipeline_stats_s/drain_stats_s as stage_<kind>_s.
        for kind, ivs in (io_summary.get("stage_substreams") or {}).items():
            artifact["intervals"][f"stage_{kind}"] = _round_intervals(
                ivs, offset
            )
        # Engine/QoS introspection (additive, v1-compatible): preemption
        # totals and closed pause episodes, wall-clock-stamped like every
        # other interval stream.
        eng = io_summary.get("engine")
        if eng is not None:
            artifact["engine"] = {
                "preemptions": eng.get("preemptions", 0) or 0,
                "preempted_wait_s": round(
                    eng.get("preempted_wait_s", 0.0) or 0.0, 6
                ),
                "pause_intervals": _round_intervals(
                    eng.get("pause_intervals") or (), offset
                ),
            }
    if tm is not None:
        artifact["metrics"] = tm.metrics.as_dict()
        artifact["spans_dropped"] = tm.buffer.dropped
    return artifact


def dumps_artifact(artifact: Dict[str, Any]) -> bytes:
    return json.dumps(artifact, sort_keys=True).encode("utf-8")


def parse_artifact(data: bytes) -> Dict[str, Any]:
    """Decode + validate one artifact. Raises ``ValueError`` on anything
    that isn't a readable artifact of a schema this library understands —
    callers (the aggregator) degrade per rank, never crash the merge."""
    try:
        parsed = json.loads(bytes(data).decode("utf-8"))
    except Exception as e:
        raise ValueError(f"unparseable telemetry artifact: {e!r}") from e
    if not isinstance(parsed, dict):
        raise ValueError(
            f"telemetry artifact is not a JSON object: {type(parsed).__name__}"
        )
    version = parsed.get("schema_version")
    if not isinstance(version, int):
        raise ValueError("telemetry artifact has no integer schema_version")
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"telemetry artifact schema v{version} is newer than this "
            f"library understands (v{SCHEMA_VERSION})"
        )
    if "rank" not in parsed or "op" not in parsed:
        raise ValueError("telemetry artifact missing rank/op")
    return parsed

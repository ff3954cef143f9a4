"""Per-step telemetry rollups for job-mode checkpointing.

Each ``take(job=, step=)`` commit appends ONE compact, schema-versioned
step-telemetry record beside the catalog record (``catalog.py`` owns the
paths and storage IO; ``snapshot.py`` hooks the commit). The record is a
pure derivation of the per-rank artifacts every rank persisted before the
commit barrier — rank 0 merges them through ``aggregate.aggregate`` and
keeps only the scalars a trend line needs: step stall, drain wall,
phase-duration spread, bytes written/deduped, cache/preemption counters,
and cross-rank skew. Losing one (fail-open, like the artifacts themselves)
loses nothing permanent: it can be rebuilt from the snapshot's
``.telemetry/rank_<k>.json`` files as long as the snapshot lives.

The step series is the substrate the health detectors (``health.py``) and
the ``timeline`` CLI run over: KB-sized records, one list() per job, no
need to touch any snapshot's tree.

Module-level imports are stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Iterable, List, Optional

STEP_SCHEMA_VERSION = 1

# Metric counters worth trending step over step, summed across ranks.
# Missing ones (metric never incremented, telemetry session absent on a
# rank) simply stay 0 — the detectors treat 0 as "quiet", not "broken".
_COUNTER_METRICS = {
    "preemptions": "engine.preemptions",
    "preempted_wait_s": "engine.preempted_wait_s",
    "stall_warnings": "scheduler.stall_warnings",
    "stream_chunks": "scheduler.stream_chunks",
    "cache_hits": "cache.hits",
    "cache_misses": "cache.misses",
}


def _sum_metric(artifacts: Dict[int, Dict[str, Any]], key: str) -> float:
    total = 0.0
    for a in artifacts.values():
        v = (a.get("metrics") or {}).get(key)
        if isinstance(v, (int, float)):
            total += v
    return total


def build_step_record(
    job: str,
    step: int,
    name: str,
    agg: Dict[str, Any],
    artifacts: Dict[int, Dict[str, Any]],
    base: Optional[str] = None,
    chain_len: Optional[int] = None,
) -> Dict[str, Any]:
    """Roll one step's per-rank artifacts (already merged into ``agg`` by
    :func:`aggregate.aggregate`) into the compact step record."""
    per_rank = agg.get("per_rank") or {}

    # Step stall: the wall time this step held the training loop. For an
    # async_take the phases are exactly the synchronous planning/staging
    # slice before control returns (the drain overlaps training); for a
    # sync op the drain blocks the loop too, so a rank's stall is its
    # phase total plus its drain wall. Max over ranks either way — the
    # loop resumes when the slowest rank does.
    is_async = agg.get("op") == "async_take"
    stall_s = 0.0
    for rank, p in per_rank.items():
        rank_stall = sum((p.get("phases_s") or {}).values())
        if not is_async:
            art = artifacts.get(rank) or {}
            rank_stall += (
                (art.get("drain_stats_s") or {}).get("wall_s", 0.0) or 0.0
            )
        stall_s = max(stall_s, rank_stall)

    drain_wall_s = 0.0
    for a in artifacts.values():
        drain_wall_s = max(
            drain_wall_s, (a.get("drain_stats_s") or {}).get("wall_s", 0.0)
        )

    totals = agg.get("totals") or {}
    bytes_written = totals.get("bytes_written", 0) or 0
    bytes_deduped = sum(p.get("bytes_deduped", 0) or 0 for p in per_rank.values())

    counters = {
        out: round(_sum_metric(artifacts, key), 6)
        for out, key in _COUNTER_METRICS.items()
    }

    skew_in = agg.get("skew") or {}
    skew = {}
    if skew_in:
        skew = {
            "end_skew_s": skew_in.get("end_skew_s", 0.0),
            "straggler_rank": skew_in.get("straggler_rank"),
        }

    phases = {
        pname: {
            "mean": round(rec.get("mean", 0.0), 6),
            "max": round(rec.get("max", 0.0), 6),
            "max_rank": rec.get("max_rank"),
        }
        for pname, rec in (agg.get("phases_s") or {}).items()
    }

    return {
        "schema_version": STEP_SCHEMA_VERSION,
        "job": job,
        "step": int(step),
        "name": name,
        "base": base,
        "chain_len": chain_len,
        "created_unix": round(time.time(), 6),
        "op": agg.get("op"),
        "world_size": agg.get("world_size"),
        "ranks_present": len(agg.get("ranks") or ()),
        "missing_ranks": list(agg.get("missing_ranks") or ()),
        "wall_s": round(totals.get("wall_s", 0.0) or 0.0, 6),
        "stall_s": round(stall_s, 6),
        "drain_wall_s": round(drain_wall_s, 6),
        "drain_gbps": round(bytes_written / 1e9 / drain_wall_s, 6)
        if drain_wall_s > 0
        else 0.0,
        "phases_s": phases,
        "bytes": {"written": bytes_written, "deduped": bytes_deduped},
        "counters": counters,
        "skew": skew,
        "spans_dropped": agg.get("spans_dropped", 0) or 0,
    }


def dumps_step_record(record: Dict[str, Any]) -> bytes:
    return json.dumps(record, sort_keys=True).encode("utf-8")


def parse_step_record(data: bytes) -> Dict[str, Any]:
    """Decode + validate one step record; ``ValueError`` on anything that
    isn't one this library understands — callers degrade per record."""
    try:
        parsed = json.loads(bytes(data).decode("utf-8"))
    except Exception as e:
        raise ValueError(f"unparseable step-telemetry record: {e!r}") from e
    if not isinstance(parsed, dict):
        raise ValueError(
            f"step-telemetry record is not a JSON object: {type(parsed).__name__}"
        )
    version = parsed.get("schema_version")
    if not isinstance(version, int):
        raise ValueError("step-telemetry record has no integer schema_version")
    if version > STEP_SCHEMA_VERSION:
        raise ValueError(
            f"step-telemetry record schema v{version} is newer than this "
            f"library understands (v{STEP_SCHEMA_VERSION})"
        )
    if "job" not in parsed or "step" not in parsed:
        raise ValueError("step-telemetry record missing job/step")
    return parsed


# ---------------------------------------------------------------------------
# Rollout (restore-side) records: the read half of the step series. One
# record per `restore(job=)` per rank — restores are where a serving fleet
# actually spends its time, and per-rank origin/peer/cache attribution is
# the restore-side fact worth trending (a regressing cache-hit ratio shows
# up here steps before it shows up as wall time).
# ---------------------------------------------------------------------------

ROLLOUT_SCHEMA_VERSION = 1


def build_rollout_record(
    job: str,
    step: Optional[int],
    name: str,
    rank: int,
    world_size: int,
    wall_s: float,
    attribution: Optional[Dict[str, Any]] = None,
    mode: Optional[str] = None,
) -> Dict[str, Any]:
    """One rank's record of one restore: wall time plus where the bytes
    came from (``origin_bytes``/``peer_bytes``/``cache_bytes``, the
    ``LAST_RESTORE_STATS`` attribution dict)."""
    attr = attribution or {}
    return {
        "schema_version": ROLLOUT_SCHEMA_VERSION,
        "kind": "rollout",
        "job": job,
        "step": int(step) if step is not None else None,
        "name": name,
        "rank": int(rank),
        "world_size": int(world_size),
        "created_unix": round(time.time(), 6),
        "wall_s": round(float(wall_s), 6),
        "mode": mode,
        "bytes": {
            "origin": int(attr.get("origin_bytes", 0) or 0),
            "peer": int(attr.get("peer_bytes", 0) or 0),
            "cache": int(attr.get("cache_bytes", 0) or 0),
        },
    }


def dumps_rollout_record(record: Dict[str, Any]) -> bytes:
    return json.dumps(record, sort_keys=True).encode("utf-8")


def parse_rollout_record(data: bytes) -> Dict[str, Any]:
    """Decode + validate one rollout record; ``ValueError`` on anything
    this library doesn't understand — callers degrade per record."""
    try:
        parsed = json.loads(bytes(data).decode("utf-8"))
    except Exception as e:
        raise ValueError(f"unparseable rollout record: {e!r}") from e
    if not isinstance(parsed, dict):
        raise ValueError(
            f"rollout record is not a JSON object: {type(parsed).__name__}"
        )
    version = parsed.get("schema_version")
    if not isinstance(version, int):
        raise ValueError("rollout record has no integer schema_version")
    if version > ROLLOUT_SCHEMA_VERSION:
        raise ValueError(
            f"rollout record schema v{version} is newer than this library "
            f"understands (v{ROLLOUT_SCHEMA_VERSION})"
        )
    if "job" not in parsed or "name" not in parsed:
        raise ValueError("rollout record missing job/name")
    return parsed


def summarize_series(series: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Scalar summary of a step series for bench artifacts / CLI headers."""
    recs: List[Dict[str, Any]] = sorted(series, key=lambda r: r.get("step", 0))
    if not recs:
        return {"steps": 0}

    def vals(key: str) -> List[float]:
        out = []
        for r in recs:
            v = r.get(key)
            if isinstance(v, (int, float)):
                out.append(float(v))
        return out

    def stats(xs: List[float]) -> Dict[str, float]:
        if not xs:
            return {"mean": 0.0, "max": 0.0}
        s = sorted(xs)
        return {
            "mean": round(sum(xs) / len(xs), 6),
            "p50": round(s[len(s) // 2], 6),
            "max": round(max(xs), 6),
        }

    return {
        "steps": len(recs),
        "first_step": recs[0].get("step"),
        "last_step": recs[-1].get("step"),
        "stall_s": stats(vals("stall_s")),
        "drain_wall_s": stats(vals("drain_wall_s")),
        "drain_gbps": stats(vals("drain_gbps")),
        "bytes_written_total": sum(
            (r.get("bytes") or {}).get("written", 0) or 0 for r in recs
        ),
        "preemptions_total": sum(
            (r.get("counters") or {}).get("preemptions", 0) or 0 for r in recs
        ),
    }

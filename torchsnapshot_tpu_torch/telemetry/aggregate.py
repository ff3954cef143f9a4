"""Cross-rank aggregation of persisted telemetry artifacts.

Merges the per-rank ``.telemetry/rank_<k>.json`` artifacts (``artifact.py``)
into one fleet view: per-rank throughput, phase-duration spread, end-time
skew, straggler identification, and commit-barrier wait attribution — the
rank that finishes its drain last holds every other rank at the commit
barrier, so each rank's wait is ``max(end) - own end`` (exact within one
host's clock, NTP-accurate across hosts). Degrades per rank: a missing or
unreadable artifact is reported, never fatal — a fleet view over W-1 ranks
still names the straggler among those present.

Also builds the multi-rank Chrome/Perfetto trace (``pid`` = rank, one
process track per rank with phase + stage/io-busy sub-tracks) in the same
JSON object form ``export.py`` emits, so https://ui.perfetto.dev opens it
directly.

Operator surface: ``python -m torchsnapshot_tpu_torch stats <snapshot>`` and
``... compare <a> <b>`` (see ``__main__.py``); programmatic surface:
:func:`read_snapshot_artifacts` → :func:`aggregate` → :func:`format_stats`.

Module-level imports are stdlib-only; storage/manifest imports are lazy so
``telemetry/__init__`` can re-export this module without cycles. The port's
copy of ``torchsnapshot_tpu/telemetry/aggregate.py``: the same schema and
output, read through the port's storage plugins.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from ..utils import knobs
from .artifact import artifact_path, parse_artifact
from .export import TRACE_FORMAT_VERSION


def read_artifacts(
    storage: Any,
    event_loop: Any,
    world_size: int,
    op: str = "take",
) -> Tuple[Dict[int, Dict[str, Any]], Dict[int, str]]:
    """Read every rank's artifact through ``storage``.

    Returns ``(artifacts, problems)``: ``artifacts[rank]`` for each readable
    one, ``problems[rank]`` = ``"missing"`` / ``"unreadable (...)"`` /
    ``"invalid (...)"`` for the rest. Reads run concurrently under the
    usual per-plugin IO cap.
    """
    from ..io_types import ReadIO
    from . import span

    artifacts: Dict[int, Dict[str, Any]] = {}
    problems: Dict[int, str] = {}

    async def read_all() -> None:
        sem = asyncio.Semaphore(knobs.get_max_concurrent_io_for(storage))

        async def read_one(rank: int) -> None:
            async with sem:
                read_io = ReadIO(path=artifact_path(rank, op))
                with span(
                    "telemetry.artifact_read",
                    cat="telemetry",
                    path=read_io.path,
                    rank=rank,
                ):
                    try:
                        await storage.read(read_io)
                    except FileNotFoundError:
                        problems[rank] = "missing"
                        return
                    except Exception as e:  # noqa: BLE001 - degrade per rank
                        problems[rank] = f"unreadable ({e!r})"
                        return
                try:
                    artifacts[rank] = parse_artifact(bytes(read_io.buf))
                except ValueError as e:
                    problems[rank] = f"invalid ({e})"

        await asyncio.gather(*(read_one(r) for r in range(world_size)))

    event_loop.run_until_complete(read_all())
    return artifacts, problems


def read_snapshot_artifacts(
    path: str, op: str = "take"
) -> Tuple[int, Dict[int, Dict[str, Any]], Dict[int, str]]:
    """Convenience wrapper: open ``path``'s storage plugin, learn the world
    size from the committed metadata, read all artifacts, close. Returns
    ``(world_size, artifacts, problems)``."""
    from ..io_types import ReadIO
    from ..manifest import SNAPSHOT_METADATA_FNAME, SnapshotMetadata
    from ..storage_plugin import url_to_storage_plugin

    event_loop = asyncio.new_event_loop()
    storage = url_to_storage_plugin(path)
    try:
        read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
        storage.sync_read(read_io, event_loop)
        metadata = SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8"))
        artifacts, problems = read_artifacts(
            storage, event_loop, metadata.world_size, op=op
        )
        return metadata.world_size, artifacts, problems
    finally:
        storage.sync_close(event_loop)
        event_loop.close()


def _rank_window(artifact: Dict[str, Any]) -> Tuple[Optional[float], Optional[float]]:
    """(first, last) unix timestamp this rank's artifact covers: phase spans
    plus pipeline accounting windows."""
    start: Optional[float] = None
    end: Optional[float] = None

    def fold(t0: float, t1: float) -> None:
        nonlocal start, end
        start = t0 if start is None else min(start, t0)
        end = t1 if end is None else max(end, t1)

    for sp in artifact.get("phase_spans") or []:
        try:
            fold(float(sp["ts_unix"]), float(sp["ts_unix"]) + float(sp["dur_s"]))
        except (KeyError, TypeError, ValueError):
            continue
    for w in (artifact.get("intervals") or {}).get("windows") or []:
        try:
            fold(float(w[0]), float(w[1]))
        except (IndexError, TypeError, ValueError):
            continue
    return start, end


def aggregate(
    artifacts: Dict[int, Dict[str, Any]], world_size: Optional[int] = None
) -> Dict[str, Any]:
    """Merge per-rank artifacts into the fleet view. Tolerates missing
    ranks (they appear in ``missing_ranks``; every derived stat covers the
    present ranks only)."""
    ranks = sorted(artifacts)
    ws = world_size or max(
        [a.get("world_size", 0) for a in artifacts.values()]
        + [(max(ranks) + 1) if ranks else 0]
    )
    per_rank: Dict[int, Dict[str, Any]] = {}
    starts: Dict[int, float] = {}
    ends: Dict[int, float] = {}
    for r in ranks:
        a = artifacts[r]
        stats = a.get("pipeline_stats_s") or {}
        nbytes = a.get("bytes") or {}
        written = nbytes.get("written", nbytes.get("staged", 0)) or 0
        wall = stats.get("wall_s", 0.0)
        start, end = _rank_window(a)
        # Engine/QoS section (artifacts since the flight-recorder PR); fall
        # back to the live metric counters older artifacts carry.
        eng = a.get("engine") or {}
        metrics = a.get("metrics") or {}
        preemptions = eng.get(
            "preemptions", metrics.get("engine.preemptions", 0)
        ) or 0
        preempted_wait_s = eng.get(
            "preempted_wait_s", metrics.get("engine.preempted_wait_s", 0.0)
        ) or 0.0
        per_rank[r] = {
            "op": a.get("op"),
            "hostname": a.get("hostname"),
            "wall_s": wall,
            "stage_busy_s": stats.get("stage_busy_s", 0.0),
            "io_busy_s": stats.get("io_busy_s", 0.0),
            "overlap_s": stats.get("overlap_s", 0.0),
            "idle_s": stats.get("idle_s", 0.0),
            "bytes_written": written,
            "bytes_deduped": nbytes.get("deduped", 0) or 0,
            "gbps": (written / 1e9 / wall) if wall > 0 else 0.0,
            "phases_s": dict(a.get("phases_s") or {}),
            "spans_dropped": a.get("spans_dropped", 0) or 0,
            "start_unix": start,
            "end_unix": end,
            "preemptions": preemptions,
            "preempted_wait_s": round(preempted_wait_s, 6),
            "pause_intervals": list(eng.get("pause_intervals") or ()),
        }
        if start is not None:
            starts[r] = start
        if end is not None:
            ends[r] = end

    phases: Dict[str, Dict[str, Any]] = {}
    for name in sorted({n for r in ranks for n in per_rank[r]["phases_s"]}):
        vals = {r: per_rank[r]["phases_s"].get(name, 0.0) for r in ranks}
        max_rank = max(vals, key=lambda r: vals[r])
        phases[name] = {
            "mean": sum(vals.values()) / len(vals),
            "max": vals[max_rank],
            "max_rank": max_rank,
        }

    skew: Dict[str, Any] = {}
    if ends:
        last = max(ends.values())
        straggler = max(ends, key=lambda r: ends[r])
        skew = {
            "end_skew_s": round(last - min(ends.values()), 6),
            "straggler_rank": straggler,
            # The straggler releases the commit barrier: everyone else's
            # wait is the gap to its finish (0 for the straggler itself).
            "barrier_wait_s": {r: round(last - e, 6) for r, e in ends.items()},
        }

    total_written = sum(p["bytes_written"] for p in per_rank.values())
    fleet_wall = 0.0
    if starts and ends:
        fleet_wall = max(ends.values()) - min(starts.values())

    storage_bytes: Dict[str, float] = {}
    for r in ranks:
        for key, value in (artifacts[r].get("metrics") or {}).items():
            if key.startswith("storage.") and key.rsplit(".", 1)[-1] in (
                "write_bytes",
                "read_bytes",
                "link_in_count",
            ):
                storage_bytes[key] = storage_bytes.get(key, 0) + value

    return {
        "op": per_rank[ranks[0]]["op"] if ranks else None,
        "world_size": ws,
        "ranks": ranks,
        "missing_ranks": [r for r in range(ws) if r not in artifacts],
        "per_rank": per_rank,
        "phases_s": phases,
        "skew": skew,
        "totals": {
            "bytes_written": total_written,
            "wall_s": round(fleet_wall, 6),
            "gbps": (total_written / 1e9 / fleet_wall) if fleet_wall > 0 else 0.0,
        },
        "storage_bytes": storage_bytes,
        "spans_dropped": sum(p["spans_dropped"] for p in per_rank.values()),
        "qos": {
            "preemptions": sum(p["preemptions"] for p in per_rank.values()),
            "preempted_wait_s": round(
                sum(p["preempted_wait_s"] for p in per_rank.values()), 6
            ),
        },
    }


def fleet_view(
    beacons: Dict[int, Dict[str, Any]],
    world_size: Optional[int] = None,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """Merge one live beacon read (``fleet.read_beacons``) into the same
    fleet-view shape :func:`aggregate` builds from committed artifacts —
    ranks/missing_ranks/per_rank plus the wait-edge list — so ``monitor
    --fleet`` and ``fleet-health`` share table math with ``stats``."""
    import time as _time

    from . import fleet

    t = _time.time() if now is None else now
    ranks = sorted(beacons)
    ws = world_size or fleet.fleet_world_size(beacons)
    per_rank: Dict[int, Dict[str, Any]] = {}
    edges: List[Dict[str, Any]] = []
    for r in ranks:
        b = beacons[r]
        eng = b.get("engine") or {}
        prog = b.get("progress") or {}
        qos = b.get("qos") or {}
        per_rank[r] = {
            "op": b.get("op"),
            "phase": b.get("phase"),
            "age_s": round(t - (b.get("ts_unix") or 0.0), 3),
            "pid": b.get("pid"),
            "seq": b.get("seq"),
            "engine": eng.get("engine"),
            "engine_paused": eng.get("paused"),
            "budget_hwm": eng.get("budget_hwm"),
            "bytes_written": prog.get("bytes_written"),
            "bytes_total": prog.get("bytes_total"),
            "bytes_per_s_ewma": prog.get("bytes_per_s_ewma"),
            "eta_s": prog.get("eta_s"),
            "qos_demand": qos.get("demand"),
            "anomalies": dict(b.get("anomalies") or {}),
            "blocked_on": list(b.get("blocked_on") or []),
        }
        for edge in b.get("blocked_on") or []:
            try:
                edges.append(
                    {
                        "rank": r,
                        "peer": edge[0],
                        "site": edge[1],
                        "age_s": edge[2],
                    }
                )
            except Exception:  # noqa: BLE001 - malformed edge: skip
                continue
    interval = max(
        [b.get("interval_s") or 0.0 for b in beacons.values()] + [0.0]
    )
    return {
        "world_size": ws,
        "ranks": ranks,
        "missing_ranks": [r for r in range(ws) if r not in beacons],
        "per_rank": per_rank,
        "edges": sorted(edges, key=lambda e: -(e.get("age_s") or 0.0)),
        "interval_s": interval,
    }


def format_fleet(view: Dict[str, Any]) -> List[str]:
    """Human-readable live fleet table + wait edges, one string per line."""
    lines: List[str] = []
    lines.append(
        f"fleet: world_size={view['world_size']}  "
        f"beacons={len(view['ranks'])}  "
        f"interval={view.get('interval_s', 0.0):.2f}s"
    )
    lines.append(
        "rank   age_s  op          phase                 "
        "done_GB/total_GB    MB/s    eta_s  flags"
    )
    for r in view["ranks"]:
        p = view["per_rank"][r]
        done = p.get("bytes_written")
        total = p.get("bytes_total")
        prog = (
            f"{(done or 0) / 1e9:8.3f}/{(total or 0) / 1e9:<8.3f}"
            if done is not None
            else " " * 17
        )
        rate = p.get("bytes_per_s_ewma")
        eta = p.get("eta_s")
        flags = []
        if p.get("engine_paused"):
            flags.append("paused")
        flags.extend(sorted(p.get("anomalies") or ()))
        lines.append(
            f"{r:4d} {p['age_s']:7.1f}  {str(p.get('op') or '-'):<10}  "
            f"{str(p.get('phase') or '-'):<20}  {prog} "
            f"{(rate or 0.0) / 1e6:7.1f} {eta if eta is not None else '-':>8} "
            f" {','.join(flags)}"
        )
    for r in view["missing_ranks"]:
        lines.append(f"{r:4d}       -  (no beacon)")
    if view["edges"]:
        lines.append("waiting on:")
        for e in view["edges"]:
            peer = e["peer"]
            peer_phase = None
            if isinstance(peer, int):
                pp = view["per_rank"].get(peer)
                if pp is not None:
                    peer_phase = pp.get("phase") or pp.get("op")
            suffix = f" (last phase: {peer_phase})" if peer_phase else ""
            lines.append(
                f"  rank {e['rank']} -> {peer} at {e['site']} "
                f"for {e['age_s']:.1f}s{suffix}"
            )
    else:
        lines.append("waiting on: nothing")
    return lines


def format_stats(agg: Dict[str, Any]) -> List[str]:
    """Human-readable fleet view, one string per output line."""
    lines: List[str] = []
    lines.append(
        f"op={agg['op']}  world_size={agg['world_size']}  "
        f"ranks_present={len(agg['ranks'])}"
    )
    totals = agg["totals"]
    lines.append(
        f"total {totals['bytes_written'] / 1e9:.3f} GB written in "
        f"{totals['wall_s']:.2f}s ({totals['gbps']:.3f} GB/s fleet-wide)"
    )
    lines.append(
        "rank  wall_s  stage_s     io_s  overlap      GB    GB/s  barrier_wait_s"
    )
    barrier_wait = (agg.get("skew") or {}).get("barrier_wait_s") or {}
    for r in agg["ranks"]:
        p = agg["per_rank"][r]
        lines.append(
            f"{r:4d} {p['wall_s']:7.2f} {p['stage_busy_s']:8.2f} "
            f"{p['io_busy_s']:8.2f} {p['overlap_s']:8.2f} "
            f"{p['bytes_written'] / 1e9:7.3f} {p['gbps']:7.3f} "
            f"{barrier_wait.get(r, 0.0):15.3f}"
        )
    if agg["phases_s"]:
        lines.append("phases (s, mean / max @rank):")
        for name, rec in agg["phases_s"].items():
            lines.append(
                f"  {name:<24} {rec['mean']:8.4f} / {rec['max']:8.4f} "
                f"@{rec['max_rank']}"
            )
    if agg.get("skew"):
        lines.append(
            f"straggler: rank {agg['skew']['straggler_rank']} "
            f"(end skew {agg['skew']['end_skew_s']:.3f}s across ranks)"
        )
    qos = agg.get("qos") or {}
    if qos.get("preemptions"):
        waves = sum(
            len(p.get("pause_intervals") or ())
            for p in agg["per_rank"].values()
        )
        lines.append(
            f"qos: {qos['preemptions']} preemptions, "
            f"{qos['preempted_wait_s']:.3f}s paused across ranks "
            f"({waves} pause waves)"
        )
    if agg["storage_bytes"]:
        lines.append("storage:")
        for key in sorted(agg["storage_bytes"]):
            lines.append(f"  {key} = {agg['storage_bytes'][key]}")
    for r in agg["missing_ranks"]:
        lines.append(f"note: rank {r} artifact missing — stats above exclude it")
    return lines


def diff_stats(
    agg_a: Dict[str, Any],
    agg_b: Dict[str, Any],
    label_a: str = "A",
    label_b: str = "B",
) -> List[str]:
    """Side-by-side comparison of two aggregated fleet views."""

    def ratio(b: float, a: float) -> str:
        if a <= 0:
            return "n/a"
        return f"{b / a:+.2f}x" if b >= 0 else "n/a"

    lines: List[str] = []
    ta, tb = agg_a["totals"], agg_b["totals"]
    lines.append(f"{'':<24} {label_a:>12} {label_b:>12}    B/A")
    for key, scale, fmt in (
        ("bytes_written", 1e9, "{:.3f}"),
        ("wall_s", 1.0, "{:.2f}"),
        ("gbps", 1.0, "{:.3f}"),
    ):
        va, vb = ta[key] / scale, tb[key] / scale
        lines.append(
            f"{key:<24} {fmt.format(va):>12} {fmt.format(vb):>12}    "
            f"{ratio(vb, va)}"
        )
    names = sorted(set(agg_a["phases_s"]) | set(agg_b["phases_s"]))
    if names:
        lines.append("phases (max across ranks, s):")
        for name in names:
            va = (agg_a["phases_s"].get(name) or {}).get("max", 0.0)
            vb = (agg_b["phases_s"].get(name) or {}).get("max", 0.0)
            lines.append(
                f"  {name:<22} {va:>12.4f} {vb:>12.4f}    {ratio(vb, va)}"
            )
    sa = (agg_a.get("skew") or {}).get("end_skew_s")
    sb = (agg_b.get("skew") or {}).get("end_skew_s")
    if sa is not None or sb is not None:
        lines.append(
            f"end skew (s): {label_a}={sa if sa is not None else 'n/a'} "
            f"{label_b}={sb if sb is not None else 'n/a'}"
        )
    return lines


def merged_chrome_trace(artifacts: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """Multi-rank Chrome/Perfetto trace: ``pid`` = rank; per rank, a phase
    track plus stage-busy/io-busy interval tracks (the artifact's merged
    intervals — per-task spans live only in the full per-rank trace files).
    Timestamps rebase to the earliest instant any rank recorded, so the
    cross-rank skew is directly visible on the shared axis."""
    base: Optional[float] = None
    for a in artifacts.values():
        start, _ = _rank_window(a)
        if start is not None:
            base = start if base is None else min(base, start)
    base = base or 0.0

    events: List[Dict[str, Any]] = []
    for rank in sorted(artifacts):
        a = artifacts[rank]
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": rank,
                "tid": 0,
                "args": {"name": f"rank {rank} ({a.get('op', '?')})"},
            }
        )
        tracks = [(0, "phases"), (1, "stage_busy"), (2, "io_busy")]
        for tid, name in tracks:
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": rank,
                    "tid": tid,
                    "args": {"name": name},
                }
            )
        for sp in a.get("phase_spans") or []:
            events.append(
                {
                    "name": sp["name"],
                    "cat": "take.phase",
                    "ph": "X",
                    "ts": max(0.0, (float(sp["ts_unix"]) - base) * 1e6),
                    "dur": float(sp["dur_s"]) * 1e6,
                    "pid": rank,
                    "tid": 0,
                    "args": {"rank": rank},
                }
            )
        intervals = a.get("intervals") or {}
        for tid, name, key in ((1, "stage_busy", "stage"), (2, "io_busy", "io")):
            for t0, t1 in intervals.get(key) or []:
                events.append(
                    {
                        "name": name,
                        "cat": "scheduler",
                        "ph": "X",
                        "ts": max(0.0, (float(t0) - base) * 1e6),
                        "dur": (float(t1) - float(t0)) * 1e6,
                        "pid": rank,
                        "tid": tid,
                        "args": {"rank": rank},
                    }
                )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "format_version": TRACE_FORMAT_VERSION,
            "producer": "torchsnapshot_tpu_torch.telemetry.aggregate",
            "ranks": sorted(artifacts),
            "dropped_spans": sum(
                a.get("spans_dropped", 0) or 0 for a in artifacts.values()
            ),
            "metrics": {},
        },
    }


def write_merged_chrome_trace(
    artifacts: Dict[int, Dict[str, Any]], path: str
) -> None:
    """Atomic (tmp + replace): a crashed export never leaves a torn trace
    for a trace viewer or a concurrent reader to choke on."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(merged_chrome_trace(artifacts), f)
    os.replace(tmp, path)

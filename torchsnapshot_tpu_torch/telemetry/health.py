"""Anomaly detectors over the per-step telemetry series.

Input is the step-record series ``steprecord.py`` defines (one record per
``take(job=, step=)`` commit); output is structured health events — the
drifts the ROADMAP's perf wars were found by hand-diffing bench artifacts:
a step-stall spike against the job's own trailing median, the streaming
throughput inversion, a drain-rate cliff, a straggler that stops rotating,
and catalog-bucket growth outrunning the retention policy.

Detection is deliberately relative: every threshold compares a step against
the job's own trailing history (median over a sliding window) with an
absolute floor, so a job that is *consistently* slow is quiet (that is a
provisioning problem, not a drift) and small-numbers jitter on fast steps
cannot trip a ratio test. Detectors need ``MIN_HISTORY`` prior steps before
they arm — a short series produces no events, never a guess.

Surfaces: ``python -m torchsnapshot_tpu_torch timeline <bucket> --job <j>``
renders the trend table with flagged steps; ``benchmarks/continuous``
embeds the same render in its artifact; :func:`log_anomalies` emits ONE
log warning per anomaly kind (not per step) so a 500-step drift does not
flood the job log.

Module-level imports are stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, List, Optional

logger = logging.getLogger(__name__)

# Steps of prior history a trailing-median test needs before it arms.
MIN_HISTORY = 5
# Trailing window the medians are computed over.
WINDOW = 20

# stall_s must exceed BOTH the ratio and the absolute margin over the
# trailing median — the floor keeps sub-100ms jitter from tripping the
# ratio on fast steps.
STALL_SPIKE_RATIO = 3.0
STALL_SPIKE_FLOOR_S = 0.4

# drain_wall_s spike (the drain-rate cliff seen from the wall side).
DRAIN_CLIFF_RATIO = 3.0
DRAIN_CLIFF_FLOOR_S = 1.0

# Streaming-throughput inversion: a streaming step whose drain_gbps falls
# below this fraction of the trailing median while bytes/step stays stable
# (within BYTES_STABLE_RATIO of the median — a genuinely bigger step is
# allowed to be slower).
STREAM_INVERSION_RATIO = 0.6
BYTES_STABLE_RATIO = 1.5

# Straggler drift: the same rank is the straggler for this many consecutive
# steps AND the skew is material (above floor and the trailing median
# ratio) — round-robin stragglers are healthy noise.
STRAGGLER_STREAK = 3
STRAGGLER_SKEW_RATIO = 2.0
STRAGGLER_SKEW_FLOOR_S = 0.2

# Bucket growth: bytes on disk exceed the retention-policy bound by this
# ratio while still growing — retention GC is losing the race.
BUCKET_GROWTH_RATIO = 1.5
BUCKET_GROWTH_STREAK = 5


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2.0


def _trailing(series: List[Dict[str, Any]], i: int, pick: Any) -> List[float]:
    out: List[float] = []
    for r in series[max(0, i - WINDOW) : i]:
        v = pick(r)
        if isinstance(v, (int, float)):
            out.append(float(v))
    return out


def _event(
    kind: str,
    step: Any,
    value: float,
    baseline: float,
    detail: str,
    rank: Optional[int] = None,
) -> Dict[str, Any]:
    ev = {
        "kind": kind,
        "step": step,
        "value": round(float(value), 6),
        "baseline": round(float(baseline), 6),
        "detail": detail,
    }
    if rank is not None:
        ev["rank"] = rank
    return ev


def detect_anomalies(
    series: Iterable[Dict[str, Any]],
    bucket_bytes: Optional[List[int]] = None,
    window_bound: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Run every detector over a step series (sorted by step internally).

    ``bucket_bytes``: optional per-step total bucket size (bytes on disk
    after each step's commit + GC), aligned with the sorted series — the
    continuous bench measures it; the CLI omits it. ``window_bound``: the
    retention policy's expected steady-state byte bound; the bucket-growth
    detector only arms when both are given.
    """
    recs = sorted(series, key=lambda r: r.get("step", 0))
    events: List[Dict[str, Any]] = []

    streak_rank: Optional[int] = None
    streak = 0
    for i, r in enumerate(recs):
        step = r.get("step")

        hist = _trailing(recs, i, lambda x: x.get("stall_s"))
        if len(hist) >= MIN_HISTORY:
            med = _median(hist)
            stall = r.get("stall_s") or 0.0
            if stall > max(STALL_SPIKE_RATIO * med, med + STALL_SPIKE_FLOOR_S):
                events.append(
                    _event(
                        "stall_spike",
                        step,
                        stall,
                        med,
                        f"step stall {stall:.3f}s vs trailing median {med:.3f}s",
                    )
                )

        hist = _trailing(recs, i, lambda x: x.get("drain_wall_s"))
        if len(hist) >= MIN_HISTORY:
            med = _median(hist)
            drain = r.get("drain_wall_s") or 0.0
            if drain > max(DRAIN_CLIFF_RATIO * med, med + DRAIN_CLIFF_FLOOR_S):
                events.append(
                    _event(
                        "drain_cliff",
                        step,
                        drain,
                        med,
                        f"drain wall {drain:.3f}s vs trailing median {med:.3f}s",
                    )
                )

        gbps_hist = _trailing(recs, i, lambda x: x.get("drain_gbps"))
        bytes_hist = _trailing(
            recs, i, lambda x: (x.get("bytes") or {}).get("written")
        )
        if len(gbps_hist) >= MIN_HISTORY:
            med_gbps = _median([v for v in gbps_hist if v > 0] or [0.0])
            med_bytes = _median(bytes_hist)
            gbps = r.get("drain_gbps") or 0.0
            step_bytes = (r.get("bytes") or {}).get("written", 0) or 0
            streaming = ((r.get("counters") or {}).get("stream_chunks") or 0) > 0
            bytes_stable = (
                med_bytes > 0 and step_bytes <= BYTES_STABLE_RATIO * med_bytes
            )
            if (
                streaming
                and med_gbps > 0
                and 0 < gbps < STREAM_INVERSION_RATIO * med_gbps
                and bytes_stable
            ):
                events.append(
                    _event(
                        "stream_inversion",
                        step,
                        gbps,
                        med_gbps,
                        f"streaming step drained at {gbps:.3f} GB/s vs "
                        f"trailing median {med_gbps:.3f} GB/s "
                        f"(bytes stable at {step_bytes / 1e9:.3f} GB)",
                    )
                )

        skew = r.get("skew") or {}
        rank = skew.get("straggler_rank")
        skew_s = skew.get("end_skew_s") or 0.0
        skew_hist = _trailing(
            recs, i, lambda x: (x.get("skew") or {}).get("end_skew_s")
        )
        med_skew = _median(skew_hist) if skew_hist else 0.0
        material = skew_s > max(
            STRAGGLER_SKEW_FLOOR_S, STRAGGLER_SKEW_RATIO * med_skew
        )
        if rank is not None and rank == streak_rank and material:
            streak += 1
        elif rank is not None and material:
            streak_rank, streak = rank, 1
        else:
            streak_rank, streak = None, 0
        if streak == STRAGGLER_STREAK:
            events.append(
                _event(
                    "straggler_drift",
                    step,
                    skew_s,
                    med_skew,
                    f"rank {rank} has been the straggler for "
                    f"{STRAGGLER_STREAK} consecutive steps "
                    f"(skew {skew_s:.3f}s vs median {med_skew:.3f}s)",
                    rank=rank,
                )
            )

    if bucket_bytes and window_bound and window_bound > 0:
        n = len(bucket_bytes)
        grow = 0
        for j in range(1, n):
            grow = grow + 1 if bucket_bytes[j] > bucket_bytes[j - 1] else 0
            if (
                grow >= BUCKET_GROWTH_STREAK
                and bucket_bytes[j] > BUCKET_GROWTH_RATIO * window_bound
            ):
                step = recs[j].get("step") if j < len(recs) else j
                events.append(
                    _event(
                        "bucket_growth",
                        step,
                        bucket_bytes[j],
                        window_bound,
                        f"bucket at {bucket_bytes[j] / 1e9:.3f} GB after "
                        f"{grow} consecutive growth steps, vs retention "
                        f"bound {window_bound / 1e9:.3f} GB",
                    )
                )
                break  # one event: the first step the policy lost the race

    return events


# ---------------------------------------------------------------------------
# Fleet detectors: live beacons (fleet.py) instead of a committed step
# series. The distinguishing power is the wait GRAPH — "rank 3 is slow"
# (everyone blocks on 3, 3 blocks on nobody) vs "rank 3 waits on the store"
# (3 has its own outgoing edge) vs a genuine deadlock cycle.
# ---------------------------------------------------------------------------

# A QoS pause edge older than this is starvation, not scheduling: the
# max-pause safety valve defaults to far less.
PAUSED_STARVATION_S = 30.0

# Straggler quorum: at least half of the OTHER ranks must be blocked on R.
STRAGGLER_QUORUM = 0.5


def _int_edges(beacon: Dict[str, Any]) -> List[Any]:
    """(peer, site, age_s) edges with integer (rank) peers."""
    out = []
    for edge in beacon.get("blocked_on") or []:
        try:
            peer, site, age = edge[0], edge[1], edge[2]
        except Exception:  # noqa: BLE001 - malformed edge: skip it
            continue
        if isinstance(peer, int):
            out.append((peer, site, age))
    return out


def detect_fleet_anomalies(
    beacons: Dict[int, Dict[str, Any]],
    interval_s: float,
    world_size: Optional[int] = None,
    now: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Run the live-fleet detectors over one beacon read.

    ``interval_s`` is the publish interval the staleness fence is derived
    from (``fleet.stale_after_s``); ``now`` (unix seconds) defaults to this
    host's clock — beacons carry ``ts_unix`` from their publishers, so the
    fence assumes loosely synchronized clocks (NTP-level, not device-level).

    Events reuse the step-series event shape (kind/step/value/baseline/
    detail/rank) with ``step=None`` — the ``fleet-health`` CLI and the
    timeline CLI share rendering and exit-code semantics.
    """
    import time as _time

    from . import fleet

    events: List[Dict[str, Any]] = []
    if not beacons:
        return events
    t = _time.time() if now is None else now
    stale_s = fleet.stale_after_s(interval_s)
    ws = world_size or fleet.fleet_world_size(beacons)

    ages = {r: t - (b.get("ts_unix") or 0.0) for r, b in beacons.items()}
    blocked_on_rank: Dict[int, List[int]] = {}
    for r, b in beacons.items():
        for peer, _site, _age in _int_edges(b):
            blocked_on_rank.setdefault(peer, []).append(r)

    # --- dead beacons: stale mid-op, or missing while someone waits on it.
    for r, b in beacons.items():
        if ages[r] > stale_s and b.get("op") is not None:
            events.append(
                _event(
                    "dead_beacon",
                    None,
                    ages[r],
                    stale_s,
                    f"rank {r} last beaconed {ages[r]:.1f}s ago mid-op "
                    f"({b.get('op')}/{b.get('phase')}); publisher dead or "
                    f"wedged below the publish sites",
                    rank=r,
                )
            )
    for r in range(ws):
        if r not in beacons and blocked_on_rank.get(r):
            waiters = sorted(blocked_on_rank[r])
            events.append(
                _event(
                    "dead_beacon",
                    None,
                    0.0,
                    stale_s,
                    f"rank {r} has no beacon at all while rank(s) "
                    f"{waiters} wait on it",
                    rank=r,
                )
            )

    # --- wait cycles: DFS over the rank->rank edges.
    graph = {
        r: sorted({p for p, _s, _a in _int_edges(b)}) for r, b in beacons.items()
    }
    color: Dict[int, int] = {}
    cycle: List[int] = []

    def _dfs(node: int, path: List[int]) -> bool:
        color[node] = 1
        for nxt in graph.get(node, []):
            if color.get(nxt) == 1:
                cycle.extend(path[path.index(nxt):] + [nxt]
                             if nxt in path else [node, nxt])
                return True
            if color.get(nxt, 0) == 0 and _dfs(nxt, path + [nxt]):
                return True
        color[node] = 2
        return False

    for r in graph:
        if color.get(r, 0) == 0 and _dfs(r, [r]):
            break
    if cycle:
        events.append(
            _event(
                "wait_cycle",
                None,
                float(len(cycle) - 1),
                0.0,
                "wait cycle: " + " -> ".join(str(n) for n in cycle),
                rank=cycle[0],
            )
        )

    # --- stragglers: a quorum of the other ranks blocked on R, R alive
    # with no outgoing rank edge (else R's own wait is the story — noted).
    for r, waiters in sorted(blocked_on_rank.items()):
        others = max(1, len(beacons) - 1)
        if len(set(waiters)) / others < STRAGGLER_QUORUM:
            continue
        b = beacons.get(r)
        if b is not None and _int_edges(b):
            continue  # R waits on another rank: the cycle/chain is the event
        phase = (b.get("phase") or b.get("op")) if b is not None else None
        store_wait = any(
            isinstance(e[0], str) and e[0] == "store"
            for e in (b.get("blocked_on") or [])
        ) if b is not None else False
        detail = (
            f"rank(s) {sorted(set(waiters))} blocked on rank {r}"
            f" (last phase: {phase})"
        )
        if store_wait:
            detail += "; rank %d itself waits on the store" % r
        events.append(
            _event(
                "straggler",
                None,
                float(len(set(waiters))),
                others * STRAGGLER_QUORUM,
                detail,
                rank=r,
            )
        )

    # --- paused starvation: a QoS pause edge held far past the safety
    # valve while the holder's engine reports itself paused.
    for r, b in beacons.items():
        for edge in b.get("blocked_on") or []:
            try:
                peer, site, age = edge[0], edge[1], edge[2]
            except Exception:  # noqa: BLE001
                continue
            if (
                isinstance(site, str)
                and site.startswith("qos.")
                and isinstance(age, (int, float))
                and age > PAUSED_STARVATION_S
            ):
                events.append(
                    _event(
                        "paused_starvation",
                        None,
                        float(age),
                        PAUSED_STARVATION_S,
                        f"rank {r} paused {age:.1f}s at {site} for {peer}",
                        rank=r,
                    )
                )

    return events


def log_anomalies(events: Iterable[Dict[str, Any]]) -> None:
    """One ``logger.warning`` per anomaly *kind* (first occurrence wins):
    the job log gets a pointer, the timeline CLI has the full list."""
    seen = set()
    for ev in events:
        kind = ev.get("kind")
        if kind in seen:
            continue
        seen.add(kind)
        logger.warning(
            "step-telemetry anomaly [%s] at step %s: %s",
            kind,
            ev.get("step"),
            ev.get("detail"),
        )


def render_timeline(
    series: Iterable[Dict[str, Any]],
    anomalies: Optional[Iterable[Dict[str, Any]]] = None,
) -> List[str]:
    """Per-step trend table with anomaly flags, one string per line —
    shared by the ``timeline`` CLI and the continuous bench artifact."""
    recs = sorted(series, key=lambda r: r.get("step", 0))
    events = list(anomalies) if anomalies is not None else detect_anomalies(recs)
    by_step: Dict[Any, List[str]] = {}
    for ev in events:
        by_step.setdefault(ev.get("step"), []).append(ev.get("kind", "?"))

    lines: List[str] = []
    lines.append(
        "  step  stall_s  drain_s    GB/s      GB  preempt  skew_s  straggler  flags"
    )
    for r in recs:
        step = r.get("step", 0)
        skew = r.get("skew") or {}
        counters = r.get("counters") or {}
        straggler = skew.get("straggler_rank")
        flags = ",".join(by_step.get(step, []))
        lines.append(
            f"{step:6d} {r.get('stall_s', 0.0):8.3f} "
            f"{r.get('drain_wall_s', 0.0):8.3f} "
            f"{r.get('drain_gbps', 0.0):7.3f} "
            f"{((r.get('bytes') or {}).get('written', 0) or 0) / 1e9:7.3f} "
            f"{int(counters.get('preemptions', 0) or 0):8d} "
            f"{skew.get('end_skew_s', 0.0) or 0.0:7.3f} "
            f"{straggler if straggler is not None else '-':>9} "
            f" {flags}"
        )
    if events:
        lines.append(f"anomalies: {len(events)}")
        for ev in events:
            lines.append(
                f"  [{ev.get('kind')}] step {ev.get('step')}: {ev.get('detail')}"
            )
    else:
        lines.append("anomalies: none")
    return lines

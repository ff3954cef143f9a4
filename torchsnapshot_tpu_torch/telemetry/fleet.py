"""Live fleet telemetry bus over the coordinator store.

Every observability surface before this one is per-process: the flight
recorder rings and ``monitor`` dumps are local files, wait loops log
"stalled" without naming who they wait on, and cross-rank views exist only
post-hoc, per committed snapshot (``aggregate.py``). This module is the
live half: each process publishes a rate-limited, schema-versioned status
**beacon** to its own coordinator-store key (``fleet/<rank>``) — current
op + phase, the engine's ``introspect()`` rollup, ``ProgressTracker``
rates/ETA, recorder anomaly flags, and the peer-attributed ``blocked_on``
wait edges the instrumented wait loops report (LinearBarrier arrivals,
bcast elected readers, swarm chunk servers).
``monitor --fleet <host:port>`` renders the per-process table + wait graph
live; ``fleet-health`` runs the fleet detectors (``health.py``) over the
same beacons.

Design constraints, in order:

- **Fail-open end to end.** A beacon publish can never fail, stall-fail, or
  abort an operation: every store op is wrapped, failures count + warn once.
- **Off-mode = one is-None check.** Same module-global pattern as the
  flight recorder (``recorder.py``): when ``TSS_TORCH_FLEET_TELEMETRY``
  resolves off, every feed site loads one global and branches — no
  allocation, no time read (tracemalloc-enforced).
- **Bounded store occupancy.** One key per rank, overwritten in place:
  occupancy is ``world_size`` keys regardless of publish count. Beacons are
  generation-fenced by ``(pid, seq, ts_unix)`` in the payload — readers
  discard stale generations by age — and the key is registered with
  ``Coordinator.defer_delete`` at op end (main thread), so a finished job's
  control-plane server drains back to empty.
- **Sanctioned asymmetry.** Beacon traffic is deliberately NOT a collective:
  publishes are per-rank, unsynchronized, and may happen inside another
  rank's barrier wait (that is the point — the survivor's beacon must stay
  fresh while it waits). The runtime lockstep tracer never fingerprints
  raw store traffic, so the DEBUG_COLLECTIVES sanitizer stays clean by
  construction, and the store operations run under
  ``parallel.store.telemetry_op_scope`` so they count as
  ``telemetry.<op>``, which counts of the coordination plane
  (``store.get_op_counts(include_telemetry=False)``) leave out.

The port's copy of ``torchsnapshot_tpu/telemetry/fleet.py``: the store is
the port's coordinator store (``parallel/store.py``: c10d's or the port's
own TCPStore), ``auto`` resolves on when that coordinator spans several
processes, and a beacon's ``qos`` field is the port's arbiter
(``engine/qos.py``) in the JAX package's schema.

Module-level imports are stdlib-only, like the rest of the telemetry
package; the coordinator/knobs imports are lazy (first use).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

logger = logging.getLogger(__name__)

BEACON_SCHEMA_VERSION = 1

# Store key namespace. One key per rank, overwritten in place — the
# occupancy bound the docs table states and the GC test asserts.
KEY_PREFIX = "fleet"

# A beacon older than max(DEAD_FACTOR * interval, DEAD_FLOOR_S) is stale:
# its publisher is dead, wedged below the publish sites, or idle (the
# detectors distinguish via the last-published ``op`` field).
DEAD_FACTOR = 3.0
DEAD_FLOOR_S = 2.0

# Cap on remembered anomaly kinds / blocked sites so a pathological feed
# can never grow a beacon without bound.
_MAX_ANOMALY_KINDS = 16
_MAX_BLOCKED_SITES = 32

# A "peer" in a wait edge: a rank (int) or a named non-rank resource
# ("store", "class:FOREGROUND").
Peer = Union[int, str]


def beacon_key(rank: int) -> str:
    return f"{KEY_PREFIX}/{rank}"


def stale_after_s(interval_s: float) -> float:
    """Age past which a beacon counts as dead (shared with ``health.py``)."""
    return max(DEAD_FACTOR * float(interval_s), DEAD_FLOOR_S)


def parse_beacon(data: bytes) -> Dict[str, Any]:
    """Decode + validate one beacon; ``ValueError`` on anything this
    library does not understand — readers degrade per rank."""
    try:
        parsed = json.loads(bytes(data).decode("utf-8"))
    except Exception as e:
        raise ValueError(f"unparseable fleet beacon: {e!r}") from e
    if not isinstance(parsed, dict):
        raise ValueError(
            f"fleet beacon is not a JSON object: {type(parsed).__name__}"
        )
    version = parsed.get("schema_version")
    if not isinstance(version, int):
        raise ValueError("fleet beacon has no integer schema_version")
    if version > BEACON_SCHEMA_VERSION:
        raise ValueError(
            f"fleet beacon schema v{version} is newer than this library "
            f"understands (v{BEACON_SCHEMA_VERSION})"
        )
    if not isinstance(parsed.get("rank"), int):
        raise ValueError("fleet beacon missing integer rank")
    return parsed


class FleetBus:
    """One process's beacon publisher + fleet reader.

    Thread-safe: feeds arrive from the main thread (op/phase marks, barrier
    polls), engine event-loop threads (samples, swarm/bcast waits), and the
    async-commit background thread (barrier heartbeats). State lives under
    one short lock; store round trips run outside it. ``gc()`` is the one
    main-thread-only method (it rides ``Coordinator.defer_delete``).
    """

    def __init__(
        self,
        store: Any,
        coordinator: Any,
        rank: int,
        world_size: int,
        interval_s: float,
    ) -> None:
        self._store = store
        self._coord = coordinator
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._seq = 0
        # None, not 0.0, is "never published" — same sentinel rationale as
        # the recorder's rate limiter.
        self._last_publish: Optional[float] = None
        self._op: Optional[str] = None
        self._phase: Optional[str] = None
        self._engine: Optional[Dict[str, Any]] = None
        self._progress: Optional[Any] = None  # ProgressTracker
        self._anomalies: Dict[str, int] = {}
        # site -> {peer: first-blocked monotonic ts}
        self._blocked: Dict[str, Dict[Peer, float]] = {}
        self._gc_registered_seq = -1
        self.publishes = 0
        self.publish_failures = 0
        self._warned = False
        # Short-lived peer-beacon cache so blocked_detail()/peer_phase()
        # inside a hot wait loop cost at most ~1 bulk read per interval.
        self._peer_cache: Optional[Tuple[float, Dict[int, Dict[str, Any]]]] = None

    # ------------------------------------------------------------- feeding

    def note_op(self, op: Optional[str]) -> None:
        """The op this process is running (``None`` = idle). Op boundaries
        force a publish so the fleet's "last word" from a finished process
        is an idle beacon — the dead-beacon detector's liveness fence."""
        with self._lock:
            self._op = op
            if op is None:
                self._phase = None
        self.publish(force=True)

    def note_phase(self, phase: str) -> None:
        with self._lock:
            self._phase = phase
        self.publish()

    def sample_engine(self, engine: Any) -> None:
        try:
            rollup = engine.introspect()
        except Exception:  # noqa: BLE001 - diagnostics must not fail the op
            return
        with self._lock:
            self._engine = rollup
        self.publish()

    def set_progress(self, tracker: Optional[Any]) -> None:
        with self._lock:
            self._progress = tracker

    def note_anomaly(self, kind: str) -> None:
        with self._lock:
            if kind in self._anomalies or len(self._anomalies) < _MAX_ANOMALY_KINDS:
                self._anomalies[kind] = self._anomalies.get(kind, 0) + 1
        self.publish()

    def note_blocked(self, site: str, peers: Iterable[Peer]) -> None:
        """Replace ``site``'s wait-edge set (first-blocked time survives for
        peers already present, so ``age_s`` measures the whole wait)."""
        now = time.monotonic()
        with self._lock:
            if site not in self._blocked and len(self._blocked) >= _MAX_BLOCKED_SITES:
                return
            old = self._blocked.get(site) or {}
            self._blocked[site] = {p: old.get(p, now) for p in peers}
            if not self._blocked[site]:
                self._blocked.pop(site, None)
        self.publish()

    def clear_blocked(self, site: str) -> None:
        with self._lock:
            cleared = self._blocked.pop(site, None) is not None
        if cleared:
            self.publish()

    def blocked_edges(self) -> List[Tuple[Peer, str, float]]:
        """Live ``(peer, site, age_s)`` edges, oldest first."""
        now = time.monotonic()
        with self._lock:
            out = [
                (peer, site, round(now - t0, 3))
                for site, peers in self._blocked.items()
                for peer, t0 in peers.items()
            ]
        out.sort(key=lambda e: -e[2])
        return out

    # ---------------------------------------------------------- publishing

    def payload(self) -> Dict[str, Any]:
        with self._lock:
            self._seq += 1
            progress = self._progress
            beacon: Dict[str, Any] = {
                "schema_version": BEACON_SCHEMA_VERSION,
                "rank": self.rank,
                "world_size": self.world_size,
                "pid": self._pid,
                "seq": self._seq,
                "ts_unix": round(time.time(), 6),
                "interval_s": self.interval_s,
                "op": self._op,
                "phase": self._phase,
                "engine": dict(self._engine) if self._engine else None,
                "anomalies": dict(self._anomalies),
            }
        beacon["blocked_on"] = [
            [peer, site, age] for peer, site, age in self.blocked_edges()
        ]
        if progress is not None:
            try:
                snap = progress.snapshot()
                beacon["progress"] = {
                    "bytes_written": snap["bytes_written"],
                    "bytes_total": snap["bytes_total"],
                    "requests_done": snap["requests_done"],
                    "requests_total": snap["requests_total"],
                    "bytes_per_s_ewma": round(snap["bytes_per_s_ewma"], 3),
                    "eta_s": None
                    if snap["eta_s"] is None
                    else round(snap["eta_s"], 3),
                }
            except Exception:  # noqa: BLE001 - fail-open
                beacon["progress"] = None
        else:
            beacon["progress"] = None
        try:
            from ..engine.qos import get_arbiter

            intro = get_arbiter().introspect()
            beacon["qos"] = {
                "enabled": intro.get("qos_enabled"),
                "demand": intro.get("demand"),
                "preempted": intro.get("preempted_classes"),
            }
        except Exception:  # noqa: BLE001 - fail-open
            beacon["qos"] = None
        return beacon

    def publish(self, force: bool = False) -> bool:
        """Write this process's beacon (rate-limited unless ``force``).
        Fail-open by contract: any store/build failure counts, warns once,
        and returns False — never raises into the feeding op."""
        now = time.monotonic()
        with self._lock:
            last = self._last_publish
            if not force and last is not None and now - last < self.interval_s:
                return False
            self._last_publish = now
        key = beacon_key(self.rank)
        try:
            from ..utils import knobs

            if knobs.get_faults_spec():
                # The `beacon` fault point: a failed, stalled or killed
                # publisher (fail-open, like any publish failure).
                from ..faults import maybe_inject_local

                maybe_inject_local("beacon", key)
            from ..parallel.store import telemetry_op_scope

            with telemetry_op_scope():
                self._store.set(
                    key, json.dumps(self.payload()).encode("utf-8")
                )
            self.publishes += 1
            return True
        except Exception:  # noqa: BLE001 - fail-open by contract
            self.publish_failures += 1
            if not self._warned:
                self._warned = True
                logger.warning(
                    "fleet beacon publish failed (operation unaffected; "
                    "this process's beacon will read as dead)",
                    exc_info=True,
                )
            return False

    # ------------------------------------------------------------- reading

    def read_beacons(
        self, world_size: Optional[int] = None
    ) -> Dict[int, Dict[str, Any]]:
        """Every readable peer beacon, ``{rank: beacon}``. One bulk store
        round trip; unparseable/foreign payloads are skipped per rank."""
        ws = world_size or self.world_size
        return read_beacons(self._store, ws)

    def _cached_beacons(self) -> Dict[int, Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            cached = self._peer_cache
        if cached is not None and now - cached[0] < self.interval_s:
            return cached[1]
        try:
            beacons = self.read_beacons()
        except Exception:  # noqa: BLE001 - fail-open
            beacons = {}
        with self._lock:
            self._peer_cache = (now, beacons)
        return beacons

    def peer_phase(self, rank: int) -> Optional[str]:
        """``rank``'s last-beaconed phase (or op), None when unknown."""
        beacon = self._cached_beacons().get(rank)
        if beacon is None:
            return None
        return beacon.get("phase") or beacon.get("op")

    def blocked_detail(self) -> List[Dict[str, Any]]:
        """The live wait edges with each rank-peer's last-beaconed phase
        attached — what the stall watchdog folds into its warning."""
        out = []
        for peer, site, age in self.blocked_edges():
            entry: Dict[str, Any] = {"peer": peer, "site": site, "age_s": age}
            if isinstance(peer, int):
                entry["peer_phase"] = self.peer_phase(peer)
            out.append(entry)
        return out

    # ----------------------------------------------------------------- GC

    def gc(self) -> None:
        """Register this rank's beacon key for the coordinator's deferred
        GC (deleted once a later full-world barrier proves everyone is past
        it). Main-thread only, like ``defer_delete`` itself; once per
        publish generation so op-end hooks never grow ``_posted``."""
        with self._lock:
            if self._seq == self._gc_registered_seq:
                return
            self._gc_registered_seq = self._seq
        if self._store is not self._coord.store:
            # The raw c10d server's key: one per rank, overwritten in place,
            # gone with the job's store.
            return
        try:
            self._coord.defer_delete(beacon_key(self.rank))
        except Exception:  # noqa: BLE001 - GC is best-effort
            pass


# ---------------------------------------------------------------------------
# Process-wide instance. `_BUS is None` IS the disabled state: every feed
# site loads one module global and branches — no allocation, no time read —
# which the off-mode zero-allocation test asserts (same contract as the
# flight recorder).
# ---------------------------------------------------------------------------

_BUS: Optional[FleetBus] = None
_INITIALIZED = False
_INIT_LOCK = threading.Lock()


def _resolve_enabled(mode: str) -> bool:
    if mode == "0":
        return False
    if mode == "1":
        return True
    # auto: on only when the process's coordinator spans several processes
    # (an installed coordinator or torch.distributed's default group) — a
    # solo process (LocalStore) has no fleet to beacon to.
    try:
        from ..parallel.coordinator import get_coordinator

        return get_coordinator().get_world_size() > 1
    except Exception:  # noqa: BLE001 - availability probe is best-effort
        return False


def _init() -> None:
    global _BUS, _INITIALIZED
    from ..utils import knobs

    with _INIT_LOCK:
        if _INITIALIZED:
            return
        try:
            if _resolve_enabled(knobs.get_fleet_telemetry_mode()):
                from ..parallel.coordinator import get_coordinator

                coord = get_coordinator()
                # On a c10d store, beacons sit under the raw server's
                # ``tss/``, where ``connect(host:port)`` finds them.
                unprefixed = getattr(coord.store, "unprefixed", None)
                _BUS = FleetBus(
                    store=unprefixed() if unprefixed is not None else coord.store,
                    coordinator=coord,
                    rank=coord.get_rank(),
                    world_size=coord.get_world_size(),
                    interval_s=knobs.get_fleet_beacon_s(),
                )
        except Exception:  # noqa: BLE001 - fail-open: no bus, no op impact
            logger.warning(
                "fleet telemetry bus failed to initialize (disabled for "
                "this process)",
                exc_info=True,
            )
            _BUS = None
        _INITIALIZED = True


def get_bus() -> Optional[FleetBus]:
    """The process-wide bus, or None when disabled/unconfigured. Knobs are
    read once, at first use; tests that override them call :func:`reset`."""
    if not _INITIALIZED:
        _init()
    return _BUS


def reset() -> None:
    """Drop the process-wide instance and re-read the knobs at next use
    (test hook; production jobs configure the bus via env at start)."""
    global _BUS, _INITIALIZED
    with _INIT_LOCK:
        _BUS = None
        _INITIALIZED = False


# Feed sites: one module-global load + branch when the bus is off.


def enabled() -> bool:
    """True when a live bus exists — for call sites that must decide
    whether to pay for edge computation (e.g. a barrier's missing-rank
    probe) before feeding it."""
    if not _INITIALIZED:
        _init()
    return _BUS is not None


def note_op(op: Optional[str]) -> None:
    """Mark the op this process is running (``None`` at op end)."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return
        b = get_bus()
        if b is None:
            return
    b.note_op(op)


def note_phase(phase: str) -> None:
    """Feed one PhaseTracker mark (the just-completed phase's name)."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return
        b = get_bus()
        if b is None:
            return
    b.note_phase(phase)


def sample_engine(engine: Any) -> None:
    """Feed one engine introspection rollup (publish is rate-limited)."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return
        b = get_bus()
        if b is None:
            return
    b.sample_engine(engine)


def set_progress(tracker: Optional[Any]) -> None:
    """Register the live ProgressTracker whose rates/ETA beacons carry."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return
        b = get_bus()
        if b is None:
            return
    b.set_progress(tracker)


def note_anomaly(kind: str) -> None:
    """Flag a recorder/health anomaly kind on this process's beacon."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return
        b = get_bus()
        if b is None:
            return
    b.note_anomaly(kind)


def note_blocked(site: str, peers: Iterable[Peer]) -> None:
    """Report who a wait loop is currently waiting on (replaces the
    site's edge set; empty ``peers`` clears it)."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return
        b = get_bus()
        if b is None:
            return
    b.note_blocked(site, peers)


def clear_blocked(site: str) -> None:
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return
        b = get_bus()
        if b is None:
            return
    b.clear_blocked(site)


def heartbeat() -> None:
    """Rate-limited publish from inside a wait loop, so a blocked process's
    beacon stays fresh while it waits."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return
        b = get_bus()
        if b is None:
            return
    b.publish()


def blocked_detail() -> List[Dict[str, Any]]:
    """Current wait edges with peer last-phases ([] when off) — consumed
    by the stall watchdog's warning."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return []
        b = get_bus()
        if b is None:
            return []
    return b.blocked_detail()


def peer_phase(rank: int) -> Optional[str]:
    """``rank``'s last-beaconed phase, None when off/unknown — consumed by
    the barrier-timeout/abort attribution path."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return None
        b = get_bus()
        if b is None:
            return None
    return b.peer_phase(rank)


def gc_beacons() -> None:
    """Op-end hook (main thread): defer-delete this rank's beacon key."""
    b = _BUS
    if b is None:
        if _INITIALIZED:
            return
        b = get_bus()
        if b is None:
            return
    b.gc()


# ---------------------------------------------------------------------------
# Fleet read surface (CLI + detectors): usable with a live bus, a raw
# store handle, or just a host:port address — no bus required.
# ---------------------------------------------------------------------------


def connect(addr: str) -> Any:
    """Client connection to a live fleet's store (``host:port``): the c10d
    TCPStore server of the fleet's ``torch.distributed`` default group,
    whose raw ``tss/fleet/<rank>`` keys hold the beacons."""
    from datetime import timedelta

    import torch.distributed as dist

    from ..parallel.store import C10dStore

    host, _, port = addr.rpartition(":")
    if not host or not port:
        raise ValueError(f"fleet store address must be host:port, got {addr!r}")
    return C10dStore(dist.TCPStore(host, int(port), is_master=False, timeout=timedelta(seconds=30)))


def read_beacons(
    store: Any, world_size: Optional[int] = None, probe: int = 64
) -> Dict[int, Dict[str, Any]]:
    """Every readable beacon, ``{rank: beacon}``, in one bulk round trip.

    With no ``world_size``, probes the first ``probe`` rank keys and trusts
    the beacons' own ``world_size`` field — enough for an operator pointing
    the CLI at an arbitrary live store.
    """
    ws = world_size or probe
    from ..parallel.store import telemetry_op_scope

    with telemetry_op_scope():
        vals = store.try_get_many([beacon_key(r) for r in range(ws)])
    out: Dict[int, Dict[str, Any]] = {}
    for rank, val in enumerate(vals):
        if val is None:
            continue
        try:
            out[rank] = parse_beacon(val)
        except ValueError:
            logger.warning("skipping unparseable fleet beacon for rank %d", rank)
    return out


def fleet_world_size(beacons: Dict[int, Dict[str, Any]]) -> int:
    """The fleet's world size as the beacons report it (falls back to the
    highest rank seen + 1)."""
    return max(
        [b.get("world_size") or 0 for b in beacons.values()]
        + [(max(beacons) + 1) if beacons else 0]
    )

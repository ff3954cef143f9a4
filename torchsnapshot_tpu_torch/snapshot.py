"""``Snapshot``: take, restore, read and verify checkpoints of torch state.

One or many ranks, local filesystem. The on-disk format is the JAX
package's, byte for byte: ``.snapshot_metadata`` (JSON manifest),
``.checksums.<rank>`` (per-object digests of the objects that rank wrote)
and the object layout (``<rank>/<logical path>``, ``replicated/<path>``,
``sharded/<path>.<offsets>``, ``<path>.chunk_<row>``, ``batched/<uuid>``
slabs with ``byte_range``), so a snapshot written by either package
restores through the other.

Ranks: a :class:`~.parallel.coordinator.Coordinator` (``coordinator=``,
else ``torch.distributed``'s default process group, else rank 0 of 1)
names the rank and carries the planning traffic over a store; no tensor
crosses processes. In a take each rank writes its per-rank state under
``<rank>/``, the unique shards of its DTensors, and its share of the
replicated state (balanced by the partitioner); the manifests are
all-gathered, and rank 0 writes ``.snapshot_metadata`` only after every
rank has passed the commit barrier. A failure on any rank surfaces on every
rank, at world size 1 too, as :class:`CheckpointAbortedError` naming the
rank and the phase, and leaves no ``.snapshot_metadata``; an application's
own ``load_state_dict`` error reaches its rank as itself. A restore fills
each rank's DTensors from the saved bytes that overlap its local shards,
whatever the saved world size and placements were.

Steady state: a take's plan is fingerprinted (``take_plan.py``); a
multi-rank take whose every rank holds a plan for its own structure, from
the same earlier take, replays it with constant store traffic per non-zero
rank, and a take at world size 1 or on such a hit reuses its prepared
stagers (``prepare_cache.py``).

Incremental takes (``base=``): an object byte-identical to one of the base
snapshot (size and sha256 or tree root, from the base's sidecars) is
hard-linked from the base instead of written; a compressed take writes
``raw_zlib``/``raw_zstd`` entries (``TSS_TORCH_COMPRESSION``), and restore
decodes whatever each entry records.

Lifecycle: a take with ``job=`` is recorded in its bucket's catalog and,
without ``base=``, builds on the job's latest snapshot (``catalog.py``);
:meth:`Snapshot.gc` is the one deletion path of retention and of the
crash-debris sweep.

Devices: ``take``/``async_take`` stage CUDA tensors through the CUDA path
(D2H lanes, kernels K1 and K2); ``restore`` writes into each live tensor's
own device, and a leaf with no live tensor lands on ``device`` (default
``"cuda"``); ``read_object`` returns tensors on ``device`` (default
``"cuda"``). A CUDA request on a host without CUDA raises.

Telemetry (``telemetry/``): every take, async_take and restore records a
session when ``_telemetry=`` is given, ``TSS_TORCH_TRACE`` is set, or the
per-rank artifact (``.telemetry/rank_<k>.json``, on by default) is
persisted; the span and metric names are the JAX package's. The
diagnostics ``LAST_TAKE_PHASES``, ``LAST_TAKE_CACHE``,
``LAST_SYNC_DRAIN_STATS`` and ``LAST_RESTORE_STATS`` are views of what
the session records: the phase spans and the engine's intervals.

QoS (``engine/qos.py``): ``take``, ``async_take`` and ``restore`` take a
class (``qos="foreground" | "normal" | "background"``); an async take's
drain keeps the class it was planned under, and ``verify``, ``scrub`` and
``gc`` run BACKGROUND engines, which pause their next admission while an
operation of a higher class runs in this process.

Error contracts: restoring a path that was never taken raises
``FileNotFoundError``; a missing path raises ``KeyError``; an app-state
value without ``state_dict``/``load_state_dict`` raises ``TypeError``.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import fnmatch
import hashlib
import json
import logging
import os
import re
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import bcast as bcast_mod
from . import d2h, hashing, prepare_cache, scheduler, telemetry
from . import swarm as swarm_mod
from .batcher import batch_read_requests, batch_write_requests
from .flatten import flatten, inflate
from .hashing import record_content_keys, record_crc
from .io_preparer import (
    cuda_source,
    is_dtensor,
    as_leaves,
    capture_flattened,
    prepare_write,
)
from .io_preparers.array import FRAME_TABLE_SUFFIX, ArrayIOPreparer, LazyHostTarget, PickledArrayConsumer
from .io_preparers.chunked_array import ChunkedArrayIOPreparer
from .io_preparers.object import ObjectIOPreparer
from .io_preparers.sharded_array import (
    ShardedArrayIOPreparer,
    alloc_target_shards,
    assemble_dtensor,
    dtensor_leaf,
    overlap,
)
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO
from .manifest import (
    SNAPSHOT_METADATA_FNAME,
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    Manifest,
    ObjectEntry,
    PrimitiveEntry,
    Shard,
    ShardedArrayEntry,
    SnapshotMetadata,
    entry_from_dict,
    entry_to_dict,
    get_manifest_for_rank,
    is_container_entry,
)
from .parallel.coordinator import Coordinator, get_coordinator
from .parallel.store import BarrierError, LinearBarrier
from .partitioner import (
    CodecDivergenceError,
    consolidate_replicated_entries,
    partition_write_reqs_with_assignment,
    shard_coverage_problem,
)
from .rng_state import RNGState
from .engine import Node, run_graph
from .engine import qos as engine_qos
from .scheduler import (
    CHECKSUM_FILE_PREFIX,
    PendingIOWork,
    sync_execute_read_reqs,
    sync_execute_write_reqs,
)
from .serialization import (
    BYTE_VIEW_DTYPES,
    Serializer,
    array_nbytes,
    codec_library_versions,
    is_raw_family,
    numpy_dtype_to_string,
    string_to_dtype,
)
from .stateful import AppState
from .storage_plugin import url_to_storage_plugin
from .storage_plugins import memory as memory_store
from .storage_plugins.cache import find_read_cache
from .take_plan import (
    CachedPlan,
    TakePlan,
    compute_fingerprint,
    gather_manifest_delta,
    preflight,
    probe_plan,
    store_plan,
)
from .utils import knobs
from .version import __version__

logger = logging.getLogger(__name__)

# Wall seconds of the planning phases of this process's last take or
# async_take (the async stall is their sum) and of the stage.prepare.*
# sub-spans inside them: a view of the take's ``take.phase`` spans.
LAST_TAKE_PHASES: Dict[str, float] = {}
# Whether this process's last take hit the plan cache and the
# prepared-take cache: a view of the ``preflight`` phase span's
# ``plan_cache_hit`` and of the ``stage.prepare.cache_hit`` span.
LAST_TAKE_CACHE: Dict[str, bool] = {}
# Stream stats of this process's last sync take, over its whole pipeline
# (the staging before the capture point and the drain; keys as
# PendingSnapshot.drain_stats, ``hash_workers`` included): derived from the
# engine's intervals, which are the trace's scheduler.stage and
# scheduler.io spans.
LAST_SYNC_DRAIN_STATS: Dict[str, float] = {}
# This process's last restore: wall seconds, the read pipelines' totals
# (bytes_read, read_wall_s, requests), the broadcast and swarm records
# (``bcast.LAST_RESTORE_BCAST``, ``swarm.LAST_RESTORE_SWARM``) and the
# origin/peer/cache byte attribution (``attribution``).
LAST_RESTORE_STATS: Dict[str, Any] = {}


def _begin_telemetry(
    explicit: Optional[telemetry.Telemetry],
) -> Tuple[Optional[telemetry.Telemetry], Optional[telemetry.Telemetry]]:
    """A session for one operation: ``_telemetry=`` wins, else one is made
    when a trace is asked for or artifacts are on (the artifact needs the
    metrics). Only a traced one runs the interpreter-lock probe. Returns
    (session, the previously active session)."""
    tm = explicit
    if tm is None and (knobs.get_trace_path() or knobs.is_telemetry_artifacts_enabled()):
        tm = telemetry.Telemetry(probe_host=bool(knobs.get_trace_path()))
    prev = telemetry.activate(tm) if tm is not None else None
    return tm, prev


def _finish_telemetry(
    tm: Optional[telemetry.Telemetry], prev: Optional[telemetry.Telemetry], rank: int
) -> None:
    """Close a session: reactivate the previous one, publish it as
    ``Snapshot.last_telemetry``, and write the trace when
    ``TSS_TORCH_TRACE`` is set (rank N appends ``.rankN``). A failed trace
    write is a warning, never a failed operation."""
    if tm is None:
        return
    tm.rank = rank
    telemetry.deactivate(tm, prev)
    if tm.buffer.dropped:
        tm.metrics.counter("telemetry.spans_dropped").add(tm.buffer.dropped)
    Snapshot.last_telemetry = tm
    trace_path = knobs.get_trace_path()
    if trace_path:
        path = trace_path if rank == 0 else f"{trace_path}.rank{rank}"
        try:
            rec = telemetry.recorder.get_recorder()
            samples = rec.snapshot() if rec is not None else None
            telemetry.write_chrome_trace(tm, path, recorder_samples=samples)
        except Exception:  # noqa: BLE001 - diagnostics must not fail the op
            logger.warning("failed to write telemetry trace to %s", path, exc_info=True)


_artifact_build_warned = False


def _persist_op_artifact(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    rank: int,
    world_size: int,
    op: str,
    tm: Optional[telemetry.Telemetry],
    phase_spans: Any = None,
    io_summary: Optional[Dict[str, Any]] = None,
) -> None:
    """Write this rank's artifact into the snapshot, fail-open: after the
    drain and before the commit barrier (a restore: before its final
    barrier), so a committed snapshot carries every rank's."""
    global _artifact_build_warned
    if not knobs.is_telemetry_artifacts_enabled():
        return
    from .storage_plugin import write_telemetry_artifact

    try:
        payload = telemetry.artifact.dumps_artifact(
            telemetry.artifact.build_artifact(
                op=op, rank=rank, world_size=world_size, tm=tm, phase_spans=phase_spans, io_summary=io_summary
            )
        )
    except Exception:  # noqa: BLE001 - diagnostics must not fail the op
        level = logging.DEBUG if _artifact_build_warned else logging.WARNING
        _artifact_build_warned = True
        logger.log(level, "failed to build the telemetry artifact of %s (snapshot unaffected)", op, exc_info=True)
        return
    write_telemetry_artifact(storage, event_loop, telemetry.artifact.artifact_path(rank, op), payload)


def _add_span(name: str, cat: str, t0: float, **attrs: Any) -> None:
    """A span from ``t0`` to now, when a session is active."""
    tm = telemetry.get_active()
    if tm is not None:
        tm.add_span(name, cat, t0, time.monotonic() - t0, attrs)


@contextlib.contextmanager
def _qos_scope(qos: Any):
    """Bind an operation's QoS class: the ambient priority scope (every
    pipeline and swarm or broadcast fetch built inside inherits it) and a
    whole-operation demand registration, so a FOREGROUND restore keeps
    lower-class engines paused across its planning and H2D gaps too.
    ``qos``: ``"foreground" | "normal" | "background"`` or an
    ``engine.Priority``; None leaves the ambient class."""
    priority = engine_qos.parse_priority(qos)
    if priority is None:
        yield
        return
    with engine_qos.priority_scope(priority), engine_qos.demand_scope(priority):
        yield


@contextlib.contextmanager
def _barrier_stall_guard(rank: int):
    """With ``TSS_TORCH_STALL_WARN_S`` set, a watchdog thread around a
    blocking barrier hold: a tracker that never moves fires once, and its
    warning names the peers the fleet beacons say this rank waits on."""
    warn_s = knobs.get_stall_warn_s()
    if warn_s <= 0:
        yield
        return
    watchdog = telemetry.StallWatchdog(telemetry.ProgressTracker(), warn_s, rank=rank)
    thread, stop = telemetry.watchdog_thread(watchdog)
    try:
        yield
    finally:
        stop.set()
        thread.join(timeout=5.0)


# A write object under this many staged bytes counts as small in
# ``take.small_write_objects``.
_SMALL_WRITE_OBJECT_BYTES = 1 << 20


def _count_take_objects(n_leaves: int, write_reqs: List[Any]) -> None:
    """The take's ``take.leaves`` (every leaf flattened, tensors and
    primitives such as an optimizer's param-group entries alike),
    ``take.write_objects`` (this rank's write requests after batching) and
    ``take.small_write_objects`` (those staging under 1 MiB), when a
    session is active."""
    if telemetry.get_active() is None:
        return
    small = sum(r.buffer_stager.get_staging_cost_bytes() < _SMALL_WRITE_OBJECT_BYTES for r in write_reqs)
    telemetry.counter_add("take.leaves", n_leaves)
    telemetry.counter_add("take.write_objects", len(write_reqs))
    telemetry.counter_add("take.small_write_objects", small)


def _take_views(tracker: telemetry.PhaseTracker) -> None:
    """``LAST_TAKE_PHASES`` and ``LAST_TAKE_CACHE`` from the take's phase
    spans."""
    LAST_TAKE_PHASES.clear()
    LAST_TAKE_PHASES.update(tracker.durations)
    names = {sp.name for sp in tracker.spans}
    LAST_TAKE_CACHE.clear()
    LAST_TAKE_CACHE.update(
        plan_cache_hit=any(sp.attrs.get("plan_cache_hit") for sp in tracker.spans if sp.name == "preflight"),
        prepared_cache_hit="stage.prepare.cache_hit" in names,
    )


class _RestoreModes:
    """A restore's collective transports, decided once for every stateful
    and every rank: the coordinator (None at world 1) and whether the
    broadcast and the swarm are on."""

    __slots__ = ("coord", "bcast", "swarm")

    def __init__(self, coord: Optional[Coordinator], bcast: bool, swarm: bool) -> None:
        self.coord = coord
        self.bcast = bcast
        self.swarm = swarm


def _restore_attribution(
    bcast_rec: Dict[str, Any],
    swarm_rec: Dict[str, Any],
    read_totals: Dict[str, float],
    storage: StoragePlugin,
) -> Dict[str, int]:
    """Where this rank's restore bytes came from: ``origin_bytes`` (the
    broadcast's fetches, the swarm's chunk reads, and the read pipelines'
    fetches less what the read cache served), ``peer_bytes`` (broadcast
    payloads and swarm chunks received) and ``cache_bytes``."""
    cache = find_read_cache(storage)
    cache_hit_bytes = int(cache.stats.get("hit_bytes", 0)) if cache is not None else 0
    swarm_cache = int(swarm_rec.get("cache_bytes", 0))
    pipeline_cache = max(0, cache_hit_bytes - swarm_cache)
    pipeline_read = int(read_totals.get("bytes_read", 0))
    return {
        "origin_bytes": int(bcast_rec.get("origin_bytes", 0))
        + int(swarm_rec.get("origin_bytes", 0))
        + max(0, pipeline_read - pipeline_cache),
        "peer_bytes": int(bcast_rec.get("recv_bytes", 0)) + int(swarm_rec.get("peer_bytes", 0)),
        "cache_bytes": swarm_cache + pipeline_cache,
    }


class CheckpointAbortedError(RuntimeError):
    """A take or restore failed on some rank and was aborted on every rank.

    ``rank``: the rank whose failure aborted the operation (None when a
    peer died without reporting); ``phase``: what it was doing (takes:
    ``plan``, ``write``, ``commit``; restores: ``restore.plan``,
    ``restore.read``, ``restore.barrier``); ``detail``: the error's text.
    An aborted take leaves no ``.snapshot_metadata``."""

    def __init__(self, path: str, rank: Optional[int], phase: Optional[str], detail: str) -> None:
        self.path = path
        self.rank = rank
        self.phase = phase
        self.detail = detail
        who = f"rank {rank}" if rank is not None else "a peer rank"
        doing = f" during {phase}" if phase else ""
        super().__init__(f"checkpoint to {path} aborted: {who} failed{doing}: {detail}")


def _abort_exception(
    path: str,
    barrier: Optional[LinearBarrier],
    rank: int,
    phase: str,
    e: BaseException,
) -> BaseException:
    """The exception a failed take or restore raises: the failure is
    reported through ``barrier`` (which unblocks and fails every peer; None
    at world size 1), a peer's earlier report names that peer, and the
    result is a :class:`CheckpointAbortedError`. A KeyboardInterrupt or
    SystemExit is reported but comes back as itself."""
    telemetry.counter_add("snapshot.abort")
    if isinstance(e, CheckpointAbortedError):
        return e
    if isinstance(e, BarrierError):
        return CheckpointAbortedError(path, e.rank, e.phase or phase, e.detail)
    if barrier is not None:
        try:
            barrier.report_error(e, phase=phase)
        except Exception:  # noqa: BLE001 - reporting is best-effort
            pass
    if not isinstance(e, Exception):
        return e
    if isinstance(e, TimeoutError):
        missing = list(getattr(e, "missing_ranks", None) or [])
        culprit = missing[0] if missing else None
        detail = repr(e)
        if culprit is not None:
            # The fleet beacons (when on) say what the missing rank was doing.
            with contextlib.suppress(Exception):
                last_phase = telemetry.fleet.peer_phase(culprit)
                if last_phase:
                    detail = f"{detail} (last beaconed phase: {last_phase})"
        return CheckpointAbortedError(path, culprit, phase, detail)
    return CheckpointAbortedError(path, rank, phase, repr(e))


def _first_take_phase(coord: Coordinator) -> str:
    """The phase a take's failure names until its plan is made: "write" at
    world size 1, as the JAX package names every failure of a take before
    its commit; "plan" with several ranks, where the plan's gather tells
    every rank of a planning failure."""
    return "write" if coord.get_world_size() == 1 else "plan"


def _load_state_dict(stateful: Any, state: Any) -> None:
    """``stateful.load_state_dict(state)``; an error it raises is the
    application's own, not a checkpoint fault: it is marked so that
    ``restore`` re-raises it as itself."""
    try:
        stateful.load_state_dict(state)
    except Exception as e:
        with contextlib.suppress(Exception):
            e._tss_app_hook_error = True  # type: ignore[attr-defined]
        raise


class Snapshot:
    """A reference to a persisted snapshot at ``path``::

        Snapshot.take("/ckpt/step_1000", {"model": model, "optim": optim})
        Snapshot("/ckpt/step_1000").restore({"model": model, "optim": optim})

    Every rank of a job calls each operation with the same arguments and
    in the same order."""

    # Per-process sequence numbers of multi-rank operations: every rank
    # issues the same operations in the same order, so the barrier ids
    # derived from them agree across ranks.
    _op_seq = 0

    # The telemetry session of this process's last take, async_take (once
    # committed) or restore that had one.
    last_telemetry: Optional[telemetry.Telemetry] = None

    def __init__(self, path: str, coordinator: Optional[Coordinator] = None) -> None:
        self.path = path
        self._coordinator = coordinator
        self._metadata: Optional[SnapshotMetadata] = None

    @classmethod
    def _barrier(cls, coord: Coordinator, kind: str, path: str) -> Optional[LinearBarrier]:
        if coord.get_world_size() == 1:
            return None
        cls._op_seq += 1
        return LinearBarrier(
            coord.store, f"{kind}/{cls._op_seq}/{path}", coord.get_rank(), coord.get_world_size()
        )

    # ------------------------------------------------------------------ take
    @classmethod
    def take(
        cls,
        path: str,
        app_state: AppState,
        coordinator: Optional[Coordinator] = None,
        replicated: Optional[List[str]] = None,
        base: Optional[str] = None,
        job: Optional[str] = None,
        step: Optional[int] = None,
        max_chain_len: Optional[int] = None,
        qos: Any = None,
        _telemetry: Optional[telemetry.Telemetry] = None,
    ) -> "Snapshot":
        """Write ``app_state`` to ``path`` and return when it is committed.
        ``replicated``: globs of logical paths whose plain tensors hold the
        same value on every rank (DDP state); they are written once.
        ``base``: an earlier snapshot to take incrementally against: each
        object byte-identical to one of the base's (size and sha256 or
        tree root from its sidecars) is hard-linked instead of rewritten,
        and any failure falls back to the write. The links share inodes,
        so the base may be deleted later. Near-free checkpoints when most
        state is frozen (partial fine-tunes, embedding-heavy models).

        ``job``: record the committed snapshot in its bucket's catalog
        (``catalog.py``: ``<parent>/.catalog/``, with ``step``, the base,
        the chain length and the bytes written and deduped) and, without an
        explicit ``base``, take the latest committed same-job snapshot as
        the base, unless its chain is already ``max_chain_len`` deltas deep
        (default ``TSS_TORCH_MAX_CHAIN_LEN``, 16): the take is then full.
        ``step`` defaults to the trailing digits of the snapshot's name.
        Rank 0 selects the base in the preflight round, so every rank uses
        the same one. With ``TSS_TORCH_CATALOG=0`` a ``job=`` take is a
        plain full take that records nothing.

        ``qos``: the take's QoS class (``"foreground"``, ``"normal"``,
        ``"background"``; default the ambient class, NORMAL outside any
        scope). A ``"background"`` take's pipeline yields its next
        admission (budget, pool slots, stream chunks) to any operation of a
        higher class in this process.

        ``_telemetry``: a :class:`telemetry.Telemetry` session to record the
        take's spans and metrics into; the session is also published as
        ``Snapshot.last_telemetry``."""
        with _qos_scope(qos):
            _validate_app_state(app_state)
            coord = get_coordinator(coordinator)
            rank = coord.get_rank()
            base = cls._maybe_auto_base(base, job, max_chain_len)
            tm, tm_prev = _begin_telemetry(_telemetry)
            telemetry.fleet.note_op("take")
            try:
                plan = cls._plan_take(path, app_state, coord, replicated or [], base)
                path = plan.path
                barrier = cls._barrier(coord, "commit", path)
                event_loop = asyncio.new_event_loop()
                storage = url_to_storage_plugin(path)
                phase = [_first_take_phase(coord)]
                try:
                    pending, metadata = cls._take_impl(plan, coord, storage, event_loop, False, phase)
                    pending.sync_complete(event_loop)
                    LAST_SYNC_DRAIN_STATS.clear()
                    # The whole pipeline: a sync take stages everything
                    # before its drain loop runs.
                    LAST_SYNC_DRAIN_STATS.update(pending.pipeline_stats)
                    _persist_op_artifact(
                        storage, event_loop, rank, coord.get_world_size(), "take", tm,
                        plan.phase_tracker.spans, pending.telemetry_io_summary(),
                    )
                    phase[0] = "commit"
                    catalog_info = (job, step, plan.base, _chain_len_for(plan)) if job is not None else None
                    with telemetry.span("take.commit", cat="take"), _barrier_stall_guard(rank):
                        _commit(barrier, rank, metadata, storage, event_loop, path, catalog_info)
                    if barrier is not None:
                        coord.note_external_barrier()
                    telemetry.fleet.gc_beacons()
                    if catalog_info is not None:
                        _note_chain_commit(path, catalog_info)
                except BaseException as e:
                    aborted = _abort_exception(path, barrier, rank, phase[0], e)
                    if aborted is e:
                        raise
                    raise aborted from e
                finally:
                    prepare_cache.release(plan.prepared_entry)
                    storage.sync_close(event_loop)
                    event_loop.close()
            finally:
                # The op's last beacon is an idle one.
                telemetry.fleet.note_op(None)
                _finish_telemetry(tm, tm_prev, rank)
            snapshot = cls(path, coordinator)
            snapshot._metadata = metadata
            return snapshot

    @classmethod
    def async_take(
        cls,
        path: str,
        app_state: AppState,
        coordinator: Optional[Coordinator] = None,
        replicated: Optional[List[str]] = None,
        base: Optional[str] = None,
        job: Optional[str] = None,
        step: Optional[int] = None,
        max_chain_len: Optional[int] = None,
        qos: Any = None,
        _telemetry: Optional[telemetry.Telemetry] = None,
    ) -> "PendingSnapshot":
        """Return once the state is captured: CUDA tensors and the local
        shards of DTensors forked on the card (K2), CPU tensors and objects
        copied into private buffers. The caller may then mutate every
        tensor in place; the transfer, the writes and the commit run on a
        background thread (for ``base=``, the base's digests load there
        too). ``job``, ``step``, ``max_chain_len``: the catalog, as in
        :meth:`take`; the background commit appends the record after the
        metadata and before the commit barrier releases.

        ``qos``: as in :meth:`take`. The write pipeline keeps the class it
        was planned under, so ``qos="background"`` classes the background
        drain itself: an operation of a higher class (a
        ``qos="foreground"`` restore) arriving mid-drain takes the drain's
        next admission.

        ``_telemetry``: as in :meth:`take`; the session stays active through
        the background drain and closes (the trace written) at the commit,
        so the drain's spans land in the same trace as the stall's
        phases."""
        with _qos_scope(qos):
            _validate_app_state(app_state)
            coord = get_coordinator(coordinator)
            rank = coord.get_rank()
            base = cls._maybe_auto_base(base, job, max_chain_len)
            tm, tm_prev = _begin_telemetry(_telemetry)
            telemetry.fleet.note_op("async_take")
            try:
                plan = cls._plan_take(path, app_state, coord, replicated or [], base)
                path = plan.path
                barrier = cls._barrier(coord, "async_commit", path)
                event_loop = asyncio.new_event_loop()
                storage = url_to_storage_plugin(path)
                phase = [_first_take_phase(coord)]
                try:
                    pending, metadata = cls._take_impl(plan, coord, storage, event_loop, True, phase)
                except BaseException as e:
                    prepare_cache.release(plan.prepared_entry)
                    storage.sync_close(event_loop)
                    event_loop.close()
                    if barrier is None:
                        telemetry.counter_add("snapshot.abort")
                        raise
                    # Peers may already be draining: fail their commit too.
                    aborted = _abort_exception(path, barrier, rank, phase[0], e)
                    if aborted is e:
                        raise
                    raise aborted from e
            except BaseException:
                telemetry.fleet.note_op(None)
                _finish_telemetry(tm, tm_prev, rank)
                raise
            return PendingSnapshot(
                path, pending, metadata, storage, event_loop, coord, barrier, plan.prepared_entry,
                catalog_info=(job, step, plan.base, _chain_len_for(plan)) if job is not None else None,
                tm=tm,
                tm_prev=tm_prev,
                phase_spans=plan.phase_tracker.spans,
            )

    @classmethod
    def _maybe_auto_base(
        cls, base: Optional[str], job: Optional[str], max_chain_len: Optional[int]
    ) -> Optional[str]:
        """The catalog's auto-base sentinel for a ``job=`` take without an
        explicit ``base=``, resolved on rank 0 in the preflight round
        (``catalog.resolve_auto_base``). An explicit base always wins; with
        the catalog off the take is a plain full take."""
        if job is None or base is not None or not knobs.is_catalog_enabled():
            return base
        from . import catalog as catalog_mod

        return catalog_mod.auto_base_token(
            job, max_chain_len if max_chain_len is not None else knobs.get_max_chain_len()
        )

    @classmethod
    def _plan_take(
        cls,
        path: str,
        app_state: AppState,
        coord: Coordinator,
        replicated: List[str],
        base: Optional[str],
    ) -> TakePlan:
        """Flatten this rank's state, fingerprint its structure and run the
        preflight round that canonicalises path, base and globs and decides
        the plan-cache hit (``take_plan.py``). At world size > 1 a failure
        here is kept for the collective report; the rank still takes part
        in the preflight (as a miss)."""
        world_size = coord.get_world_size()
        tracker = telemetry.PhaseTracker(cat="take.phase")
        phase = tracker.mark
        app_state = dict(app_state)
        # RNG invariant: capture generator state before anything can
        # advance it; reinstate it once the state is captured.
        rng_states = {
            k: (s, s.state_dict()) for k, s in app_state.items() if isinstance(s, RNGState)
        }
        manifest: Manifest = {}
        flattened: Dict[str, Any] = {}
        fingerprint = ""
        cached: Optional[CachedPlan] = None
        failure: Optional[Exception] = None
        try:
            for key in sorted(app_state):
                sd = rng_states[key][1] if key in rng_states else app_state[key].state_dict()
                m, f = flatten(sd, prefix=key)
                manifest.update(m)
                flattened.update(f)
            flattened = as_leaves(flattened)
            phase("flatten")
            plan_cache_on = world_size > 1 and knobs.is_plan_cache_enabled()
            if plan_cache_on or knobs.is_prepared_cache_enabled():
                fingerprint = compute_fingerprint(flattened, world_size, replicated)
                cached = probe_plan(coord, fingerprint) if plan_cache_on else None
            phase("fingerprint")
        except Exception as e:
            if world_size == 1:
                raise
            failure, cached = e, None
        # SPMD take counter: its value certifies "stored by take #N".
        coord._take_seq = getattr(coord, "_take_seq", 0) + 1  # type: ignore[attr-defined]
        keys_sig = hashlib.sha1("\x00".join(sorted(app_state)).encode()).hexdigest()[:12]
        pf = preflight(
            coord, path, base, replicated, cached.token if cached is not None else None, keys_sig
        )
        phase("preflight", plan_cache_hit=pf.hit)
        return TakePlan(
            path=pf.path,
            base=pf.base,
            base_chain_len=pf.base_chain_len,
            replicated_globs=pf.replicated_globs,
            flattened=flattened,
            manifest=manifest,
            rng_states=rng_states,
            fingerprint=fingerprint,
            cache_hit=pf.hit,
            cached=cached if pf.hit else None,
            failure=failure,
            phase_tracker=tracker,
        )

    @classmethod
    def _take_impl(
        cls,
        plan: TakePlan,
        coord: Coordinator,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        is_async: bool,
        phase_out: List[str],
    ) -> Tuple[PendingIOWork, Optional[SnapshotMetadata]]:
        """Prepare the take and run its pipeline to the capture point;
        ``phase_out[0]`` becomes "write" once the plan is made. The
        metadata is None on a non-zero rank of a plan-cache hit (only rank
        0 gathers the manifest then)."""
        rank, world_size = coord.get_rank(), coord.get_world_size()
        path = plan.path
        # Continues the planning phases: the gap since the last mark
        # (plugin and event-loop construction) lands in the next phase.
        tracker = plan.phase_tracker
        phase = tracker.mark
        # stage.prepare.<bucket> sub-spans of the prepare phase.
        prepare_timings: Dict[str, float] = {}

        manifest: Manifest = dict(plan.manifest)
        failure = plan.failure
        prep_key = None
        prepared = None
        leaf_index: Optional[Dict[str, List[Any]]] = None
        write_reqs: List[Any] = []
        assignment: Dict[str, int] = {}
        codec_versions = None

        def partition_and_batch(cached_assignment: Optional[Dict[str, int]]) -> None:
            """Partition (replaying ``cached_assignment`` when given: no
            collective), batch, and cache the prepared take."""
            nonlocal write_reqs, assignment
            write_reqs, assignment = partition_write_reqs_with_assignment(
                manifest, write_reqs, coord, cached_assignment
            )
            if knobs.is_batching_enabled():
                write_reqs = batch_write_requests(list(manifest.values()), write_reqs)
            if prep_key is not None:
                t_store = time.monotonic()
                entry = prepare_cache.PreparedTake(
                    key=prep_key,
                    leaf_kinds={
                        p: prepare_cache.leaf_signature(v, world_size, p in captured)
                        for p, v in flattened.items()
                    },
                    leaf_index=leaf_index or {},
                    local_manifest=local_manifest,
                    write_reqs=write_reqs,
                    assignment=assignment,
                )
                prepare_cache.store(coord, prep_key, entry)
                plan.prepared_entry = entry
                prepare_timings["cache_miss"] = time.monotonic() - t_store

        try:
            if failure is not None:
                raise failure
            if knobs.get_compression() != "none":
                codec_versions = codec_library_versions()
            replicated_paths = {
                p for p in plan.flattened if any(fnmatch.fnmatch(p, g) for g in plan.replicated_globs)
            }
            if is_async:
                t_capture = time.monotonic()
                flattened, captured, ready = capture_flattened(plan.flattened)
                prepare_timings["d2h_hint"] = time.monotonic() - t_capture
            else:
                flattened, captured = plan.flattened, set()
                sources = [cuda_source(v) for v in flattened.values()]
                devices = {t.device for t in sources if t is not None}
                ready = {dev: d2h.ready_event(dev) for dev in devices}
            phase("capture")
            # The prepared-take cache engages only where its miss path has
            # no collective: world size 1, or a certified plan-cache hit
            # (whose replayed assignment makes the partition local). Never
            # with base=: dedup is a function of the bytes, not the
            # structure, and slab paths must stay fresh per take.
            if (
                plan.fingerprint
                and plan.base is None
                and knobs.is_prepared_cache_enabled()
                and (world_size == 1 or plan.cache_hit)
            ):
                prep_key = (plan.fingerprint, type(storage).__name__, is_async)
                prepared = prepare_cache.acquire(coord, prep_key)
                plan.prepared_entry = prepared
            if prepared is not None:
                t_hit = time.monotonic()
                try:
                    local_manifest, write_reqs, assignment = prepared.rebind(
                        flattened, world_size, captured, ready
                    )
                    prepare_timings["cache_hit"] = time.monotonic() - t_hit
                except prepare_cache.RebindMismatch:
                    logger.warning("prepared-take rebind mismatch for %s; re-preparing", path, exc_info=True)
                    prepare_cache.release(prepared)
                    prepare_cache.invalidate(coord, prep_key)
                    plan.prepared_entry = prepared = None
            if prepared is None:
                leaf_index = {} if prep_key is not None else None
                t_prep = time.monotonic()
                local_manifest, write_reqs = prepare_write(
                    flattened, rank, world_size, replicated_paths, is_async, ready, captured, leaf_index
                )
                prepare_timings["stager_construction"] = time.monotonic() - t_prep
            manifest.update(local_manifest)
            if plan.cache_hit and prepared is None:
                partition_and_batch(plan.cached.assignment)
            phase("prepare")
        except Exception as e:
            if world_size == 1:
                raise
            failure = e
        if plan.cache_hit:
            status = None if failure is None else repr(failure)
            global_manifest, outcome = gather_manifest_delta(manifest, coord, plan.cached, status)
            if outcome is not None:
                raise CheckpointAbortedError(path, outcome[0], "plan", outcome[1]) from (
                    failure if failure is not None else RuntimeError(outcome[1])
                )
        else:
            if world_size > 1:
                # Every rank learns of a planning failure anywhere before
                # any rank waits on the failed one's manifest.
                statuses = coord.all_gather_object(None if failure is None else repr(failure))
                failed = [r for r, st in enumerate(statuses) if st is not None]
                if failed:
                    detail = statuses[failed[0]]
                    raise CheckpointAbortedError(path, failed[0], "plan", detail) from (
                        failure if failure is not None else RuntimeError(detail)
                    )
            if prepared is None:
                try:
                    partition_and_batch(None)
                except CodecDivergenceError as e:
                    if rank in e.ranks:
                        raise
                    raise CheckpointAbortedError(path, e.ranks[0], "plan", str(e)) from None
            global_manifest, local_dicts, gathered_dicts = _gather_manifest(manifest, coord)
            if world_size > 1 and knobs.is_plan_cache_enabled():
                store_plan(
                    coord,
                    plan.fingerprint,
                    CachedPlan(
                        token=coord._take_seq,  # type: ignore[attr-defined]
                        assignment=assignment,
                        local_entry_dicts=local_dicts,
                        gathered_entry_dicts=gathered_dicts if rank == 0 else None,
                    ),
                )
        metadata = None
        if global_manifest is not None:
            metadata = SnapshotMetadata(
                version=__version__,
                world_size=world_size,
                manifest=global_manifest,
                codec_versions=codec_versions,
            )
        # A plan-cache hit skips the hostname gather: the take that stored
        # the plan derived (and cached) the local world size.
        memory_budget = scheduler.get_process_memory_budget_bytes(
            None if plan.cache_hit else coord, writes_to=storage
        )
        _count_take_objects(len(plan.flattened), write_reqs)
        phase("plan")
        phase_out[0] = "write"
        base = plan.base
        if base and not (knobs.is_checksums_enabled() and knobs.is_dedup_digests_enabled(has_base=True)):
            logger.warning(
                "base=%s ignored: incremental dedup needs checksums and dedup "
                "digests (TSS_TORCH_CHECKSUMS or TSS_TORCH_DEDUP_DIGESTS is "
                "off); taking a full snapshot",
                base,
            )
            base = None
        base_loader = None
        if base:
            # Resolved on the pipeline (an async take's background drain),
            # so reading the base never lengthens the stall.
            def base_loader(base=base):
                try:
                    return cls._load_base_digests(base)
                except Exception:  # noqa: BLE001 - never abort a take over its base
                    logger.warning("base=%s digest load failed; taking a full snapshot", base, exc_info=True)
                    return None

        def eager_d2h(pipeline: Any) -> None:
            # After partition: only the requests this rank writes. The
            # stall only submits; the lanes allocate and copy.
            if is_async and knobs.is_async_eager_d2h_enabled():
                t_hint = time.monotonic()
                pipeline.start_d2h_hints()
                prepare_timings["d2h_hint"] = prepare_timings.get("d2h_hint", 0.0) + time.monotonic() - t_hint
            phase("d2h_hint")

        # Where each pipeline learns which case it is: a take whose caller
        # waits for the commit hashes on the cores the caller leaves idle;
        # an async take's drain races the caller's steps, so it keeps the
        # staging width. The local world size is the one the budget above
        # derived.
        hash_workers = knobs.get_hash_workers(caller_waits=not is_async)
        pending = sync_execute_write_reqs(
            write_reqs, storage, memory_budget, rank, event_loop, base_loader, on_built=eager_d2h,
            hash_workers=hash_workers,
        )
        phase("stage_until_capture_point")
        # Out-of-band sub-spans: they decompose the capture, prepare and
        # d2h_hint phases without moving the phase boundaries.
        prepare_timings.setdefault("d2h_hint", 0.0)
        for bucket, dur in sorted(prepare_timings.items()):
            tracker.note(f"stage.prepare.{bucket}", dur)
        for stateful, state in plan.rng_states.values():
            stateful.load_state_dict(state)
        phase("rng_restore")
        _take_views(tracker)
        return pending, metadata

    @classmethod
    def _load_base_digests(cls, base: str) -> Optional[Tuple[str, Dict[str, Any]]]:
        """``(base root, {storage path: sidecar record})`` of the base's
        objects that carry a content identity, or None when the base
        cannot serve (uncommitted, unusable, no sha256 recorded); the take
        then writes everything."""
        root = base[len("fs://") :] if base.startswith("fs://") else base
        if "://" not in root:
            root = os.path.abspath(root)
        event_loop = asyncio.new_event_loop()
        try:
            try:
                storage = url_to_storage_plugin(base)
            except Exception:  # noqa: BLE001 - an unusable base never aborts the take
                logger.warning("base=%s is unusable; taking a full snapshot", base, exc_info=True)
                return None
            try:
                try:
                    metadata = cls(base)._read_metadata(storage, event_loop)
                except Exception:  # noqa: BLE001
                    logger.warning("base=%s has no committed metadata; taking a full snapshot", base)
                    return None
                codec = knobs.get_compression()
                if codec != "none" and metadata.codec_versions:
                    # Compressed bytes are stable only within one library
                    # version; a change makes dedup miss silently.
                    recorded = metadata.codec_versions.get(codec)
                    current = codec_library_versions().get(codec)
                    if recorded is not None and recorded != current:
                        logger.warning(
                            "base=%s compressed its objects with %s %s but this take "
                            "uses %s; byte-identical dedup will likely miss every "
                            "compressed object",
                            base, codec, recorded, current,
                        )
                merged, unreadable = _read_checksum_sidecars(storage, metadata.world_size, event_loop)
                if unreadable:
                    logger.warning(
                        "base=%s: checksum sidecars unreadable (%s); objects recorded "
                        "only there will be rewritten",
                        base, unreadable,
                    )
                digests = {k: v for k, v in merged.items() if record_content_keys(v)}
                if digests and len(digests) < len(merged):
                    logger.warning(
                        "base=%s: %d of %d objects carry no sha256 dedup identity and "
                        "will be rewritten (pin TSS_TORCH_DEDUP_DIGESTS=1 on every host)",
                        base, len(merged) - len(digests), len(merged),
                    )
                if not digests:
                    logger.warning(
                        "base=%s carries no sha256 dedup identities (its take ran with "
                        "dedup digests off); taking a full snapshot. Pin "
                        "TSS_TORCH_DEDUP_DIGESTS=1 for every take of an incremental chain",
                        base,
                    )
                    return None
                return root, digests
            finally:
                storage.sync_close(event_loop)
        finally:
            event_loop.close()

    # --------------------------------------------------------------- restore
    def restore(
        self,
        app_state: AppState,
        device: Any = "cuda",
        coordinator: Optional[Coordinator] = None,
        include: Optional[List[str]] = None,
        _telemetry: Optional[telemetry.Telemetry] = None,
        job: Optional[str] = None,
        step: Optional[int] = None,
        qos: Any = None,
    ) -> None:
        """Load every stateful of ``app_state`` from this snapshot, in place
        into live tensors where dtype and shape match. A live DTensor's
        local shard is filled from the saved bytes that overlap it, on its
        own device, whatever sharding the snapshot was saved with.

        ``include``: logical-path globs (e.g. ``["model/blocks/0"]``)
        restricting the restore to the matching subtrees: a lazy partial
        restore reads only the byte ranges of those entries, and every
        other leaf keeps its live value. A glob selects an entry when it
        fnmatches its path, equals it, or names an ancestor. Every rank
        passes the same ``include``.

        With several ranks, replicated entries may be read once and shared
        (``TSS_TORCH_BCAST_RESTORE``, ``TSS_TORCH_SWARM_RESTORE``); reads
        are verified under ``TSS_TORCH_VERIFY_READS``. A failure on any
        rank reaches every rank as :class:`CheckpointAbortedError`; live
        state may then be partly loaded. An error raised by a stateful's
        own ``load_state_dict`` reaches its rank as itself, and its peers
        as :class:`CheckpointAbortedError` naming that rank.
        ``LAST_RESTORE_STATS`` holds this process's accounting of the
        restore.

        ``_telemetry``: as in :meth:`take`; the restore's artifact is
        ``.telemetry/restore_rank_<k>.json``. ``job``/``step``: each rank
        appends a rollout record (wall time, origin/peer/cache bytes) under
        the bucket's ``.catalog/rollouts/``, fail-open; ``step`` defaults
        to the trailing digits of the snapshot's name.

        ``qos``: the restore's QoS class. ``qos="foreground"`` (a serving
        replica's restart) registers FOREGROUND demand for the whole
        restore, so every lower-class engine in this process (an async
        take's background drain, scrub, gc, a cache populate, a background
        swarm fetch) pauses its next admission until the restore ends."""
        _validate_app_state(app_state)
        coord = get_coordinator(coordinator or self._coordinator)
        rank = coord.get_rank()
        tm, tm_prev = _begin_telemetry(_telemetry)
        telemetry.fleet.note_op("restore")
        try:
            with _qos_scope(qos):
                self._restore_impl(app_state, device, coord, include, tm, job, step)
        finally:
            telemetry.fleet.note_op(None)
            _finish_telemetry(tm, tm_prev, rank)

    def _restore_impl(
        self,
        app_state: AppState,
        device: Any,
        coord: Coordinator,
        include: Optional[List[str]],
        tm: Optional[telemetry.Telemetry],
        job: Optional[str],
        step: Optional[int],
    ) -> None:
        rank = coord.get_rank()
        world = coord.get_world_size()
        barrier = self._barrier(coord, "restore", self.path)
        # The memory store's recycled buffers wait for the next take's
        # copies, which would otherwise need new pages; a restore's own
        # pages come on top of a take's peak, so it gives them back first.
        memory_store.release_recycled_buffers()
        # Before the plugin: its O_DIRECT width reads the local world size.
        memory_budget = scheduler.get_process_memory_budget_bytes(coord)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path)
        t0 = time.monotonic()
        bcast_mod.reset_diagnostics()
        swarm_mod.reset_diagnostics()
        LAST_RESTORE_STATS.clear()
        totals = {"bytes_read": 0.0, "read_wall_s": 0.0, "requests": 0.0}
        modes = _RestoreModes(
            coord if world > 1 else None,
            knobs.is_broadcast_restore_enabled(world),
            knobs.is_swarm_restore_enabled(world),
        )
        phase = "restore.plan"
        try:
            with telemetry.span("restore.read_metadata", cat="restore"):
                metadata = self._read_metadata(storage, event_loop)
            digests = self._load_digest_index(storage, metadata, event_loop)
            self._attach_cache_digests(storage, digests)
            manifest = get_manifest_for_rank(metadata, rank)
            # One pass over the manifest, bucketed by first path segment, so
            # planning costs O(manifest) whatever the number of keys. A key
            # holding '/' looks up its first segment; _read_tree's exact
            # prefix filter narrows the bucket.
            by_first_seg: Dict[str, Manifest] = {}
            for p, e in manifest.items():
                by_first_seg.setdefault(p.partition("/")[0], {})[p] = e
            phase = "restore.read"
            # RNG last, so loading other statefuls cannot perturb it.
            keys = sorted(app_state, key=lambda k: (isinstance(app_state[k], RNGState), k))
            for key in keys:
                with telemetry.span("restore.load_stateful", cat="restore", key=key):
                    stateful = app_state[key]
                    _, live = flatten(stateful.state_dict(), prefix=key)
                    state, stats = self._read_tree(
                        key, by_first_seg.get(key.partition("/")[0], {}), live, storage, event_loop,
                        device, memory_budget, include=include, modes=modes, digests=digests,
                    )
                    _load_state_dict(stateful, state)
                totals["bytes_read"] += stats["bytes_read"]
                totals["read_wall_s"] += stats["wall_s"]
                totals["requests"] += stats["requests"]
            _persist_op_artifact(
                storage, event_loop, rank, world, "restore", tm,
                phase_spans=tm.spans(cat="restore") if tm is not None else None,
            )
            phase = "restore.barrier"
            if barrier is not None:
                with _barrier_stall_guard(rank):
                    barrier.arrive()
                    barrier.depart()
                coord.note_external_barrier()
                # Every rank has read every broadcast and swarm payload.
                coord.collect_deferred()
            telemetry.fleet.gc_beacons()
            LAST_RESTORE_STATS.update(totals)
            LAST_RESTORE_STATS["wall_s"] = time.monotonic() - t0
            LAST_RESTORE_STATS["bcast"] = dict(bcast_mod.LAST_RESTORE_BCAST)
            LAST_RESTORE_STATS["swarm"] = dict(swarm_mod.LAST_RESTORE_SWARM)
            LAST_RESTORE_STATS["attribution"] = _restore_attribution(
                bcast_mod.LAST_RESTORE_BCAST, swarm_mod.LAST_RESTORE_SWARM, totals, storage
            )
            if job is not None:
                self._append_rollout_record(job, step, rank, world, event_loop)
        except BaseException as e:
            aborted = _abort_exception(self.path, barrier, rank, phase, e)
            if aborted is e or getattr(e, "_tss_app_hook_error", False):
                # An application's own load hook raised: its peers were
                # released naming this rank, but the caller gets the error
                # itself (a missing leaf is a KeyError, not an abort).
                raise
            raise aborted from e
        finally:
            storage.sync_close(event_loop)
            event_loop.close()

    def _append_rollout_record(
        self, job: str, step: Optional[int], rank: int, world_size: int, event_loop: asyncio.AbstractEventLoop
    ) -> None:
        """This rank's rollout record of the restore just done (from
        ``LAST_RESTORE_STATS``), under the bucket's catalog; fail-open."""
        if not (knobs.is_catalog_enabled() and knobs.is_step_telemetry_enabled()):
            return
        from . import catalog as catalog_mod

        try:
            split = catalog_mod.split_bucket(self.path)
            if split is None:
                logger.warning("snapshot %s has no parent bucket; rollout record skipped", self.path)
                return
            bucket, name = split
            if step is None:
                m = re.search(r"(\d+)$", name)
                step = int(m.group(1)) if m else None
            swarm_rec = LAST_RESTORE_STATS.get("swarm") or {}
            bcast_rec = LAST_RESTORE_STATS.get("bcast") or {}
            if swarm_rec.get("chunks_peer") or swarm_rec.get("chunks_origin"):
                mode = "swarm"
            elif bcast_rec.get("entries") or bcast_rec.get("received"):
                mode = "bcast"
            else:
                mode = "direct"
            record = telemetry.steprecord.build_rollout_record(
                job=job,
                step=step,
                name=name,
                rank=rank,
                world_size=world_size,
                wall_s=LAST_RESTORE_STATS.get("wall_s", 0.0) or 0.0,
                attribution=LAST_RESTORE_STATS.get("attribution") or {},
                mode=mode,
            )
            with catalog_mod.Catalog(bucket, event_loop=event_loop) as cat:
                cat.append_rollout_record(record)
        except Exception:  # noqa: BLE001 - fail-open by contract
            logger.warning("rollout record for %s could not be appended (restore unaffected)", self.path, exc_info=True)

    def _read_tree(
        self,
        logical_path: str,
        manifest: Manifest,
        live: Dict[str, Any],
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        device: Any,
        memory_budget_bytes: Optional[int],
        include: Optional[List[str]] = None,
        modes: Optional["_RestoreModes"] = None,
        digests: Optional[Dict[str, Any]] = None,
    ) -> Tuple[Any, Dict[str, float]]:
        """Read the leaf at ``logical_path``, or every leaf under it, and
        rebuild the nested value; returns it with the read pipeline's
        stats. ``live`` maps logical paths to the tensors to fill in place;
        leaves ``include`` leaves out keep them. ``modes`` (several ranks)
        sends replicated entries through the broadcast or the swarm."""
        prefix = f"{logical_path}/"
        scoped = {
            p: e for p, e in manifest.items() if p == logical_path or p.startswith(prefix)
        }
        if not scoped:
            raise KeyError(f"{logical_path!r} not found in snapshot {self.path!r}")
        budget = memory_budget_bytes or scheduler.get_process_memory_budget_bytes(None)
        loaded: Dict[str, Any] = {}
        entries = {p: e for p, e in scoped.items() if not is_container_entry(e)}
        if include:
            selected = {p: e for p, e in entries.items() if _matches_include(p, include)}
            for p in entries:
                if p not in selected and p in live:
                    loaded[p] = live[p]
            entries = selected
        h2d = d2h.HostToDevice()
        read_reqs: List[ReadReq] = []
        # Overlap on: each entry's finalizer (its H2D) runs as its last
        # read is consumed, so the copies overlap the reads in flight and
        # each pinned host buffer goes as its entry lands. Off: every read
        # first, then every finalizer (phase-split).
        platforms = _target_device_types(live, entries)
        overlap = knobs.is_restore_overlap_enabled(
            has_device_targets=bool(platforms), target_platforms=lambda: platforms
        )
        pending_finalizers: Dict[int, Callable[[], None]] = {}
        finalizers: List[Callable[[], None]] = []
        bcast_items: List[bcast_mod.BroadcastItem] = []
        swarm_items: List[swarm_mod.SwarmItem] = []
        swarm_need: Dict[str, List[frozenset]] = {}
        frame_tables = _fetch_frame_tables(
            [(e, live.get(p)) for p, e in entries.items()], storage, event_loop, budget
        )
        # Direct shard sub-reads align to the sidecars' hash chunks only
        # where something uses whole chunks: verification of every read, or
        # a read cache's chunk tier. Otherwise alignment only reads more.
        align = digests if knobs.is_origin_read_verify_enabled() or find_read_cache(storage) else None
        coord = modes.coord if modes is not None else None
        for p, entry in entries.items():
            target = live.get(p)
            mode = "direct"
            if coord is not None:
                mode = bcast_mod.select_restore_mode(
                    entry, target, modes.bcast, modes.swarm, digests
                )
            if mode == "reshard":
                need = swarm_mod.plan_reshard_need(entry, target, digests, coord.get_world_size())
                if need is not None:
                    reqs, fin = _prepare_restore_one(
                        p, entry, target, loaded, device, None, h2d, frame_tables, digests
                    )
                    swarm_need.update(need)
                    swarm_items.append(
                        swarm_mod.SwarmItem(
                            p, reqs, fin, paths=[s.tensor.location for s in entry.shards]
                        )
                    )
                    continue
                mode = "direct"
            if mode in ("bcast", "swarm"):
                # No budget split: the same reads on every rank.
                reqs, fin = _prepare_restore_one(
                    p, entry, target, loaded, device, None, h2d, frame_tables, digests
                )
                item_cls = bcast_mod.BroadcastItem if mode == "bcast" else swarm_mod.SwarmItem
                (bcast_items if mode == "bcast" else swarm_items).append(item_cls(p, reqs, fin))
                continue
            reqs, fin = _prepare_restore_one(
                p, entry, target, loaded, device, budget, h2d, frame_tables, align
            )
            if fin is not None:
                if not reqs:
                    fin()
                elif overlap:
                    idx = len(pending_finalizers)
                    pending_finalizers[idx] = fin
                    countdown = _ReadCountdown(idx, len(reqs), pending_finalizers)
                    reqs = [
                        ReadReq(path=r.path, buffer_consumer=_CountingConsumer(r.buffer_consumer, countdown), byte_range=r.byte_range)
                        for r in reqs
                    ]
                else:
                    finalizers.append(fin)
            read_reqs.extend(reqs)
        if bcast_items or swarm_items:
            with ThreadPoolExecutor(
                knobs.get_consuming_threads(), thread_name_prefix="tss-collective"
            ) as executor:
                bcast_mod.run_broadcast(bcast_items, storage, coord, event_loop, executor, digests)
                swarm_mod.run_swarm(
                    swarm_items, storage, coord, event_loop, executor, digests, swarm_need or None
                )
        read_reqs = batch_read_requests(
            read_reqs, max_merged_bytes=budget, merge_large=find_read_cache(storage) is not None
        )
        stats = sync_execute_read_reqs(read_reqs, storage, budget, event_loop, digests)
        if pending_finalizers:
            # A pipeline that ended cleanly consumed every read.
            raise RuntimeError(f"restore left {len(pending_finalizers)} entries unfinalized")
        for fin in finalizers:
            fin()
        h2d.finish()
        containers = {p: e for p, e in scoped.items() if is_container_entry(e)}
        if not containers and logical_path in loaded:
            return loaded[logical_path], stats
        return inflate(containers, loaded, prefix=logical_path), stats

    # ----------------------------------------------------------- read_object
    def read_object(
        self,
        path: str,
        obj_out: Optional[Any] = None,
        memory_budget_bytes: Optional[int] = None,
        device: Any = "cuda",
    ) -> Any:
        """One persisted value, or a manifest subtree, rebuilt, addressed
        as ``"<rank>/<logical_path>"``. Tensors land on ``device``, or in
        ``obj_out`` in place when it matches; a sharded entry comes back
        whole. Needs no other rank."""
        if isinstance(obj_out, torch.Tensor):
            device = obj_out.device
        d2h.require_cuda(device)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path)
        try:
            rank_str, _, logical_path = path.partition("/")
            metadata = self._read_metadata(storage, event_loop)
            digests = self._load_digest_index(storage, metadata, event_loop)
            self._attach_cache_digests(storage, digests)
            manifest = get_manifest_for_rank(metadata, int(rank_str))
            value, _ = self._read_tree(
                logical_path,
                manifest,
                {logical_path: obj_out},
                storage,
                event_loop,
                device,
                memory_budget_bytes or scheduler.get_process_memory_budget_bytes(None),
                digests=digests,
            )
            return value
        finally:
            storage.sync_close(event_loop)
            event_loop.close()

    def _load_digest_index(
        self,
        storage: StoragePlugin,
        metadata: SnapshotMetadata,
        event_loop: asyncio.AbstractEventLoop,
    ) -> Optional[Dict[str, Any]]:
        """The merged sidecars ``{path: record}``, when a reader uses them:
        the read cache (content keys, hit checks) or read verification
        (any ``TSS_TORCH_VERIFY_READS`` but ``off``). None otherwise, or
        when they cannot be read: reads then go unverified, never fail."""
        if not knobs.get_read_cache_dir() and knobs.get_verify_reads_mode() == "off":
            return None
        try:
            merged, _ = _read_checksum_sidecars(storage, metadata.world_size, event_loop)
        except Exception:  # noqa: BLE001 - degrade, never fail the restore
            logger.warning(
                "could not read the checksum sidecars; reads go unverified", exc_info=True
            )
            return None
        return merged or None

    @staticmethod
    def _attach_cache_digests(storage: StoragePlugin, digests: Optional[Dict[str, Any]]) -> None:
        """Hand a read cache in the plugin stack ``{path: (size, content
        key, crc32, chunk info)}`` from the sidecars, making its entries
        content-addressed and its hits checkable."""
        if not digests or not knobs.get_read_cache_dir():
            return
        cache = find_read_cache(storage)
        if cache is None:
            return
        index = {}
        for p, v in digests.items():
            size = hashing.record_size(v)
            if size is not None:
                index[p] = (
                    size,
                    hashing.record_cache_key(v),
                    hashing.record_crc(v),
                    hashing.record_chunk_info(v),
                )
        if index:
            cache.attach_digest_index(index)

    # ---------------------------------------------------------------- verify
    def verify(self) -> Dict[str, str]:
        """Audit every storage object against the crc32 recorded in the
        ``.checksums.<rank>`` sidecars. Returns ``{path: problem}``; empty
        means clean. A problem is ``"missing"``, ``"crc mismatch (...)"``,
        ``"unreadable (...)"`` (a read failed otherwise than by absence),
        ``"sidecar unreadable (...)"`` (keyed by the sidecar) or
        ``"unverified (...)"`` (an object no readable sidecar covers).
        Raises ``RuntimeError`` when objects exist but no sidecar does."""
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path)
        try:
            metadata = self._read_metadata(storage, event_loop)
            expected, unreadable = _read_checksum_sidecars(storage, metadata.world_size, event_loop)
            locations = _manifest_storage_locations(metadata.manifest)
            if not expected and not unreadable:
                if not locations:
                    return {}
                raise RuntimeError(
                    "snapshot has no checksum sidecars (taken with TSS_TORCH_CHECKSUMS=0?); nothing to verify"
                )
            problems: Dict[str, str] = {
                f"{CHECKSUM_FILE_PREFIX}{r}": f"sidecar unreadable ({err})" for r, err in sorted(unreadable.items())
            }
            for loc in sorted(locations):
                if loc not in expected:
                    problems[loc] = _uncovered_problem(loc, unreadable)

            async def check(path: str, rec: Any) -> None:
                read_io = ReadIO(path=path)
                try:
                    await storage.read(read_io)
                except FileNotFoundError:
                    problems[path] = "missing"
                    return
                except Exception as e:  # noqa: BLE001 - not evidence of absence
                    problems[path] = f"unreadable ({e!r})"
                    return
                got = zlib.crc32(read_io.buf)
                want = record_crc(rec)
                if want is not None and got != want:
                    problems[path] = f"crc mismatch (recorded {want}, found {got})"

            # One BACKGROUND engine.verify node per object, costed at its
            # recorded size.
            budget = scheduler.get_process_memory_budget_bytes(None)
            nodes = [
                Node(
                    "verify",
                    lambda ctx, _p, path=path, rec=rec: check(path, rec),
                    cost_bytes=min(size if size is not None else budget // 8, budget),
                    pool="io",
                    stream="io",
                    path=path,
                )
                for path, rec in sorted(expected.items())
                for size in [hashing.record_size(rec)]
            ]
            event_loop.run_until_complete(
                run_graph(nodes, budget_bytes=budget, owner="verify", kind="verify", caps={"io": knobs.get_max_concurrent_io_for(storage)})
            )
            return problems
        finally:
            storage.sync_close(event_loop)
            event_loop.close()

    # ----------------------------------------------------------------- scrub
    def scrub(self, repair: bool = False) -> Dict[str, Any]:
        """Deep integrity audit of this snapshot and, with ``repair=True``,
        self-healing. Every object the manifest names is read (through the
        budgeted read engine) and checked against the sidecars: its size,
        then per chunk for a v2 record (naming the bad chunks), else its
        sha256, else its crc32. Every framed payload's ``.ftab`` must
        parse and its frames sum to the payload's length. Returns::

            {"entries": {path: {"status", "detail"}}, "objects", "bytes",
             "problems", "corrupt", "repaired", "quarantined", "clean"}

        Statuses: ``ok``, ``corrupt``, ``missing``, ``unreadable``,
        ``unverified`` (no readable sidecar covers it), ``ftab-mismatch``,
        and with ``repair=True`` ``repaired`` or ``quarantined``. Repair
        rewrites a corrupt or missing object from a copy this scrub
        verified with the same (size, content key) in the sidecars (another
        rank's copy of a replicated value, or a deduped twin), patching
        only the bad chunks of a v2 record; a corrupt object with no such
        copy moves to ``<path>.quarantined``, so a later restore fails on
        it rather than load it, and any read-cache entry of it is removed.
        One process, no collectives."""
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path)
        try:
            with telemetry.span("scrub.scan", cat="scrub", path=self.path):
                return self._scrub_impl(storage, event_loop, repair)
        finally:
            storage.sync_close(event_loop)
            event_loop.close()

    def _scrub_impl(
        self, storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop, repair: bool
    ) -> Dict[str, Any]:
        metadata = self._read_metadata(storage, event_loop)
        expected, unreadable = _read_checksum_sidecars(storage, metadata.world_size, event_loop)
        locations = sorted(_manifest_storage_locations(metadata.manifest))
        entries: Dict[str, Dict[str, str]] = {}
        sizes: Dict[str, int] = {}
        scanned = [0]
        # (size, content key) -> paths this scrub verified: repair sources.
        clean_by_content: Dict[Tuple[int, str], List[str]] = {}
        corrupt_chunks: Dict[str, List[int]] = {}

        def record(path: str, status: str, detail: str = "") -> None:
            entries[path] = {"status": status, "detail": detail}

        def digest_of(path: str) -> Any:
            rec = expected.get(path)
            return rec if isinstance(rec, int) or hashing.record_size(rec) is not None else None

        def check(path: str, want: Any, data: memoryview) -> None:
            sizes[path] = data.nbytes
            scanned[0] += data.nbytes
            if want is None:
                record(path, "unverified", _uncovered_problem(path, unreadable))
                return
            size_want = hashing.record_size(want)
            if size_want is not None and data.nbytes != size_want:
                record(path, "corrupt", f"size {data.nbytes} != recorded {size_want}")
                return
            info = hashing.record_chunk_info(want)
            if info is not None:
                bad = hashing.find_bad_chunks(data, want)
                if bad:
                    corrupt_chunks[path] = bad
                    kind = "sha256" if info[1] is not None else "crc32"
                    record(path, "corrupt", f"chunk {kind} mismatch at chunk(s) {bad} (grain {info[0]})")
                    return
            else:
                sha_want = hashing.record_whole_sha(want)
                if sha_want:
                    got = hashlib.sha256(data).hexdigest()
                    if got != sha_want:
                        record(path, "corrupt", f"sha256 {got} != recorded {sha_want}")
                        return
                crc_want = hashing.record_crc(want)
                got_crc = zlib.crc32(data)
                if isinstance(crc_want, int) and got_crc != crc_want:
                    record(path, "corrupt", f"crc32 {got_crc} != recorded {crc_want}")
                    return
            record(path, "ok")
            if size_want is not None:
                for key in hashing.record_content_keys(want):
                    clean_by_content.setdefault((size_want, key), []).append(path)

        budget = scheduler.get_process_memory_budget_bytes(None)
        hash_pool = ThreadPoolExecutor(knobs.get_hash_workers(), thread_name_prefix="tss-scrub")

        async def scan(path: str, want: Any) -> None:
            read_io = ReadIO(path=path)
            try:
                await storage.read(read_io)
            except FileNotFoundError:
                record(path, "missing")
                return
            except Exception as e:  # noqa: BLE001 - reported
                record(path, "unreadable", repr(e))
                return
            data = memoryview(read_io.buf).cast("B")
            await asyncio.get_running_loop().run_in_executor(hash_pool, check, path, want, data)

        nodes = [
            Node(
                "verify",
                lambda ctx, _p, path=path, want=want: scan(path, want),
                cost_bytes=min(size if size is not None else budget // 8, budget),
                pool="io",
                stream="io",
                path=path,
            )
            for path in locations
            for want in [digest_of(path)]
            for size in [hashing.record_size(want)]
        ]
        try:
            # BACKGROUND: the sweep yields its next read to any take or
            # restore of a higher class in this process.
            event_loop.run_until_complete(
                run_graph(nodes, budget_bytes=budget, owner="scrub", kind="scrub", caps={"io": knobs.get_max_concurrent_io_for(storage)})
            )
        finally:
            hash_pool.shutdown()
        event_loop.run_until_complete(
            _scrub_ftabs(storage, _framed_locations(metadata.manifest), sizes, record)
        )
        for r, err in sorted(unreadable.items()):
            record(f"{CHECKSUM_FILE_PREFIX}{r}", "unreadable", f"sidecar unreadable ({err})")
        repaired = quarantined = 0
        if repair:
            repaired, quarantined = event_loop.run_until_complete(
                _scrub_repair(storage, entries, digest_of, clean_by_content, corrupt_chunks)
            )
        corrupt = sum(1 for e in entries.values() if e["status"] == "corrupt")
        problems = sum(1 for e in entries.values() if e["status"] not in ("ok", "repaired"))
        telemetry.counter_add("scrub.objects", len(locations))
        telemetry.counter_add("scrub.bytes", scanned[0])
        if corrupt:
            telemetry.counter_add("scrub.corrupt", corrupt)
        if repaired:
            telemetry.counter_add("scrub.repaired", repaired)
        if quarantined:
            telemetry.counter_add("scrub.quarantined", quarantined)
        return {
            "entries": entries,
            "objects": len(locations),
            "bytes": scanned[0],
            "problems": problems,
            "corrupt": corrupt,
            "repaired": repaired,
            "quarantined": quarantined,
            "clean": problems == 0,
        }

    # -------------------------------------------------------------------- gc
    @classmethod
    def gc(
        cls,
        path: str,
        dry_run: bool = True,
        keep_roots: Optional[Set[str]] = None,
        roots: Optional[List[str]] = None,
        collect_debris: bool = True,
    ) -> Dict[str, Any]:
        """Garbage-collect under ``path``: the one deletion path of both the
        crash-debris sweep and the catalog's retention (``catalog.retain``).

        ``path`` is one snapshot root, or a bucket whose children are
        snapshot roots. A committed snapshot (``.snapshot_metadata``
        present) keeps its metadata, every object its manifest references
        with their ``.ftab`` frame tables, its ``.checksums.<rank>``
        sidecars and its ``.telemetry/`` artifacts; everything else in it
        (``*.tmp.*`` files of torn writes, a crashed retake's objects) is
        debris. A child tree without metadata is debris whole: no reader
        can see it.

        ``keep_roots`` (bucket only): the keep set. A committed child root
        it does not name, and that the bucket's catalog does not pin, is
        condemned and deleted whole in a crash-convergent order:
        ``.snapshot_metadata`` first, then the tree, then its catalog
        record, so a crash leaves a record-marked zombie the next run
        finishes. None keeps every committed root (the debris sweep).
        Deletion unlinks paths and never rewrites a file, so a retained
        delta's hard links to a condemned base stay whole.

        ``roots``: more candidate root names than the bucket lists (a
        ``memory://`` child lives in its own store; retention passes the
        catalog's names). Given, only those may be condemned, so a
        committed snapshot the caller does not know of is kept.

        ``collect_debris=False`` deletes only condemned roots, zombies and
        stale records, never a record-less uncommitted tree (possibly a
        take in flight) or a loose file: what makes retention safe beside
        takes. The full sweep (the default) must not run beside a take.

        The ``.catalog/`` tree is never a snapshot root: records of kept
        snapshots and pins stay, records of condemned or vanished ones go
        after their trees.

        Dry run by default. One process, no collective. Returns
        ``{"committed", "uncommitted", "condemned": [roots], "keep",
        "remove", "remove_records": [paths], "removed": int, "dry_run"}``
        (paths relative to ``path``)."""
        from . import catalog as catalog_mod

        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path)
        sub_plugins: Dict[str, StoragePlugin] = {}

        def sub_plugin(root: str) -> StoragePlugin:
            if root not in sub_plugins:
                sub_plugins[root] = url_to_storage_plugin(catalog_mod.join_bucket(path, root))
            return sub_plugins[root]

        try:
            t_scan = time.monotonic()
            all_paths = set(event_loop.run_until_complete(storage.list_prefix("")))
            single = SNAPSHOT_METADATA_FNAME in all_paths
            if single and keep_roots is not None:
                raise ValueError(
                    f"keep_roots applies to bucket-level gc; {path} is itself a committed snapshot root"
                )
            cat_prefix = f"{catalog_mod.CATALOG_DIR}/"
            # The catalog: record object -> snapshot name, pins, and files
            # that cannot be classified (kept, fail-safe).
            record_paths: Dict[str, List[str]] = {}
            pinned: Set[str] = set()
            catalog_keep: Set[str] = set()
            if not single:
                for p in sorted(q for q in all_paths if q.startswith(cat_prefix)):
                    try:
                        read_io = ReadIO(path=p)
                        storage.sync_read(read_io, event_loop)
                        name = str(json.loads(bytes(read_io.buf).decode())["name"])
                    except Exception:  # noqa: BLE001 - unclassifiable
                        catalog_keep.add(p)
                        continue
                    if p.startswith((f"{catalog_mod.RECORD_DIR}/", f"{catalog_mod.STEP_TELEMETRY_DIR}/")):
                        # Step records share their snapshot's lifecycle.
                        record_paths.setdefault(name, []).append(p)
                    elif p.startswith(f"{catalog_mod.PIN_DIR}/"):
                        pinned.add(name)
                        catalog_keep.add(p)
                    else:
                        catalog_keep.add(p)

            # Candidate roots: the listing's children, every recorded name,
            # and the caller's.
            if single:
                root_names = [""]
            else:
                root_names = sorted(
                    ({p.partition("/")[0] for p in all_paths if "/" in p} - {catalog_mod.CATALOG_DIR})
                    | set(record_paths)
                    | set(roots or [])
                )

            # Per root: its files (root-relative), and the plugin that owns
            # them when the bucket cannot list them (memory://).
            views: Dict[str, Dict[str, Any]] = {}
            for root in root_names:
                prefix = f"{root}/" if root else ""
                if root:
                    listed = sorted(p[len(prefix) :] for p in all_paths if p.startswith(prefix))
                else:
                    listed = sorted(all_paths)
                sub: Optional[StoragePlugin] = None
                if root and not listed:
                    try:
                        sub = sub_plugin(root)
                        listed = sorted(event_loop.run_until_complete(sub.list_prefix("")))
                    except Exception:  # noqa: BLE001 - an unlistable root
                        listed = []
                    if not listed:
                        sub = None
                views[root] = {"paths": listed, "sub": sub, "committed": SNAPSHOT_METADATA_FNAME in listed}

            committed = sorted(r for r, v in views.items() if v["committed"])
            uncommitted = sorted(r for r, v in views.items() if not v["committed"] and v["paths"])
            keep_set = set(keep_roots) | pinned if keep_roots is not None else None
            # Only the caller's universe may be condemned: an unreadable
            # catalog must not hand gc an empty keep set over the bucket.
            universe = set(roots) if roots is not None else None
            condemned = sorted(
                r
                for r in committed
                if keep_set is not None and r not in keep_set and (universe is None or r in universe)
            )
            # Zombies: a record names the root but its tree is uncommitted
            # (a crash after a condemned root's metadata went). Finished in
            # any mode.
            zombies = sorted(r for r in uncommitted if r in record_paths)

            retained = [r for r in committed if r not in condemned]
            keep: Set[str] = set(catalog_keep)
            observed: Set[str] = set(all_paths)
            for root in views:
                prefix = f"{root}/" if root else ""
                if views[root]["sub"] is not None:
                    observed.update(f"{prefix}{p}" for p in views[root]["paths"])
            for root in retained:
                v = views[root]
                prefix = f"{root}/" if root else ""
                meta_path = f"{prefix}{SNAPSHOT_METADATA_FNAME}"
                if v["sub"] is not None:
                    read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
                    v["sub"].sync_read(read_io, event_loop)
                else:
                    read_io = ReadIO(path=meta_path)
                    storage.sync_read(read_io, event_loop)
                metadata = SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8"))
                keep.add(meta_path)
                for loc in _manifest_storage_locations(metadata.manifest):
                    keep.add(f"{prefix}{loc}")
                    keep.add(f"{prefix}{loc}{FRAME_TABLE_SUFFIX}")
                for r in range(metadata.world_size):
                    keep.add(f"{prefix}{CHECKSUM_FILE_PREFIX}{r}")
                keep.update(f"{prefix}{p}" for p in v["paths"] if p.startswith(".telemetry/"))
                keep.update(record_paths.get(root, []))

            # What goes, in three crash-ordered waves (bucket paths).
            meta_wave: List[str] = []
            tree_wave: List[str] = []
            record_wave: List[str] = []
            for root in condemned:
                prefix = f"{root}/" if root else ""
                meta_wave.append(f"{prefix}{SNAPSHOT_METADATA_FNAME}")
                tree_wave.extend(f"{prefix}{p}" for p in views[root]["paths"] if p != SNAPSHOT_METADATA_FNAME)
                record_wave.extend(record_paths.get(root, []))
            for root in zombies:
                prefix = f"{root}/" if root else ""
                tree_wave.extend(f"{prefix}{p}" for p in views[root]["paths"])
                record_wave.extend(record_paths.get(root, []))
            # Stale records: the named tree is gone (a crash between a
            # previous run's tree and record waves).
            for name, paths in record_paths.items():
                if name in views and not views[name]["paths"]:
                    record_wave.extend(paths)
            if collect_debris:
                zombie_set = set(zombies)
                for root in uncommitted:
                    if root in zombie_set:
                        continue
                    prefix = f"{root}/" if root else ""
                    tree_wave.extend(f"{prefix}{p}" for p in views[root]["paths"])
                    record_wave.extend(record_paths.get(root, []))
                # Debris inside retained roots, and loose bucket files.
                handled = set(condemned) | zombie_set | set(uncommitted)
                meta_set = set(meta_wave)
                tree_wave.extend(
                    sorted(
                        p
                        for p in observed
                        if p not in keep
                        and not p.startswith(cat_prefix)
                        and p.partition("/")[0] not in handled
                        and p not in meta_set
                    )
                )
            remove = sorted(set(meta_wave) | set(tree_wave))
            remove_all = set(meta_wave) | set(tree_wave) | set(record_wave)
            _add_span("gc.scan", "gc", t_scan, path=path)
            telemetry.counter_add("gc.files_scanned", len(observed))
            telemetry.counter_add("gc.files_debris", len(remove_all))
            removed = 0
            if not dry_run:
                t_delete = time.monotonic()

                def owner_of(p: str) -> Tuple[StoragePlugin, str]:
                    root = p.partition("/")[0]
                    v = views.get(root)
                    if v is not None and v["sub"] is not None:
                        return v["sub"], p[len(root) + 1 :]
                    return storage, p

                async def delete_wave(paths: List[str]) -> int:
                    # The waves run one after another; deletes inside one
                    # run up to the I/O width. A file already gone counts:
                    # the goal is reached.
                    done = [0]

                    async def delete(p: str) -> None:
                        plugin, rel = owner_of(p)
                        try:
                            await plugin.delete(rel)
                        except FileNotFoundError:
                            pass
                        done[0] += 1

                    # A BACKGROUND engine: a retention sweep beside a
                    # serving restore yields its next deletions to it.
                    nodes = [
                        Node("delete", lambda ctx, _payload, p=p: delete(p), pool="io", stream="io", path=p)
                        for p in sorted(set(paths))
                    ]
                    await run_graph(nodes, budget_bytes=0, owner="gc", kind="gc", caps={"io": knobs.get_max_concurrent_io_for(storage)})
                    return done[0]

                # Metadata first (each condemned snapshot stops being
                # restorable before any data byte goes), then the trees,
                # then the records: a record goes only once its tree has.
                for wave in (meta_wave, tree_wave, record_wave):
                    if wave:
                        n = event_loop.run_until_complete(delete_wave(wave))
                        removed += n
                        if wave is record_wave:
                            telemetry.counter_add("gc.records_removed", n)
                # A crashed take may leave empty directories (fs).
                event_loop.run_until_complete(storage.prune_empty())
                for sub in sub_plugins.values():
                    event_loop.run_until_complete(sub.prune_empty())
                _add_span("gc.delete", "gc", t_delete, path=path, files=len(remove_all))
                telemetry.counter_add("gc.files_removed", removed)
            return {
                "committed": committed,
                "uncommitted": uncommitted,
                "condemned": condemned,
                "keep": sorted(keep & observed),
                "remove": remove,
                "remove_records": sorted(set(record_wave)),
                "removed": removed,
                "dry_run": dry_run,
            }
        finally:
            for sub in sub_plugins.values():
                sub.sync_close(event_loop)
            storage.sync_close(event_loop)
            event_loop.close()

    # -------------------------------------------------------------- metadata
    @property
    def metadata(self) -> SnapshotMetadata:
        if self._metadata is None:
            event_loop = asyncio.new_event_loop()
            storage = url_to_storage_plugin(self.path)
            try:
                self._read_metadata(storage, event_loop)
            finally:
                storage.sync_close(event_loop)
                event_loop.close()
        return self._metadata

    def get_manifest(self) -> Manifest:
        """The global ``"<rank>/<logical_path>" -> Entry`` manifest."""
        return dict(self.metadata.manifest)

    def _read_metadata(
        self, storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
    ) -> SnapshotMetadata:
        if self._metadata is None:
            read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
            storage.sync_read(read_io, event_loop)
            self._metadata = SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8"))
        return self._metadata


def _validate_app_state(app_state: AppState) -> None:
    for key, value in app_state.items():
        if not (hasattr(value, "state_dict") and hasattr(value, "load_state_dict")):
            raise TypeError(
                f"app_state[{key!r}] is not Stateful "
                f"(needs state_dict/load_state_dict): {type(value)}"
            )


def _write_snapshot_metadata(
    metadata: SnapshotMetadata, storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop
) -> None:
    storage.sync_write(
        WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=metadata.to_json().encode("utf-8")),
        event_loop,
    )


def _commit(
    barrier: Optional[LinearBarrier],
    rank: int,
    metadata: SnapshotMetadata,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    path: str,
    catalog_info: Optional[Tuple[str, Optional[int], Optional[str], int]] = None,
) -> None:
    """Rank 0 writes ``.snapshot_metadata`` once every rank's data is
    written (arrive), and every rank returns only once it is visible
    (depart), so no rank can open the snapshot before it exists. With
    ``catalog_info`` (``job``, ``step``, base, chain length) rank 0 appends
    the catalog record between the two: after the metadata (a record
    implies a committed snapshot), before any rank returns."""
    if barrier is not None:
        barrier.arrive()
    if rank == 0:
        _write_snapshot_metadata(metadata, storage, event_loop)
        if catalog_info is not None:
            _append_catalog_record(path, storage, event_loop, metadata.world_size, *catalog_info)
    if barrier is not None:
        barrier.depart()


def _chain_len_for(plan: TakePlan) -> int:
    """The chain length a catalog-managed take records: 0 for a full
    snapshot, the base's + 1 for a catalog-resolved base, and 1 for an
    explicit base (its chain is not known on every rank alike; the
    rebase-to-full policy governs auto-selected chains only)."""
    if not plan.base:
        return 0
    if plan.base_chain_len >= 0:
        return plan.base_chain_len + 1
    return 1


def _note_chain_commit(path: str, catalog_info: Tuple[str, Optional[int], Optional[str], int]) -> None:
    """Make a just-committed ``job=`` snapshot its job's cached chain head
    on this rank, so the next take selects it without storage I/O."""
    if not knobs.is_catalog_enabled():
        return
    from . import catalog as catalog_mod

    try:
        split = catalog_mod.split_bucket(path)
        if split is not None:
            catalog_mod.note_commit(split[0], catalog_info[0], split[1], catalog_info[3])
    except Exception:  # noqa: BLE001 - a cache refresh never fails a take
        logger.debug("chain-cache refresh failed for %s", path, exc_info=True)


def _append_catalog_record(
    path: str,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    world_size: int,
    job: str,
    step: Optional[int],
    base: Optional[str],
    chain_len: int,
) -> None:
    """Rank 0's commit-time catalog append, fail-open: the snapshot is
    committed already, and a failed append only drops it from the chain and
    retention view until ``Catalog.rebuild``. The byte attribution comes
    from the snapshot's sidecars against the base's, with no collective."""
    if not knobs.is_catalog_enabled():
        return
    from . import catalog as catalog_mod

    try:
        split = catalog_mod.split_bucket(path)
        if split is None:
            logger.warning("snapshot %s has no parent bucket; catalog record skipped", path)
            return
        bucket, name = split
        total, written, deduped = catalog_mod.byte_attribution(storage, world_size, base, event_loop)
        if step is None:
            m = re.search(r"(\d+)$", name)
            step = int(m.group(1)) if m else -1
        base_field = None
        if base:
            bsplit = catalog_mod.split_bucket(base)
            base_field = bsplit[1] if bsplit and bsplit[0] == bucket else base
        record = catalog_mod.CatalogRecord(
            name=name,
            job=job,
            step=int(step),
            wall_time=time.time(),
            base=base_field,
            chain_len=chain_len,
            world_size=world_size,
            bytes_total=total,
            bytes_written=written,
            bytes_deduped=deduped,
        )
        with catalog_mod.Catalog(bucket, event_loop=event_loop) as cat:
            cat.append(record)
            _append_step_record(cat, storage, event_loop, world_size, job, int(step), name, base_field, chain_len)
    except Exception:  # noqa: BLE001 - fail-open by contract
        logger.warning(
            "catalog record for %s could not be appended (snapshot commit unaffected)",
            path,
            exc_info=True,
        )


def _append_step_record(
    cat: Any,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    world_size: int,
    job: str,
    step: int,
    name: str,
    base: Optional[str],
    chain_len: int,
) -> None:
    """Rank 0's step-telemetry record beside the catalog record: the
    per-rank artifacts (all written before the commit barrier) merged and
    rolled up. Fail-open on its own: it never takes the catalog record
    down, and the snapshot's artifacts can rebuild it."""
    if not (knobs.is_step_telemetry_enabled() and knobs.is_telemetry_artifacts_enabled()):
        return
    try:
        artifacts, problems = telemetry.aggregate.read_artifacts(storage, event_loop, world_size, op="take")
        if not artifacts:
            logger.warning("no telemetry artifacts readable for %s (%s); step record skipped", name, problems)
            return
        agg = telemetry.aggregate.aggregate(artifacts, world_size)
        record = telemetry.steprecord.build_step_record(
            job, step, name, agg, artifacts, base=base, chain_len=chain_len
        )
        cat.append_step_telemetry(record)
    except Exception:  # noqa: BLE001 - fail-open by contract
        logger.warning("step-telemetry record for %s could not be appended", name, exc_info=True)


def _gather_manifest(
    manifest: Manifest, coord: Coordinator
) -> Tuple[Manifest, Dict[str, dict], Optional[List[Dict[str, dict]]]]:
    """The global ``"<rank>/<logical_path>" -> Entry`` manifest, on every
    rank (one all_gather of the per-rank manifests), with this rank's and
    every rank's entry dicts (a plan-cache baseline). Replicated entries
    that slab batching relocated on their writer are made consistent."""
    if coord.get_world_size() == 1:
        global_manifest: Manifest = {f"0/{p}": e for p, e in manifest.items()}
        _check_shard_coverage(global_manifest)
        return global_manifest, {}, None
    local = {p: entry_to_dict(e) for p, e in manifest.items()}
    gathered = coord.all_gather_object(local)
    global_manifest = {}
    for r, m in enumerate(gathered):
        for p, d in m.items():
            global_manifest[f"{r}/{p}"] = entry_from_dict(d)
    consolidate_replicated_entries(global_manifest)
    # Every rank holds the same global manifest, so every rank raises.
    _check_shard_coverage(global_manifest)
    return global_manifest, local, gathered


def _check_shard_coverage(global_manifest: Manifest) -> None:
    problem = shard_coverage_problem(global_manifest)
    if problem is not None:
        raise RuntimeError(f"sharded entry does not tile its shape: {problem}")


def _read_checksum_sidecars(
    storage: StoragePlugin, world_size: int, event_loop: asyncio.AbstractEventLoop
) -> Tuple[Dict[str, Any], Dict[int, str]]:
    """Every rank's ``.checksums.<rank>`` merged, and the ranks whose
    sidecar exists but could not be read (a missing one is no error: that
    rank wrote nothing)."""
    merged: Dict[str, Any] = {}
    unreadable: Dict[int, str] = {}
    for rank in range(world_size):
        read_io = ReadIO(path=f"{CHECKSUM_FILE_PREFIX}{rank}")
        try:
            storage.sync_read(read_io, event_loop)
        except FileNotFoundError:
            continue
        except Exception as e:  # noqa: BLE001 - reported to the caller
            unreadable[rank] = repr(e)
            continue
        try:
            parsed = json.loads(bytes(read_io.buf).decode())
        except Exception as e:  # noqa: BLE001 - a corrupt sidecar body
            unreadable[rank] = f"unparseable: {e!r}"
            continue
        if not isinstance(parsed, dict):
            unreadable[rank] = f"unparseable: expected a JSON object, got {type(parsed).__name__}"
            continue
        merged.update(parsed)
    return merged, unreadable


def _matches_include(path: str, globs: List[str]) -> bool:
    """Whether a lazy restore's include list selects a logical path: a glob
    that fnmatches it, equals it, or names an ancestor (``"model/encoder"``
    selects its whole subtree)."""
    for g in globs:
        g = g.rstrip("/")
        if path == g or path.startswith(f"{g}/") or fnmatch.fnmatch(path, g):
            return True
    return False


def _uncovered_problem(location: str, unreadable: Dict[int, str]) -> str:
    """Why no sidecar covers ``location``: a per-rank object names its
    rank's sidecar when that one was unreadable; an object any rank may
    have written says which sidecars could not be read."""
    owner, _, _ = location.partition("/")
    if owner.isdigit():
        if int(owner) in unreadable:
            return "unverified (this rank's checksum sidecar was unreadable)"
        return "unverified (no checksum recorded)"
    if unreadable:
        ranks = ",".join(str(r) for r in sorted(unreadable))
        return (
            "unverified (uncovered by any readable sidecar; the sidecar of "
            f"rank(s) {ranks} was unreadable and may cover this object)"
        )
    return "unverified (no checksum recorded)"


def _framed_locations(manifest: Manifest) -> Set[str]:
    """Locations with a ``.ftab`` table: framed payloads and member-framed
    slabs."""

    def has_table(sub: Any) -> bool:
        return bool(getattr(sub, "frame_bytes", None)) or getattr(sub, "raw_range", None) is not None

    out: Set[str] = set()
    for entry in manifest.values():
        if getattr(entry, "location", None) and has_table(entry):
            out.add(entry.location)
        for chunk in getattr(entry, "chunks", None) or []:
            if has_table(chunk.tensor):
                out.add(chunk.tensor.location)
        for shard in getattr(entry, "shards", None) or []:
            if has_table(shard.tensor):
                out.add(shard.tensor.location)
    return out


async def _scrub_ftabs(
    storage: StoragePlugin, framed: Set[str], sizes: Dict[str, int], record: Callable[..., None]
) -> None:
    """Each table must parse and its frames sum to its payload's length:
    one node per table on a BACKGROUND engine."""

    async def check_one(loc: str) -> None:
        ftab_path = loc + FRAME_TABLE_SUFFIX
        read_io = ReadIO(path=ftab_path)
        try:
            await storage.read(read_io)
        except FileNotFoundError:
            record(ftab_path, "missing", f"frame table of {loc}")
            return
        except Exception as e:  # noqa: BLE001 - reported
            record(ftab_path, "unreadable", repr(e))
            return
        try:
            parsed = json.loads(bytes(read_io.buf).decode())
            frame_sizes = [int(x) for x in parsed["sizes"]]
            if parsed.get("member_framed") and len(frame_sizes) != len(parsed["raw_sizes"]):
                raise ValueError(f"{len(frame_sizes)} frames vs {len(parsed['raw_sizes'])} raw sizes")
        except Exception as e:  # noqa: BLE001 - a rotten table
            record(ftab_path, "ftab-mismatch", f"unparseable: {e!r}")
            return
        payload_size = sizes.get(loc)
        if payload_size is not None and sum(frame_sizes) != payload_size:
            record(
                ftab_path,
                "ftab-mismatch",
                f"frames sum to {sum(frame_sizes)} but payload is {payload_size} bytes",
            )
        else:
            record(ftab_path, "ok")

    nodes = [
        Node("ftab", lambda ctx, _p, loc=loc: check_one(loc), pool="io", stream="io", path=loc + FRAME_TABLE_SUFFIX)
        for loc in sorted(framed)
    ]
    await run_graph(nodes, budget_bytes=0, owner="scrub-ftab", kind="scrub", caps={"io": knobs.get_max_concurrent_io_for(storage)})


async def _scrub_repair(
    storage: StoragePlugin,
    entries: Dict[str, Dict[str, str]],
    digest_of: Callable[[str], Any],
    clean_by_content: Dict[Tuple[int, str], List[str]],
    corrupt_chunks: Dict[str, List[int]],
) -> Tuple[int, int]:
    """Rewrite corrupt or missing objects from a verified copy of the same
    content (only the bad chunks' extents for a v2 record), re-verifying
    the result; move corrupt objects without one to ``<path>.quarantined``.
    A crc-only record cannot prove a content match: never repaired.
    Returns (repaired, quarantined)."""
    cache = find_read_cache(storage)
    targets = [
        p for p, e in entries.items()
        if e["status"] in ("corrupt", "missing") and digest_of(p) is not None
    ]
    counts = {"repaired": 0, "quarantined": 0}

    async def repair_one(path: str) -> None:
        status = entries[path]["status"]
        rec = digest_of(path)
        size_want = hashing.record_size(rec)
        sources: List[str] = []
        if size_want is not None:
            for key in hashing.record_content_keys(rec):
                for src in clean_by_content.get((size_want, key), []):
                    if src != path and src not in sources:
                        sources.append(src)
        bad = corrupt_chunks.get(path)
        info = hashing.record_chunk_info(rec)
        healed = False
        for src in sources:
            try:
                if bad and info is not None and status == "corrupt":
                    cur = ReadIO(path=path)
                    await storage.read(cur)
                    data = bytearray(memoryview(cur.buf).cast("B"))
                    if len(data) != size_want:
                        raise ValueError(f"object is {len(data)} bytes now, recorded {size_want}")
                    grain = info[0]
                    for k in bad:
                        b, e = k * grain, min((k + 1) * grain, size_want)
                        rio = ReadIO(path=src, byte_range=(b, e))
                        await storage.read(rio)
                        data[b:e] = memoryview(rio.buf).cast("B")
                    how = f"chunk(s) {bad} patched from {src}"
                else:
                    rio = ReadIO(path=src)
                    await storage.read(rio)
                    data = bytes(memoryview(rio.buf).cast("B"))
                    how = f"rewritten from {src}"
                if hashing.verify_buffer(memoryview(data), rec) is not None:
                    continue  # the source rotted since the scan
                await storage.write(WriteIO(path=path, buf=bytes(data)))
            except Exception:  # noqa: BLE001 - try the next source
                logger.warning("scrub repair of %s from %s failed", path, src, exc_info=True)
                continue
            prior = entries[path]["detail"] or status
            entries[path] = {"status": "repaired", "detail": f"{how} (was: {prior})"}
            counts["repaired"] += 1
            healed = True
            break
        if healed:
            if cache is not None:
                cache.quarantine_path(path)
            return
        if status != "corrupt":
            return  # missing, and no copy: nothing to move aside
        try:
            read_io = ReadIO(path=path)
            await storage.read(read_io)
            await storage.write(WriteIO(path=f"{path}.quarantined", buf=bytes(read_io.buf)))
            await storage.delete(path)
        except Exception:  # noqa: BLE001 - reported, the scrub goes on
            logger.warning("could not quarantine corrupt object %s", path, exc_info=True)
            return
        if cache is not None:
            cache.quarantine_path(path)
        entries[path] = {
            "status": "quarantined",
            "detail": f"moved to {path}.quarantined ({entries[path]['detail']})",
        }
        counts["quarantined"] += 1

    # One node at a time, in path order, on a BACKGROUND engine.
    nodes = [Node("repair", lambda ctx, _p, path=path: repair_one(path), pool="io", path=path) for path in sorted(targets)]
    await run_graph(nodes, budget_bytes=0, owner="scrub-repair", kind="scrub", caps={"io": 1})
    return counts["repaired"], counts["quarantined"]


def _manifest_storage_locations(manifest: Manifest) -> Set[str]:
    locations: Set[str] = set()
    for entry in manifest.values():
        loc = getattr(entry, "location", None)
        if loc:
            locations.add(loc)
        for chunk in getattr(entry, "chunks", None) or []:
            locations.add(chunk.tensor.location)
        for shard in getattr(entry, "shards", None) or []:
            locations.add(shard.tensor.location)
    return locations


# ---------------------------------------------------------------------------
# Restore planning
# ---------------------------------------------------------------------------


def _wanted_framed_locations(entry: Entry, live: Any, budget: Optional[int]) -> List[str]:
    """Locations under ``entry`` whose ``.ftab`` this restore needs:
    compressed slab members (``raw_range``: the table is how a member's
    bytes are found) and framed payloads above the budget (sub-read by
    frame groups). A sharded entry's shards count only where they overlap
    the live DTensor's local shard, when there is one."""

    def wanted(sub: ArrayEntry) -> bool:
        if sub.raw_range is not None:
            return True
        return bool(
            budget is not None
            and sub.frame_bytes
            and array_nbytes(sub.shape, sub.dtype) > budget
        )

    out: List[str] = []
    if isinstance(entry, ArrayEntry) and wanted(entry):
        out.append(entry.location)
    for chunk in getattr(entry, "chunks", None) or []:
        if wanted(chunk.tensor):
            out.append(chunk.tensor.location)
    shards = getattr(entry, "shards", None) or []
    if shards:
        targets = None
        if is_dtensor(live):
            targets = [(o, z) for _t, o, z in alloc_target_shards(dtensor_leaf(live)).values()]
        for shard in shards:
            if not wanted(shard.tensor):
                continue
            if targets is not None and not any(
                overlap(shard.offsets, shard.sizes, o, z) is not None for o, z in targets
            ):
                continue
            out.append(shard.tensor.location)
    return out


def _fetch_frame_tables(
    entry_live_pairs: List[Tuple[Entry, Any]],
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    budget: Optional[int],
) -> Dict[str, Any]:
    """The ``.ftab`` tables a restore needs, by payload location: a
    compressed slab's ``{"sizes", "raw_sizes"}``, a framed payload's frame
    sizes. A missing or unreadable table degrades to whole-object reads,
    with a warning, never to a failed restore."""
    locations: Dict[str, None] = {}
    for entry, live in entry_live_pairs:
        for loc in _wanted_framed_locations(entry, live, budget):
            locations[loc] = None
    tables: Dict[str, Any] = {}
    if not locations:
        return tables

    async def fetch_one(loc: str) -> None:
        read_io = ReadIO(path=loc + FRAME_TABLE_SUFFIX)
        try:
            await storage.read(read_io)
            parsed = json.loads(bytes(read_io.buf).decode())
            if parsed.get("member_framed"):
                tables[loc] = {
                    "sizes": [int(x) for x in parsed["sizes"]],
                    "raw_sizes": [int(x) for x in parsed["raw_sizes"]],
                }
            else:
                tables[loc] = [int(x) for x in parsed["sizes"]]
        except Exception:  # noqa: BLE001 - degrade, don't fail
            logger.warning(
                "frame table %s%s unreadable; reading the whole object",
                loc, FRAME_TABLE_SUFFIX, exc_info=True,
            )

    async def fetch_all() -> None:
        sem = asyncio.Semaphore(knobs.get_max_concurrent_io_for(storage))

        async def bounded(loc: str) -> None:
            async with sem:
                await fetch_one(loc)

        await asyncio.gather(*(bounded(loc) for loc in locations))

    event_loop.run_until_complete(fetch_all())
    return tables


def _prepare_restore_one(
    logical_path: str,
    entry: Entry,
    live: Any,
    loaded: Dict[str, Any],
    device: Any,
    buffer_size_limit_bytes: Optional[int],
    h2d: d2h.HostToDevice,
    frame_tables: Optional[Dict[str, Any]] = None,
    digests: Optional[Dict[str, Any]] = None,
) -> Tuple[List[ReadReq], Optional[Callable[[], None]]]:
    """Plan the reads of one entry; returns (read_reqs, finalizer). The
    finalizer (run after the entry's last read) moves a filled pinned host
    buffer onto its CUDA device on ``h2d``'s stream; the buffer is
    allocated when the entry's first read arrives and released by the
    finalizer. A compressed entry is decoded into that host buffer.
    ``digests`` aligns a sharded entry's sub-reads to the sidecars' hash
    chunks, so each read covers whole chunks (verifiable, cacheable, and
    the need-aware swarm's unit)."""
    frame_tables = frame_tables or {}
    if isinstance(entry, ShardedArrayEntry) or (
        is_dtensor(live) and isinstance(entry, (ArrayEntry, ChunkedArrayEntry))
    ):
        return _prepare_sharded_restore(
            logical_path, entry, live, loaded, device, buffer_size_limit_bytes, h2d,
            frame_tables, digests,
        ), None
    if isinstance(entry, PrimitiveEntry):
        loaded[logical_path] = entry.get_value()
        return [], None
    if isinstance(entry, ObjectEntry):
        return ObjectIOPreparer.prepare_read(
            entry, lambda obj: loaded.__setitem__(logical_path, obj)
        ), None
    if not isinstance(entry, (ArrayEntry, ChunkedArrayEntry)):
        raise NotImplementedError(
            f"{logical_path}: {entry.type} entries are not supported by this package yet"
        )
    first = entry.chunks[0].tensor if isinstance(entry, ChunkedArrayEntry) else entry
    if first.serializer == Serializer.PICKLE:
        if isinstance(entry, ChunkedArrayEntry):
            # One pickled object per dim-0 chunk, each copied into its rows.
            dtype, shape = np.dtype(entry.dtype), tuple(int(s) for s in entry.shape)
            if not (
                isinstance(live, np.ndarray)
                and live.dtype == dtype
                and live.shape == shape
                and live.flags["WRITEABLE"]
            ):
                live = np.empty(shape, dtype=dtype)
            loaded[logical_path] = live
            return ChunkedArrayIOPreparer.prepare_pickled_read(entry, live), None
        nbytes = 1024 * 1024
        return [
            ReadReq(
                path=entry.location,
                buffer_consumer=PickledArrayConsumer(
                    nbytes, lambda obj: loaded.__setitem__(logical_path, obj)
                ),
                byte_range=tuple(entry.byte_range) if entry.byte_range else None,
            )
        ], None
    if entry.dtype in BYTE_VIEW_DTYPES:
        logger.warning(
            "%s: dtype %s has no torch counterpart; restored as uint8 "
            "(one stored byte per element)", logical_path, entry.dtype
        )
    dtype = string_to_dtype(entry.dtype)
    shape = tuple(int(s) for s in entry.shape)

    finalize = None
    if (
        isinstance(live, np.ndarray)
        and numpy_dtype_to_string(live.dtype) == entry.dtype
        and live.shape == shape
        and live.flags["C_CONTIGUOUS"]
        and live.flags["WRITEABLE"]
    ):
        loaded[logical_path] = live
        target = live.reshape(-1).view(np.uint8)
    else:
        dest = live.device if isinstance(live, torch.Tensor) else d2h.require_cuda(device)
        if _stages_through_host(dest):
            h2d.stream(dest)  # on this (the caller's) thread
            pinned: Dict[str, torch.Tensor] = {}

            def alloc() -> np.ndarray:
                pinned["host"] = torch.empty(shape, dtype=dtype, pin_memory=dest.type == "cuda")
                return pinned["host"].reshape(-1).view(torch.uint8).numpy()

            lazy = LazyHostTarget(alloc)

            def finalize() -> None:
                lazy.get()  # an entry with no bytes to read
                host = pinned.pop("host")
                lazy.release()
                # The caching host allocator keeps the block until the copy
                # that reads it has run.
                loaded[logical_path] = h2d.copy(host, live, dest)

        elif (
            isinstance(live, torch.Tensor)
            and live.dtype == dtype
            and tuple(live.shape) == shape
            and live.is_contiguous()
        ):
            host = live.detach()
            loaded[logical_path] = live
        else:
            host = torch.empty(shape, dtype=dtype)
            loaded[logical_path] = host
        target = lazy if finalize is not None else host.reshape(-1).view(torch.uint8).numpy()
    if isinstance(entry, ChunkedArrayEntry):
        reqs = ChunkedArrayIOPreparer.prepare_read(entry, target, buffer_size_limit_bytes, frame_tables)
    else:
        reqs = ArrayIOPreparer.prepare_read(
            entry, target, 0, buffer_size_limit_bytes, frame_tables.get(entry.location)
        )
    return reqs, finalize


class _ReadCountdown:
    """One entry's outstanding reads; runs the entry's finalizer, popped
    from the shared ``finalizers`` so it and its buffers go once it has
    run, when the last read has been consumed. Consumers finish on the
    restore's event loop (the caller's thread); the lock keeps the count
    right from any thread."""

    __slots__ = ("idx", "remaining", "finalizers", "lock")

    def __init__(self, idx: int, n_reads: int, finalizers: Dict[int, Callable[[], None]]) -> None:
        self.idx = idx
        self.remaining = n_reads
        self.finalizers = finalizers
        self.lock = threading.Lock()

    def __call__(self) -> None:
        with self.lock:
            self.remaining -= 1
            done = self.remaining == 0
        if done:
            self.finalizers.pop(self.idx)()


class _CountingConsumer:
    """Proxies one read's consumer, reports its completion to the entry's
    countdown, and drops the inner consumer (and its view of the entry's
    host buffer) once it has consumed."""

    def __init__(self, inner: Any, countdown: _ReadCountdown) -> None:
        self.inner = inner
        self.countdown = countdown
        # The read batcher keeps framed sub-reads unmerged by this flag.
        self.merge_exempt = getattr(inner, "merge_exempt", False)

    def read_into(self) -> Optional[memoryview]:
        return self.inner.read_into()

    async def consume_buffer(self, buf: Any, executor: Any = None) -> None:
        inner = self.inner
        await inner.consume_buffer(buf, executor)
        self.inner = None
        self.countdown()

    def get_consuming_cost_bytes(self) -> int:
        inner = self.inner
        return inner.get_consuming_cost_bytes() if inner is not None else 0


def _stages_through_host(dest: torch.device) -> bool:
    """Whether a whole entry for ``dest`` is read into a host buffer that
    its finalizer then copies onto the device (a CUDA device)."""
    return dest.type == "cuda"


def _target_device_types(live: Dict[str, Any], entries: Dict[str, Entry]) -> Set[str]:
    """Device types of the live tensor targets of ``entries`` (a DTensor's
    local shard's)."""
    types: Set[str] = set()
    for p in entries:
        v = live.get(p)
        if is_dtensor(v):
            v = v.to_local()
        if isinstance(v, torch.Tensor):
            types.add(v.device.type)
    return types


def _as_sharded(logical_path: str, entry: Entry) -> ShardedArrayEntry:
    """A sharded view of any raw array entry: a plain entry is one shard
    covering the array, a chunked entry's dim-0 chunks are its shards."""
    if isinstance(entry, ShardedArrayEntry):
        return entry
    if isinstance(entry, ChunkedArrayEntry):
        shards = entry.chunks
    else:
        shards = [Shard([0] * len(entry.shape), entry.shape, entry)]
    for shard in shards:
        if not is_raw_family(shard.tensor.serializer):
            raise NotImplementedError(
                f"{logical_path}: a {shard.tensor.serializer} entry cannot fill a DTensor"
            )
    return ShardedArrayEntry(entry.dtype, entry.shape, shards)


def _prepare_sharded_restore(
    logical_path: str,
    entry: Entry,
    live: Any,
    loaded: Dict[str, Any],
    device: Any,
    buffer_size_limit_bytes: Optional[int],
    h2d: d2h.HostToDevice,
    frame_tables: Dict[str, Any],
    digests: Optional[Dict[str, Any]] = None,
) -> List[ReadReq]:
    """Reads that fill, from the saved shards that overlap it, each target:
    the local shard of a live DTensor (in place), else the live tensor or a
    new one holding the whole array. K3 scatters the overlaps of CUDA
    targets on the card."""
    saved = _as_sharded(logical_path, entry)
    dtype = string_to_dtype(saved.dtype)
    shape = tuple(int(s) for s in saved.shape)
    if is_dtensor(live):
        leaf = dtensor_leaf(live)
        if leaf.global_shape != shape:
            raise ValueError(
                f"{logical_path}: saved shape {shape} does not match the live "
                f"DTensor's {leaf.global_shape}"
            )
        if leaf.local.dtype == dtype:
            loaded[logical_path] = live
        else:
            leaf = dataclasses.replace(
                leaf, local=torch.empty(leaf.local.shape, dtype=dtype, device=leaf.local.device)
            )
            loaded[logical_path] = assemble_dtensor(leaf, live)
        targets = list(alloc_target_shards(leaf).values())
    else:
        if (
            isinstance(live, torch.Tensor)
            and live.dtype == dtype
            and tuple(live.shape) == shape
        ):
            target = live.detach()
        else:
            dest = live.device if isinstance(live, torch.Tensor) else d2h.require_cuda(device)
            target = torch.empty(shape, dtype=dtype, device=dest)
        loaded[logical_path] = target
        targets = [(target, [0] * len(shape), list(shape))]
    for t, _, _ in targets:
        if t.device.type == "cuda":
            h2d.stream(t.device)  # on this (the caller's) thread
    return ShardedArrayIOPreparer.prepare_read(
        saved, targets, buffer_size_limit_bytes, digests, h2d, frame_tables
    )


# ---------------------------------------------------------------------------
# PendingSnapshot — async_take's handle
# ---------------------------------------------------------------------------


class PendingSnapshot:
    """Handle of an in-flight async snapshot: a background thread drains
    the transfers and writes, then runs the commit barrier around rank 0's
    ``.snapshot_metadata`` write (store traffic only, legal off the main
    thread). A failure on any rank fails every rank's ``wait()``."""

    def __init__(
        self,
        path: str,
        pending_io_work: PendingIOWork,
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        coord: Coordinator,
        barrier: Optional[LinearBarrier],
        prepared_entry: Optional[prepare_cache.PreparedTake] = None,
        catalog_info: Optional[Tuple[str, Optional[int], Optional[str], int]] = None,
        tm: Optional[telemetry.Telemetry] = None,
        tm_prev: Optional[telemetry.Telemetry] = None,
        phase_spans: Any = None,
    ) -> None:
        self.path = path
        # The async_take's session (closed, and its trace written, when the
        # commit ends) and its phase spans, for the artifact.
        self._tm = tm
        self._tm_prev = tm_prev
        self._phase_spans = phase_spans
        # (job, step, base, chain length) of a ``job=`` take.
        self._catalog_info = catalog_info
        self._pending_io_work = pending_io_work
        self._metadata = metadata
        self._coord = coord
        self._barrier = barrier
        # Released (its stagers unbound) once the drain ends, either way.
        self._prepared_entry = prepared_entry
        self._exc: Optional[BaseException] = None
        self._phase = "write"
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._complete,
            args=(storage, event_loop),
            daemon=True,
            name="tss-async-commit",
        )
        self._thread.start()

    def _complete(self, storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop) -> None:
        rank = self._coord.get_rank()
        try:
            self._pending_io_work.sync_complete(event_loop)
            # Before the barrier, like the sidecars; never in the stall.
            _persist_op_artifact(
                storage, event_loop, rank, self._coord.get_world_size(), "async_take", self._tm,
                self._phase_spans, self._pending_io_work.telemetry_io_summary(),
            )
            self._phase = "commit"
            with _barrier_stall_guard(rank):
                _commit(self._barrier, rank, self._metadata, storage, event_loop, self.path, self._catalog_info)
            if self._catalog_info is not None:
                _note_chain_commit(self.path, self._catalog_info)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            logger.error("async snapshot of %s failed on rank %d", self.path, rank, exc_info=True)
            telemetry.counter_add("snapshot.abort")
            if self._barrier is not None and not isinstance(e, BarrierError):
                try:
                    self._barrier.report_error(e, phase=self._phase)
                except Exception:  # noqa: BLE001 - reporting is best-effort
                    pass
            self._exc = e
        finally:
            try:
                prepare_cache.release(self._prepared_entry)
                self._prepared_entry = None
                storage.sync_close(event_loop)
            finally:
                event_loop.close()
                # The op's end on the fleet bus (store traffic, legal here).
                telemetry.fleet.note_op(None)
                _finish_telemetry(self._tm, self._tm_prev, rank)
                self._done.set()

    def wait(self) -> Snapshot:
        """Block until committed; raises :class:`CheckpointAbortedError`
        when any rank failed."""
        self._thread.join()
        e = self._exc
        if e is not None:
            if isinstance(e, BarrierError):
                raise CheckpointAbortedError(self.path, e.rank, e.phase, e.detail) from e
            raise CheckpointAbortedError(
                self.path, self._coord.get_rank(), self._phase, repr(e)
            ) from e
        snapshot = Snapshot(self.path, self._coord)
        snapshot._metadata = self._metadata
        return snapshot

    def done(self) -> bool:
        return self._done.is_set()

    def progress(self) -> Dict[str, Any]:
        """Live progress of the background drain, safe to poll from any
        thread: nondecreasing ``bytes_staged`` / ``bytes_written`` /
        ``requests_done`` (``bytes_written`` ends at the take's payload
        bytes), ``bytes_total`` / ``requests_total``, instantaneous and
        EWMA write rates, and ``eta_s`` (``ProgressTracker.snapshot``)."""
        return self._pending_io_work.progress_snapshot()

    @property
    def drain_stats(self) -> Dict[str, float]:
        """Accounting of the background drain (empty until it ends):
        wall_s, stage_busy_s, io_busy_s, overlap_s, idle_s, the
        stage_d2h_s / stage_serialize_s / stage_hash_s sub-streams, and for
        an incremental take bytes_deduped and objects_linked. Derived from
        the engine's intervals, which are the trace's scheduler spans."""
        return self._pending_io_work.drain_stats

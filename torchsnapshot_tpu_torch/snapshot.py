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
rank as :class:`CheckpointAbortedError` naming the rank and the phase, and
leaves no ``.snapshot_metadata``. A restore fills each rank's DTensors from
the saved bytes that overlap its local shards, whatever the saved world
size and placements were.

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

Devices: ``take``/``async_take`` stage CUDA tensors through the CUDA path
(D2H lanes, kernels K1 and K2); ``restore`` writes into each live tensor's
own device, and a leaf with no live tensor lands on ``device`` (default
``"cuda"``); ``read_object`` returns tensors on ``device`` (default
``"cuda"``). A CUDA request on a host without CUDA raises.

Error contracts: restoring a path that was never taken raises
``FileNotFoundError``; a missing path raises ``KeyError``; an app-state
value without ``state_dict``/``load_state_dict`` raises ``TypeError``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import fnmatch
import hashlib
import json
import logging
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import bcast as bcast_mod
from . import d2h, hashing, prepare_cache, scheduler
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
from .io_preparers.array import FRAME_TABLE_SUFFIX, ArrayIOPreparer, PickledArrayConsumer
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
)
from .rng_state import RNGState
from .engine import GraphExecutor, Node
from .scheduler import (
    CHECKSUM_FILE_PREFIX,
    MAX_CONCURRENT_IO,
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
# async_take (the async stall is their sum), for diagnostics.
LAST_TAKE_PHASES: Dict[str, float] = {}
# Whether this process's last take hit the plan cache and the
# prepared-take cache.
LAST_TAKE_CACHE: Dict[str, bool] = {}
# Drain stats of this process's last sync take (see
# PendingSnapshot.drain_stats).
LAST_SYNC_DRAIN_STATS: Dict[str, float] = {}
# This process's last restore: wall seconds, the read pipelines' totals
# (bytes_read, read_wall_s, requests), the broadcast and swarm records
# (``bcast.LAST_RESTORE_BCAST``, ``swarm.LAST_RESTORE_SWARM``) and the
# origin/peer/cache byte attribution (``attribution``).
LAST_RESTORE_STATS: Dict[str, Any] = {}


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
    """The exception a failed multi-rank operation raises: the failure is
    reported through ``barrier`` (which unblocks and fails every peer), a
    peer's earlier report names that peer, and the result is a
    :class:`CheckpointAbortedError`. A KeyboardInterrupt or SystemExit is
    reported but comes back as itself."""
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
        return CheckpointAbortedError(path, missing[0] if missing else None, phase, repr(e))
    return CheckpointAbortedError(path, rank, phase, repr(e))


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
    ) -> "Snapshot":
        """Write ``app_state`` to ``path`` and return when it is committed.
        ``replicated``: globs of logical paths whose plain tensors hold the
        same value on every rank (DDP state); they are written once.
        ``base``: an earlier snapshot to take incrementally against: each
        object byte-identical to one of the base's (size and sha256 or
        tree root from its sidecars) is hard-linked instead of rewritten,
        and any failure falls back to the write. The links share inodes,
        so the base may be deleted later. Near-free checkpoints when most
        state is frozen (partial fine-tunes, embedding-heavy models)."""
        _validate_app_state(app_state)
        coord = get_coordinator(coordinator)
        rank = coord.get_rank()
        plan = cls._plan_take(path, app_state, coord, replicated or [], base)
        path = plan.path
        barrier = cls._barrier(coord, "commit", path)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path)
        phase = ["plan"]
        try:
            pending, metadata = cls._take_impl(plan, coord, storage, event_loop, False, phase)
            pending.sync_complete(event_loop)
            LAST_SYNC_DRAIN_STATS.clear()
            LAST_SYNC_DRAIN_STATS.update(pending.drain_stats)
            phase[0] = "commit"
            _commit(barrier, rank, metadata, storage, event_loop)
            if barrier is not None:
                coord.note_external_barrier()
        except BaseException as e:
            if barrier is None:
                raise
            aborted = _abort_exception(path, barrier, rank, phase[0], e)
            if aborted is e:
                raise
            raise aborted from e
        finally:
            prepare_cache.release(plan.prepared_entry)
            storage.sync_close(event_loop)
            event_loop.close()
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
    ) -> "PendingSnapshot":
        """Return once the state is captured: CUDA tensors and the local
        shards of DTensors forked on the card (K2), CPU tensors and objects
        copied into private buffers. The caller may then mutate every
        tensor in place; the transfer, the writes and the commit run on a
        background thread (for ``base=``, the base's digests load there
        too)."""
        _validate_app_state(app_state)
        coord = get_coordinator(coordinator)
        rank = coord.get_rank()
        plan = cls._plan_take(path, app_state, coord, replicated or [], base)
        path = plan.path
        barrier = cls._barrier(coord, "async_commit", path)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path)
        phase = ["plan"]
        try:
            pending, metadata = cls._take_impl(plan, coord, storage, event_loop, True, phase)
        except BaseException as e:
            prepare_cache.release(plan.prepared_entry)
            storage.sync_close(event_loop)
            event_loop.close()
            if barrier is None:
                raise
            # Peers may already be draining: fail their commit too.
            aborted = _abort_exception(path, barrier, rank, phase[0], e)
            if aborted is e:
                raise
            raise aborted from e
        return PendingSnapshot(
            path, pending, metadata, storage, event_loop, coord, barrier, plan.prepared_entry
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
        phases: Dict[str, float] = {}
        t0 = time.monotonic()

        def phase(name: str) -> None:
            nonlocal t0
            t1 = time.monotonic()
            phases[name] = t1 - t0
            t0 = t1

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
        phase("preflight")
        return TakePlan(
            path=pf.path,
            base=pf.base,
            replicated_globs=pf.replicated_globs,
            flattened=flattened,
            manifest=manifest,
            rng_states=rng_states,
            fingerprint=fingerprint,
            cache_hit=pf.hit,
            cached=cached if pf.hit else None,
            failure=failure,
            phases=phases,
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
        ``phase_out[0]`` says how far it got ("plan", then "write"). The
        metadata is None on a non-zero rank of a plan-cache hit (only rank
        0 gathers the manifest then)."""
        rank, world_size = coord.get_rank(), coord.get_world_size()
        path = plan.path
        phases = dict(plan.phases)
        t0 = time.monotonic()

        def phase(name: str) -> None:
            nonlocal t0
            t1 = time.monotonic()
            phases[name] = t1 - t0
            t0 = t1

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

        try:
            if failure is not None:
                raise failure
            if knobs.get_compression() != "none":
                codec_versions = codec_library_versions()
            replicated_paths = {
                p for p in plan.flattened if any(fnmatch.fnmatch(p, g) for g in plan.replicated_globs)
            }
            if is_async:
                flattened, captured, ready = capture_flattened(plan.flattened)
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
                try:
                    local_manifest, write_reqs, assignment = prepared.rebind(
                        flattened, world_size, captured, ready
                    )
                except prepare_cache.RebindMismatch:
                    logger.warning("prepared-take rebind mismatch for %s; re-preparing", path, exc_info=True)
                    prepare_cache.release(prepared)
                    prepare_cache.invalidate(coord, prep_key)
                    plan.prepared_entry = prepared = None
            if prepared is None:
                leaf_index = {} if prep_key is not None else None
                local_manifest, write_reqs = prepare_write(
                    flattened, rank, world_size, replicated_paths, is_async, ready, captured, leaf_index
                )
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
        LAST_TAKE_CACHE.clear()
        LAST_TAKE_CACHE.update(plan_cache_hit=plan.cache_hit, prepared_cache_hit=prepared is not None)
        phase("plan")
        phase_out[0] = "write"
        base = plan.base
        if base and not knobs.is_dedup_digests_enabled(has_base=True):
            logger.warning(
                "base=%s ignored: incremental dedup needs dedup digests "
                "(TSS_TORCH_DEDUP_DIGESTS is off); taking a full snapshot",
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

        pending = sync_execute_write_reqs(
            write_reqs, storage, knobs.get_memory_budget_bytes(), rank, event_loop, base_loader
        )
        phase("stage_until_capture_point")
        for stateful, state in plan.rng_states.values():
            stateful.load_state_dict(state)
        phase("rng_restore")
        LAST_TAKE_PHASES.clear()
        LAST_TAKE_PHASES.update(phases)
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
        state may then be partly loaded. ``LAST_RESTORE_STATS`` holds this
        process's accounting of the restore."""
        _validate_app_state(app_state)
        coord = get_coordinator(coordinator or self._coordinator)
        rank = coord.get_rank()
        world = coord.get_world_size()
        barrier = self._barrier(coord, "restore", self.path)
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
            metadata = self._read_metadata(storage, event_loop)
            digests = self._load_digest_index(storage, metadata, event_loop)
            self._attach_cache_digests(storage, digests)
            manifest = get_manifest_for_rank(metadata, rank)
            phase = "restore.read"
            # RNG last, so loading other statefuls cannot perturb it.
            keys = sorted(app_state, key=lambda k: (isinstance(app_state[k], RNGState), k))
            for key in keys:
                stateful = app_state[key]
                _, live = flatten(stateful.state_dict(), prefix=key)
                state, stats = self._read_tree(
                    key, manifest, live, storage, event_loop, device, None,
                    include=include, modes=modes, digests=digests,
                )
                stateful.load_state_dict(state)
                totals["bytes_read"] += stats["bytes_read"]
                totals["read_wall_s"] += stats["wall_s"]
                totals["requests"] += stats["requests"]
            phase = "restore.barrier"
            if barrier is not None:
                barrier.arrive()
                barrier.depart()
                coord.note_external_barrier()
                # Every rank has read every broadcast and swarm payload.
                coord.collect_deferred()
            LAST_RESTORE_STATS.update(totals)
            LAST_RESTORE_STATS["wall_s"] = time.monotonic() - t0
            LAST_RESTORE_STATS["bcast"] = dict(bcast_mod.LAST_RESTORE_BCAST)
            LAST_RESTORE_STATS["swarm"] = dict(swarm_mod.LAST_RESTORE_SWARM)
            LAST_RESTORE_STATS["attribution"] = _restore_attribution(
                bcast_mod.LAST_RESTORE_BCAST, swarm_mod.LAST_RESTORE_SWARM, totals, storage
            )
        except BaseException as e:
            if barrier is None:
                raise
            aborted = _abort_exception(self.path, barrier, rank, phase, e)
            if aborted is e:
                raise
            raise aborted from e
        finally:
            storage.sync_close(event_loop)
            event_loop.close()

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
        budget = memory_budget_bytes or knobs.get_memory_budget_bytes()
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
            read_reqs.extend(reqs)
            if fin is not None:
                finalizers.append(fin)
        if bcast_items or swarm_items:
            with ThreadPoolExecutor(
                scheduler.POOL_THREADS, thread_name_prefix="tss-collective"
            ) as executor:
                bcast_mod.run_broadcast(bcast_items, storage, coord, event_loop, executor, digests)
                swarm_mod.run_swarm(
                    swarm_items, storage, coord, event_loop, executor, digests, swarm_need or None
                )
        read_reqs = batch_read_requests(
            read_reqs, max_merged_bytes=budget, merge_large=find_read_cache(storage) is not None
        )
        stats = sync_execute_read_reqs(read_reqs, storage, budget, event_loop, digests)
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
                memory_budget_bytes,
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
        means clean. Raises ``RuntimeError`` when objects exist but no
        sidecar does."""
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path)
        try:
            metadata = self._read_metadata(storage, event_loop)
            expected, unreadable = _read_checksum_sidecars(storage, metadata.world_size, event_loop)
            if unreadable:
                raise RuntimeError(f"checksum sidecars unreadable: {unreadable}")
            locations = _manifest_storage_locations(metadata.manifest)
            if not expected:
                if not locations:
                    return {}
                raise RuntimeError("snapshot has no checksum sidecars; nothing to verify")
            problems: Dict[str, str] = {
                loc: "unverified (no checksum recorded)"
                for loc in sorted(locations)
                if loc not in expected
            }

            async def check_all() -> None:
                sem = asyncio.Semaphore(MAX_CONCURRENT_IO)

                async def check(path: str, rec: Any) -> None:
                    async with sem:
                        read_io = ReadIO(path=path)
                        try:
                            await storage.read(read_io)
                        except FileNotFoundError:
                            problems[path] = "missing"
                            return
                        got = zlib.crc32(read_io.buf)
                        want = record_crc(rec)
                        if want is not None and got != want:
                            problems[path] = f"crc mismatch (recorded {want}, found {got})"

                await asyncio.gather(*(check(p, r) for p, r in sorted(expected.items())))

            event_loop.run_until_complete(check_all())
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

        budget = knobs.get_memory_budget_bytes()
        engine = GraphExecutor(budget, caps={"io": MAX_CONCURRENT_IO})
        hash_pool = ThreadPoolExecutor(scheduler.POOL_THREADS, thread_name_prefix="tss-scrub")

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

        for path in locations:
            want = digest_of(path)
            size = hashing.record_size(want)
            engine.add(
                Node(
                    "verify",
                    lambda ctx, _p, path=path, want=want: scan(path, want),
                    cost_bytes=min(size if size is not None else budget // 8, budget),
                    pool="io",
                    path=path,
                )
            )
        try:
            event_loop.run_until_complete(engine.run())
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


def _write_metadata(
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
) -> None:
    """Rank 0 writes ``.snapshot_metadata`` once every rank's data is
    written (arrive), and every rank returns only once it is visible
    (depart), so no rank can open the snapshot before it exists."""
    if barrier is not None:
        barrier.arrive()
    if rank == 0:
        _write_metadata(metadata, storage, event_loop)
    if barrier is not None:
        barrier.depart()


def _gather_manifest(
    manifest: Manifest, coord: Coordinator
) -> Tuple[Manifest, Dict[str, dict], Optional[List[Dict[str, dict]]]]:
    """The global ``"<rank>/<logical_path>" -> Entry`` manifest, on every
    rank (one all_gather of the per-rank manifests), with this rank's and
    every rank's entry dicts (a plan-cache baseline). Replicated entries
    that slab batching relocated on their writer are made consistent."""
    if coord.get_world_size() == 1:
        return {f"0/{p}": e for p, e in manifest.items()}, {}, None
    local = {p: entry_to_dict(e) for p, e in manifest.items()}
    gathered = coord.all_gather_object(local)
    global_manifest: Manifest = {}
    for r, m in enumerate(gathered):
        for p, d in m.items():
            global_manifest[f"{r}/{p}"] = entry_from_dict(d)
    consolidate_replicated_entries(global_manifest)
    return global_manifest, local, gathered


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
            merged.update(json.loads(bytes(read_io.buf).decode()))
        except FileNotFoundError:
            continue
        except Exception as e:  # noqa: BLE001 - reported to the caller
            unreadable[rank] = repr(e)
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
    """Each table must parse and its frames sum to its payload's length."""
    sem = asyncio.Semaphore(MAX_CONCURRENT_IO)

    async def check_one(loc: str) -> None:
        ftab_path = loc + FRAME_TABLE_SUFFIX
        async with sem:
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

    await asyncio.gather(*(check_one(loc) for loc in sorted(framed)))


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
    repaired = quarantined = 0
    targets = [
        p for p, e in entries.items()
        if e["status"] in ("corrupt", "missing") and digest_of(p) is not None
    ]
    for path in sorted(targets):
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
            repaired += 1
            healed = True
            break
        if healed:
            if cache is not None:
                cache.quarantine_path(path)
            continue
        if status != "corrupt":
            continue  # missing, and no copy: nothing to move aside
        try:
            read_io = ReadIO(path=path)
            await storage.read(read_io)
            await storage.write(WriteIO(path=f"{path}.quarantined", buf=bytes(read_io.buf)))
            await storage.delete(path)
        except Exception:  # noqa: BLE001 - reported, the scrub goes on
            logger.warning("could not quarantine corrupt object %s", path, exc_info=True)
            continue
        if cache is not None:
            cache.quarantine_path(path)
        entries[path] = {
            "status": "quarantined",
            "detail": f"moved to {path}.quarantined ({entries[path]['detail']})",
        }
        quarantined += 1
    return repaired, quarantined


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
        sem = asyncio.Semaphore(MAX_CONCURRENT_IO)

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
    finalizer (run after every read) moves a filled host buffer onto its
    CUDA device. A compressed entry is decoded into that host buffer.
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
            raise NotImplementedError(f"{logical_path}: chunked pickled arrays")
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
        if dest.type == "cuda":
            host = torch.empty(shape, dtype=dtype, pin_memory=True)

            def finalize() -> None:
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
        target = host.reshape(-1).view(torch.uint8).numpy()
    if isinstance(entry, ChunkedArrayEntry):
        reqs = ChunkedArrayIOPreparer.prepare_read(entry, target, buffer_size_limit_bytes, frame_tables)
    else:
        reqs = ArrayIOPreparer.prepare_read(
            entry, target, 0, buffer_size_limit_bytes, frame_tables.get(entry.location)
        )
    return reqs, finalize


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
            loaded[logical_path] = assemble_dtensor(leaf, live.device_mesh)
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
    ) -> None:
        self.path = path
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
            self._phase = "commit"
            _commit(self._barrier, rank, self._metadata, storage, event_loop)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            logger.error("async snapshot of %s failed on rank %d", self.path, rank, exc_info=True)
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

    @property
    def drain_stats(self) -> Dict[str, float]:
        """Accounting of the background drain (empty until it ends):
        wall_s, stage_busy_s, io_busy_s, overlap_s, idle_s, and for an
        incremental take bytes_deduped and objects_linked."""
        return self._pending_io_work.drain_stats

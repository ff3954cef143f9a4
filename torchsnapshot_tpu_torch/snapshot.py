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
import json
import logging
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import d2h
from .batcher import batch_read_requests, batch_write_requests
from .flatten import flatten, inflate
from .hashing import record_crc
from .io_preparer import (
    cuda_source,
    is_dtensor,
    as_leaves,
    capture_flattened,
    prepare_write,
)
from .io_preparers.array import ArrayIOPreparer, PickledArrayConsumer
from .io_preparers.chunked_array import ChunkedArrayIOPreparer
from .io_preparers.object import ObjectIOPreparer
from .io_preparers.sharded_array import (
    ShardedArrayIOPreparer,
    alloc_target_shards,
    assemble_dtensor,
    dtensor_leaf,
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
from .partitioner import consolidate_replicated_entries, partition_write_reqs_with_assignment
from .rng_state import RNGState
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
    ensure_uncompressed,
    numpy_dtype_to_string,
    string_to_dtype,
)
from .stateful import AppState
from .storage_plugin import url_to_storage_plugin
from .utils import knobs
from .version import __version__

logger = logging.getLogger(__name__)

# Wall seconds of the planning phases of this process's last take or
# async_take (the async stall is their sum), for diagnostics.
LAST_TAKE_PHASES: Dict[str, float] = {}


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
    ) -> "Snapshot":
        """Write ``app_state`` to ``path`` and return when it is committed.
        ``replicated``: globs of logical paths whose plain tensors hold the
        same value on every rank (DDP state); they are written once."""
        _validate_app_state(app_state)
        coord = get_coordinator(coordinator)
        rank = coord.get_rank()
        barrier = cls._barrier(coord, "commit", path)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path)
        phase = ["plan"]
        try:
            pending, metadata = cls._take_impl(
                path, app_state, replicated or [], coord, storage, event_loop, False, phase
            )
            pending.sync_complete(event_loop)
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
    ) -> "PendingSnapshot":
        """Return once the state is captured: CUDA tensors and the local
        shards of DTensors forked on the card (K2), CPU tensors and objects
        copied into private buffers. The caller may then mutate every
        tensor in place; the transfer, the writes and the commit run on a
        background thread."""
        _validate_app_state(app_state)
        coord = get_coordinator(coordinator)
        rank = coord.get_rank()
        barrier = cls._barrier(coord, "async_commit", path)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path)
        phase = ["plan"]
        try:
            pending, metadata = cls._take_impl(
                path, app_state, replicated or [], coord, storage, event_loop, True, phase
            )
        except BaseException as e:
            storage.sync_close(event_loop)
            event_loop.close()
            if barrier is None:
                raise
            # Peers may already be draining: fail their commit too.
            aborted = _abort_exception(path, barrier, rank, phase[0], e)
            if aborted is e:
                raise
            raise aborted from e
        return PendingSnapshot(path, pending, metadata, storage, event_loop, coord, barrier)

    @classmethod
    def _take_impl(
        cls,
        path: str,
        app_state: AppState,
        replicated: List[str],
        coord: Coordinator,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        is_async: bool,
        phase_out: List[str],
    ) -> Tuple[PendingIOWork, SnapshotMetadata]:
        """Plan the take and run its pipeline to the capture point;
        ``phase_out[0]`` says how far it got ("plan", then "write")."""
        rank, world_size = coord.get_rank(), coord.get_world_size()
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
        failure: Optional[Exception] = None
        try:
            manifest: Manifest = {}
            flattened: Dict[str, Any] = {}
            for key in sorted(app_state):
                sd = rng_states[key][1] if key in rng_states else app_state[key].state_dict()
                m, f = flatten(sd, prefix=key)
                manifest.update(m)
                flattened.update(f)
            flattened = as_leaves(flattened)
            replicated_paths = {
                p for p in flattened if any(fnmatch.fnmatch(p, g) for g in replicated)
            }
            phase("flatten")
            if is_async:
                flattened, captured, ready = capture_flattened(flattened)
            else:
                captured = set()
                sources = [cuda_source(v) for v in flattened.values()]
                devices = {t.device for t in sources if t is not None}
                ready = {dev: d2h.ready_event(dev) for dev in devices}
            phase("capture")
            local_manifest, write_reqs = prepare_write(
                flattened, rank, world_size, replicated_paths, is_async, ready, captured
            )
            manifest.update(local_manifest)
        except Exception as e:
            if world_size == 1:
                raise
            failure = e
        if world_size > 1:
            # Every rank learns of a planning failure anywhere before any
            # rank waits on the failed one's manifest.
            statuses = coord.all_gather_object(None if failure is None else repr(failure))
            failed = [r for r, st in enumerate(statuses) if st is not None]
            if failed:
                detail = statuses[failed[0]]
                raise CheckpointAbortedError(path, failed[0], "plan", detail) from (
                    failure if failure is not None else RuntimeError(detail)
                )
        write_reqs, _ = partition_write_reqs_with_assignment(manifest, write_reqs, coord)
        if knobs.is_batching_enabled():
            write_reqs = batch_write_requests(list(manifest.values()), write_reqs)
        metadata = SnapshotMetadata(
            version=__version__,
            world_size=world_size,
            manifest=_gather_manifest(manifest, coord),
        )
        phase("plan")
        phase_out[0] = "write"
        pending = sync_execute_write_reqs(
            write_reqs, storage, knobs.get_memory_budget_bytes(), rank, event_loop
        )
        for stateful, state in rng_states.values():
            stateful.load_state_dict(state)
        phase("stage_until_capture_point")
        LAST_TAKE_PHASES.clear()
        LAST_TAKE_PHASES.update(phases)
        return pending, metadata

    # --------------------------------------------------------------- restore
    def restore(
        self, app_state: AppState, device: Any = "cuda", coordinator: Optional[Coordinator] = None
    ) -> None:
        """Load every stateful of ``app_state`` from this snapshot, in place
        into live tensors where dtype and shape match. A live DTensor's
        local shard is filled from the saved bytes that overlap it, on its
        own device, whatever sharding the snapshot was saved with."""
        _validate_app_state(app_state)
        coord = get_coordinator(coordinator or self._coordinator)
        rank = coord.get_rank()
        barrier = self._barrier(coord, "restore", self.path)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path)
        phase = "restore.plan"
        try:
            manifest = get_manifest_for_rank(self._read_metadata(storage, event_loop), rank)
            phase = "restore.read"
            # RNG last, so loading other statefuls cannot perturb it.
            keys = sorted(app_state, key=lambda k: (isinstance(app_state[k], RNGState), k))
            for key in keys:
                self._load_stateful(key, app_state[key], manifest, storage, event_loop, device)
            phase = "restore.barrier"
            if barrier is not None:
                barrier.arrive()
                barrier.depart()
                coord.note_external_barrier()
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

    def _load_stateful(
        self,
        key: str,
        stateful: Any,
        manifest: Manifest,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        device: Any,
    ) -> None:
        _, live = flatten(stateful.state_dict(), prefix=key)
        stateful.load_state_dict(
            self._read_tree(key, manifest, live, storage, event_loop, device, None)
        )

    def _read_tree(
        self,
        logical_path: str,
        manifest: Manifest,
        live: Dict[str, Any],
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        device: Any,
        memory_budget_bytes: Optional[int],
    ) -> Any:
        """Read the leaf at ``logical_path``, or every leaf under it and
        rebuild the nested value. ``live`` maps logical paths to the tensors
        to fill in place."""
        prefix = f"{logical_path}/"
        scoped = {
            p: e for p, e in manifest.items() if p == logical_path or p.startswith(prefix)
        }
        if not scoped:
            raise KeyError(f"{logical_path!r} not found in snapshot {self.path!r}")
        budget = memory_budget_bytes or knobs.get_memory_budget_bytes()
        loaded: Dict[str, Any] = {}
        h2d = d2h.HostToDevice()
        read_reqs: List[ReadReq] = []
        finalizers: List[Callable[[], None]] = []
        for p, entry in scoped.items():
            if is_container_entry(entry):
                continue
            reqs, fin = _prepare_restore_one(p, entry, live.get(p), loaded, device, budget, h2d)
            read_reqs.extend(reqs)
            if fin is not None:
                finalizers.append(fin)
        read_reqs = batch_read_requests(read_reqs, max_merged_bytes=budget)
        sync_execute_read_reqs(read_reqs, storage, budget, event_loop)
        for fin in finalizers:
            fin()
        h2d.finish()
        containers = {p: e for p, e in scoped.items() if is_container_entry(e)}
        if not containers and logical_path in loaded:
            return loaded[logical_path]
        return inflate(containers, loaded, prefix=logical_path)

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
            manifest = get_manifest_for_rank(
                self._read_metadata(storage, event_loop), int(rank_str)
            )
            return self._read_tree(
                logical_path,
                manifest,
                {logical_path: obj_out},
                storage,
                event_loop,
                device,
                memory_budget_bytes,
            )
        finally:
            storage.sync_close(event_loop)
            event_loop.close()

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
            expected: Dict[str, Any] = {}
            for rank in range(metadata.world_size):
                read_io = ReadIO(path=f"{CHECKSUM_FILE_PREFIX}{rank}")
                try:
                    storage.sync_read(read_io, event_loop)
                except FileNotFoundError:
                    continue
                expected.update(json.loads(bytes(read_io.buf).decode()))
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


def _gather_manifest(manifest: Manifest, coord: Coordinator) -> Manifest:
    """The global ``"<rank>/<logical_path>" -> Entry`` manifest, on every
    rank (one all_gather of the per-rank manifests). Replicated entries
    that slab batching relocated on their writer are made consistent."""
    if coord.get_world_size() == 1:
        return {f"0/{p}": e for p, e in manifest.items()}
    gathered = coord.all_gather_object({p: entry_to_dict(e) for p, e in manifest.items()})
    global_manifest: Manifest = {}
    for r, m in enumerate(gathered):
        for p, d in m.items():
            global_manifest[f"{r}/{p}"] = entry_from_dict(d)
    consolidate_replicated_entries(global_manifest)
    return global_manifest


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


def _prepare_restore_one(
    logical_path: str,
    entry: Entry,
    live: Any,
    loaded: Dict[str, Any],
    device: Any,
    buffer_size_limit_bytes: int,
    h2d: d2h.HostToDevice,
) -> Tuple[List[ReadReq], Optional[Callable[[], None]]]:
    """Plan the reads of one entry; returns (read_reqs, finalizer). The
    finalizer (run after every read) moves a filled host buffer onto its
    CUDA device."""
    if isinstance(entry, ShardedArrayEntry) or (
        is_dtensor(live) and isinstance(entry, (ArrayEntry, ChunkedArrayEntry))
    ):
        return _prepare_sharded_restore(
            logical_path, entry, live, loaded, device, buffer_size_limit_bytes, h2d
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
    ensure_uncompressed(first.serializer, logical_path)
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
        reqs = ChunkedArrayIOPreparer.prepare_read(entry, target, buffer_size_limit_bytes)
    else:
        reqs = ArrayIOPreparer.prepare_read(entry, target, 0, buffer_size_limit_bytes)
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
        if shard.tensor.serializer != Serializer.RAW:
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
    buffer_size_limit_bytes: int,
    h2d: d2h.HostToDevice,
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
    return ShardedArrayIOPreparer.prepare_read(saved, targets, buffer_size_limit_bytes, None, h2d)


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
    ) -> None:
        self.path = path
        self._pending_io_work = pending_io_work
        self._metadata = metadata
        self._coord = coord
        self._barrier = barrier
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
        """Overlap accounting of the background drain (empty until it
        ends): wall_s, stage_busy_s, io_busy_s, overlap_s, idle_s."""
        return self._pending_io_work.drain_stats

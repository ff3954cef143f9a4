"""``Snapshot``: take, restore, read and verify checkpoints of torch state.

Single process (world size 1), local filesystem. The on-disk format is the
JAX package's, byte for byte: ``.snapshot_metadata`` (JSON manifest),
``.checksums.0`` (per-object digests) and the object layout
(``0/<logical path>``, ``<path>.chunk_<row>``, ``batched/<uuid>`` slabs
with ``byte_range``), so a snapshot written by either package restores
through the other.

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
from .io_preparer import capture_flattened, prepare_write
from .io_preparers.array import ArrayIOPreparer, PickledArrayConsumer
from .io_preparers.chunked_array import ChunkedArrayIOPreparer
from .io_preparers.object import ObjectIOPreparer
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO
from .manifest import (
    SNAPSHOT_METADATA_FNAME,
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    Manifest,
    ObjectEntry,
    PrimitiveEntry,
    SnapshotMetadata,
    get_manifest_for_rank,
    is_container_entry,
)
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


class Snapshot:
    """A reference to a persisted snapshot at ``path``::

        Snapshot.take("/ckpt/step_1000", {"model": model, "optim": optim})
        Snapshot("/ckpt/step_1000").restore({"model": model, "optim": optim})
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._metadata: Optional[SnapshotMetadata] = None

    # ------------------------------------------------------------------ take
    @classmethod
    def take(
        cls, path: str, app_state: AppState, replicated: Optional[List[str]] = None
    ) -> "Snapshot":
        """Write ``app_state`` to ``path`` and return when it is committed."""
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path)
        try:
            pending, metadata = cls._take_impl(
                path, app_state, replicated or [], storage, event_loop, False
            )
            pending.sync_complete(event_loop)
            _write_metadata(metadata, storage, event_loop)
        finally:
            storage.sync_close(event_loop)
            event_loop.close()
        snapshot = cls(path)
        snapshot._metadata = metadata
        return snapshot

    @classmethod
    def async_take(
        cls, path: str, app_state: AppState, replicated: Optional[List[str]] = None
    ) -> "PendingSnapshot":
        """Return once the state is captured: CUDA tensors forked on the
        card (K2), CPU tensors and objects copied into private buffers. The
        caller may then mutate every tensor in place; the transfer, the
        writes and the commit run on a background thread."""
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(path)
        try:
            pending, metadata = cls._take_impl(
                path, app_state, replicated or [], storage, event_loop, True
            )
        except BaseException:
            storage.sync_close(event_loop)
            event_loop.close()
            raise
        return PendingSnapshot(path, pending, metadata, storage, event_loop)

    @classmethod
    def _take_impl(
        cls,
        path: str,
        app_state: AppState,
        replicated: List[str],
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        is_async: bool,
    ) -> Tuple[PendingIOWork, SnapshotMetadata]:
        _validate_app_state(app_state)
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
        for key in sorted(app_state):
            sd = rng_states[key][1] if key in rng_states else app_state[key].state_dict()
            m, f = flatten(sd, prefix=key)
            manifest.update(m)
            flattened.update(f)
        replicated_paths = {
            p for p in flattened if any(fnmatch.fnmatch(p, g) for g in replicated)
        }
        phase("flatten")
        if is_async:
            flattened, captured, ready = capture_flattened(flattened)
        else:
            captured = set()
            ready = {
                dev: d2h.ready_event(dev)
                for dev in {
                    v.device for v in flattened.values()
                    if isinstance(v, torch.Tensor) and v.device.type == "cuda"
                }
            }
        phase("capture")
        local_manifest, write_reqs = prepare_write(
            flattened, 0, replicated_paths, is_async, ready, captured
        )
        manifest.update(local_manifest)
        if knobs.is_batching_enabled():
            write_reqs = batch_write_requests(list(manifest.values()), write_reqs)
        metadata = SnapshotMetadata(
            version=__version__,
            world_size=1,
            manifest={f"0/{p}": e for p, e in manifest.items()},
        )
        phase("plan")
        pending = sync_execute_write_reqs(
            write_reqs, storage, knobs.get_memory_budget_bytes(), 0, event_loop
        )
        for stateful, state in rng_states.values():
            stateful.load_state_dict(state)
        phase("stage_until_capture_point")
        LAST_TAKE_PHASES.clear()
        LAST_TAKE_PHASES.update(phases)
        return pending, metadata

    # --------------------------------------------------------------- restore
    def restore(self, app_state: AppState, device: Any = "cuda") -> None:
        """Load every stateful of ``app_state`` from this snapshot, in place
        into live tensors where dtype and shape match."""
        _validate_app_state(app_state)
        event_loop = asyncio.new_event_loop()
        storage = url_to_storage_plugin(self.path)
        try:
            manifest = get_manifest_for_rank(self._read_metadata(storage, event_loop), 0)
            # RNG last, so loading other statefuls cannot perturb it.
            keys = sorted(app_state, key=lambda k: (isinstance(app_state[k], RNGState), k))
            for key in keys:
                self._load_stateful(key, app_state[key], manifest, storage, event_loop, device)
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
        h2d = _HostToDevice()
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
        """One persisted value — or a manifest subtree, rebuilt — addressed
        as ``"<rank>/<logical_path>"``. Tensors land on ``device``, or in
        ``obj_out`` in place when it matches."""
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


class _HostToDevice:
    """T2 for one restore: per device, one copy stream that first waits for
    the caller's stream (the live tensors may still be in use) and that the
    caller's stream waits for at the end."""

    def __init__(self) -> None:
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def copy(self, host: torch.Tensor, live: Any, device: torch.device) -> torch.Tensor:
        stream = self._streams.get(device)
        if stream is None:
            stream = d2h.side_stream(device, "h2d")
            stream.wait_stream(torch.cuda.current_stream(device))
            self._streams[device] = stream
        return d2h.host_to_device(host, live if isinstance(live, torch.Tensor) else None, device, stream)

    def finish(self) -> None:
        for device, stream in self._streams.items():
            torch.cuda.current_stream(device).wait_stream(stream)
            # The pinned sources are released once the copies have run.
            stream.synchronize()


def _prepare_restore_one(
    logical_path: str,
    entry: Entry,
    live: Any,
    loaded: Dict[str, Any],
    device: Any,
    buffer_size_limit_bytes: int,
    h2d: _HostToDevice,
) -> Tuple[List[ReadReq], Optional[Callable[[], None]]]:
    """Plan the reads of one entry; returns (read_reqs, finalizer). The
    finalizer (run after every read) moves a filled host buffer onto its
    CUDA device."""
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


# ---------------------------------------------------------------------------
# PendingSnapshot — async_take's handle
# ---------------------------------------------------------------------------


class PendingSnapshot:
    """Handle of an in-flight async snapshot: a background thread drains
    the transfers and writes, then commits ``.snapshot_metadata``."""

    def __init__(
        self,
        path: str,
        pending_io_work: PendingIOWork,
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
    ) -> None:
        self.path = path
        self._pending_io_work = pending_io_work
        self._metadata = metadata
        self._exc: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._complete,
            args=(storage, event_loop),
            daemon=True,
            name="tss-async-commit",
        )
        self._thread.start()

    def _complete(self, storage: StoragePlugin, event_loop: asyncio.AbstractEventLoop) -> None:
        try:
            self._pending_io_work.sync_complete(event_loop)
            _write_metadata(self._metadata, storage, event_loop)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            logger.error("async snapshot of %s failed", self.path, exc_info=True)
            self._exc = e
        finally:
            try:
                storage.sync_close(event_loop)
            finally:
                event_loop.close()
                self._done.set()

    def wait(self) -> Snapshot:
        self._thread.join()
        if self._exc is not None:
            raise RuntimeError(f"async snapshot of {self.path} failed") from self._exc
        snapshot = Snapshot(self.path)
        snapshot._metadata = self._metadata
        return snapshot

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def drain_stats(self) -> Dict[str, float]:
        """Overlap accounting of the background drain (empty until it
        ends): wall_s, stage_busy_s, io_busy_s, overlap_s, idle_s."""
        return self._pending_io_work.drain_stats

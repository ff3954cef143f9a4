"""The write and read pipelines, lowered onto the engine (``engine/``).

Write: each request becomes a ``stage -> io`` chain (stage: D2H +
serialize into a host buffer; io: hash + storage write, concurrently), or
one ``stream`` node for a streamable request of at least two stream
chunks: the storage append of one chunk overlaps the staging of the next,
at most ``STREAM_INFLIGHT`` chunks deep. Whether a pipeline streams at all
is decided once, by measurement (``stream_select``). The staged bytes of
every object are digested into the ``.checksums.<rank>`` sidecar, written
before the caller commits ``.snapshot_metadata`` (none under
``TSS_TORCH_CHECKSUMS=0``: the objects are then written unhashed).

Incremental takes (``base_loader``): the base's digests load lazily, on
the first write (in an async take's background drain, never in its
stall). Each object is then hashed before its write; when its size and a
content key match a base object (by path, or by content for slabs, whose
paths are new each take) the storage plugin links the base's file in
(``link_in``) instead of writing, and any refusal falls back to the write.
Such a take never streams: dedup needs the digest before the write.

Read: each request becomes a ``read -> consume`` chain (fetch a byte
range; copy it into its target), budgeted by the consumer's cost. With
the snapshot's sidecar digests and ``TSS_TORCH_VERIFY_READS=all``, each
fetch is verified on the host before it is consumed (so before any H2D):
a whole object against its record, a range against the v2 chunks it
covers. A mismatch quarantines any read-cache entry of the path and
re-fetches once; a second one raises :class:`ReadVerificationError`.

QoS: every pipeline carries the ambient class (``engine.Priority``, set
by :func:`~.engine.qos.priority_scope`; an async take's drain keeps the
class it was planned under): a FOREGROUND restore
pauses a BACKGROUND drain's next admission (and a streamed write's next
chunk) through the process-wide arbiter. Under ``TSS_TORCH_DEBUG_LEDGER``
each pipeline asserts its budget balanced at close and on every abort
path (``ledger.LedgerLeakError`` names a leak's site).

Telemetry: the engine records one interval per node (and per streamed
chunk), which is both the drain statistics and, with a session active,
the ``scheduler.stage`` / ``scheduler.io`` / ``scheduler.stream_chunk`` /
``scheduler.read_io`` / ``scheduler.consume`` spans; the staging
sub-streams (``stage.d2h``, ``stage.serialize``, ``stage.hash``) and the
pinned allocations (``stage.pin_alloc``) come from the pipeline's
:class:`~.d2h.StageTimes`. For a session that asked for it, each pipeline
runs the interpreter-lock probe (``telemetry.hostprobe``, ``host.gil_wait``
spans) from its first run to its end, aborts included; an async take's
probe so covers its capture and its whole drain. A write pipeline feeds a
:class:`~.telemetry.ProgressTracker` (``PendingSnapshot.progress()``,
the ``progress.*`` gauges, the fleet beacons and the stall watchdog) and
ends with the ``scheduler.*`` counters; :meth:`PendingIOWork.telemetry_io_summary`
is what the persisted artifact takes from it.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import logging
import os
import socket
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import d2h, hashing, stream_select, telemetry
from .telemetry import hostprobe
from .engine import GraphExecutor, Node
from .engine.intervals import clip_merged, measure, merge_intervals, stream_stats
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq
from .storage_plugins import memory as memory_store
from .storage_plugins.cloud_retry import CollectiveProgress, is_transient_os_error, retry_transient
from .utils import knobs

logger = logging.getLogger(__name__)


class ReadVerificationError(RuntimeError):
    """A fetched object's bytes did not match the snapshot's recorded
    digest twice: the first fetch and one verified re-fetch (with any
    read-cache entry of the path quarantined between them). Persistent
    corruption at the source; the restore aborts instead of loading bad
    bytes into live state."""


CHECKSUM_FILE_PREFIX = ".checksums."  # one JSON sidecar per rank
_STAGE_POOLS = ("staging", "streaming")
# The per-rank staging budget: this share of the host's available memory,
# split among the ranks sharing the host, and at most this many bytes.
_AVAILABLE_MEMORY_MULTIPLIER = 0.6
_MAX_PER_RANK_MEMORY_BUDGET_BYTES = 32 * 1024**3


def derive_local_world_size(coordinator: Any = None) -> int:
    """Ranks sharing this host (one disk, one pool of RAM). With a
    coordinator of several processes: a hostname gather to rank 0 and a
    broadcast of the list back, cached in ``knobs.set_local_world_size``
    (every rank calls this at the same program point, gated on the world
    size only). Without one (or at world size 1): the cached value of the
    last gather, else ``LOCAL_WORLD_SIZE``, else 1."""
    if coordinator is None or coordinator.get_world_size() <= 1:
        return knobs.get_local_world_size()
    gathered = coordinator.gather_object(socket.gethostname(), dst=0)
    hostnames = coordinator.broadcast_object(gathered, src=0)
    local_world_size = max(1, hostnames.count(socket.gethostname()))
    knobs.set_local_world_size(local_world_size)
    return local_world_size


def _mem_available_bytes() -> int:
    """``MemAvailable`` of ``/proc/meminfo``: free pages plus the page cache
    and slab the kernel can reclaim."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def get_process_memory_budget_bytes(coordinator: Any = None, writes_to: Optional[StoragePlugin] = None) -> int:
    """Host bytes one rank's pipeline may hold staged at once:
    ``min(0.6 x available / local world size, 32 GiB)``, or
    ``TSS_TORCH_PER_RANK_MEMORY_BUDGET_BYTES`` verbatim. Available is
    ``MemAvailable``, and for a take that ``writes_to`` the memory store
    also the store's recycled buffers, which its copies fill instead of
    new pages (any other operation's pages are new). The local world size
    is derived (and cached, for the I/O caps and the hash width) even when
    the budget is overridden, so every rank runs the same collective."""
    local_world_size = derive_local_world_size(coordinator)
    override = knobs.get_memory_budget_override_bytes()
    if override is not None:
        return override
    available = _mem_available_bytes()
    if isinstance(writes_to, memory_store.MemoryStoragePlugin):
        available += memory_store.recycled_bytes()
    budget = int(available * _AVAILABLE_MEMORY_MULTIPLIER / local_world_size)
    return min(budget, _MAX_PER_RANK_MEMORY_BUDGET_BYTES)


def _chunk_size_bucket(nbytes: int) -> str:
    """Size bucket of the per-chunk append-latency histograms."""
    if nbytes <= 1 << 20:
        return "le1m"
    if nbytes <= 8 << 20:
        return "le8m"
    if nbytes <= 64 << 20:
        return "le64m"
    return "gt64m"


class PipelinePools:
    """Thread pools of one operation, created on first use; the hash pool
    ``hash_workers`` wide."""

    def __init__(self, hash_workers: int) -> None:
        self.hash_workers = hash_workers
        self._staging: Optional[ThreadPoolExecutor] = None
        self._hash: Optional[ThreadPoolExecutor] = None
        self._lanes: Optional[d2h.TransferLanes] = None

    def staging_executor(self) -> ThreadPoolExecutor:
        if self._staging is None:
            self._staging = ThreadPoolExecutor(knobs.get_staging_threads(), thread_name_prefix="tss-stage")
        return self._staging

    def hash_executor(self) -> ThreadPoolExecutor:
        if self._hash is None:
            self._hash = ThreadPoolExecutor(self.hash_workers, thread_name_prefix="tss-hash")
        return self._hash

    def transfer_lanes(self) -> d2h.TransferLanes:
        if self._lanes is None:
            self._lanes = d2h.TransferLanes(knobs.get_d2h_lanes(), knobs.get_d2h_window_bytes())
        return self._lanes

    def shutdown(self) -> None:
        for pool in (self._staging, self._hash, self._lanes):
            if pool is not None:
                pool.shutdown()
        self._staging = self._hash = self._lanes = None


class _WritePipeline:
    def __init__(
        self,
        write_reqs: List[WriteReq],
        storage: StoragePlugin,
        memory_budget_bytes: int,
        rank: int,
        base_loader: Optional[Callable[[], Optional[Tuple[str, Dict[str, Any]]]]] = None,
        hash_workers: Optional[int] = None,
    ) -> None:
        self.storage = storage
        self.rank = rank
        self.pools = PipelinePools(hash_workers or knobs.get_hash_workers())
        # Chunk jobs in flight per hashed object: twice the pool's width.
        self._hash_inflight = 2 * self.pools.hash_workers
        self.checksums: Dict[str, object] = {}
        self._write_reqs = write_reqs
        # Resolved once: a deferred background drain must not re-read knobs
        # whose environment changed since the take was planned.
        self._checksums_on = knobs.is_checksums_enabled()
        self._want_sha = knobs.is_dedup_digests_enabled(has_base=base_loader is not None)
        self._grain = knobs.get_hash_chunk_bytes()
        self._stream_chunk = knobs.get_stream_chunk_bytes()
        self._stream_inflight = knobs.get_stream_inflight()
        self._stream_on = stream_select.resolve(storage)
        self._label = stream_select.storage_label(storage)
        # The base: (root, {path: record}, {(size, key): path}) once loaded.
        self._base_loader = base_loader
        self._base_resolved = base_loader is None
        self._base_lock: Optional[asyncio.Lock] = None
        self._base: Optional[tuple] = None
        # A base with v1 records needs a whole-object sha256 of each new
        # object too, or nothing would match.
        self._base_needs_whole_sha = False
        self.bytes_deduped = 0
        self.objects_linked = 0
        self.bytes_staged = 0
        self._staging_ctx: Optional[d2h.StagingContext] = None
        # The session is captured here: the drain of an async take runs on
        # its commit thread, and staging and hashing on executor threads.
        self._tm = telemetry.get_active()
        self.times = d2h.StageTimes(tm=self._tm)
        self._probe: Optional[hostprobe.HostProbe] = None
        # Live progress: totals start as the staging-cost estimates and
        # converge on the staged bytes.
        self.progress = telemetry.ProgressTracker()
        self.progress.set_totals(
            requests=len(write_reqs),
            bytes_=sum(r.buffer_stager.get_staging_cost_bytes() for r in write_reqs),
        )
        telemetry.fleet.set_progress(self.progress)
        self.io_cap = knobs.get_max_concurrent_io_for(storage)
        self._engine = GraphExecutor(
            memory_budget_bytes,
            caps={"staging": None, "streaming": self.io_cap, "io": self.io_cap},
            task_context=self._staging_scope,
            kind="write",
            span_prefix="scheduler",
            rank=rank,
            owner=f"write@rank{rank}",
            progress=self.progress,
            bytes_done=lambda: self.bytes_staged,
        )
        # Accounting windows (one per run): the capture point, the drain.
        self.windows: List[Tuple[float, float]] = []
        self.drain_stats: Dict[str, float] = {}
        self.pipeline_stats: Dict[str, float] = {}
        # Big requests first: they dominate the critical path and admit
        # small ones into the leftover budget.
        for req in sorted(write_reqs, key=lambda r: -r.buffer_stager.get_staging_cost_bytes()):
            self._add_request(req)

    def _lanes(self) -> d2h.TransferLanes:
        lanes = self.pools.transfer_lanes()
        lanes.times = self.times
        return lanes

    def start_d2h_hints(self) -> None:
        """Eager D2H: submit the device-to-host copy of every deferred
        request (this rank's share, after partition) to the transfer lanes;
        a request that will stream submits its first chunk only."""
        lanes = self._lanes()
        for req in self._write_reqs:
            if req.defer_staging:
                req.buffer_stager.start_d2h_hint(lanes, stream=self._stream_eligible(req))

    @contextlib.contextmanager
    def _staging_scope(self):
        """Makes the pipeline's transfer lanes visible to stagers (and the
        tasks they spawn) through ``d2h.get_active()``."""
        if self._staging_ctx is None:
            self._staging_ctx = d2h.StagingContext(self._lanes(), self.times)
        token = d2h.activate(self._staging_ctx)
        try:
            yield
        finally:
            d2h.deactivate(token)

    def _stream_eligible(self, req: WriteReq) -> bool:
        """Streams when this pipeline streams at all, the plugin can, the
        take has no base (dedup needs the whole object's digest before its
        write), and a second chunk exists to overlap with."""
        stager = req.buffer_stager
        return (
            self._stream_on
            and self.storage.supports_streaming
            and self._base_loader is None
            and stager.get_staging_cost_bytes() >= 2 * self._stream_chunk
            and stager.can_stream()
        )

    def _add_request(self, req: WriteReq) -> None:
        stager = req.buffer_stager
        cost = stager.get_staging_cost_bytes()
        if self._stream_eligible(req):
            if not stager.stream_holds_full_buffer:
                # Admitted at its steady-state footprint: the stream's
                # depth in chunks.
                cost = min(cost, self._stream_inflight * self._stream_chunk)
            self._engine.add(
                Node(
                    "stream",
                    # It records its chunks' intervals itself (staging:
                    # stream_chunk, appends: io).
                    lambda ctx, _p, req=req: self._stream_one(ctx, req),
                    cost_bytes=cost,
                    pool="streaming",
                    path=req.path,
                    deferred=req.defer_staging,
                )
            )
            return
        io = Node("io", lambda ctx, buf, req=req: self._write_one(req.path, buf), pool="io", stream="io", path=req.path)
        self._engine.add(
            Node(
                "stage",
                lambda ctx, _p, req=req: self._stage_one(ctx, req),
                cost_bytes=cost,
                pool="staging",
                stream="stage",
                path=req.path,
                deferred=req.defer_staging,
                successor=io,
            )
        )

    async def _stage_one(self, ctx, req: WriteReq):
        t0 = time.monotonic()
        cost = req.buffer_stager.get_staging_cost_bytes()
        buf = await req.buffer_stager.stage_buffer(self.pools.staging_executor())
        stream_select.note_whole_stage(self._label, time.monotonic() - t0)
        nbytes = memoryview(buf).nbytes
        ctx.recost(nbytes)
        self.bytes_staged += nbytes
        self.progress.note_staged(nbytes, estimate=cost)
        return buf

    def _note_written(self, nbytes: int) -> None:
        self.progress.note_written(nbytes)
        self.progress.note_request_done()

    async def _storage_write(self, write_io: WriteIO) -> None:
        """One whole-buffer write, timed into the streaming scorecard."""
        t0 = time.monotonic()
        await self.storage.write(write_io)
        stream_select.note_whole(
            self._label, memoryview(write_io.buf).nbytes, time.monotonic() - t0
        )

    async def _resolve_base(self) -> None:
        """Load the base's digests once (on the hash pool), and index them
        by content so an object can match a base object at another path."""
        if self._base_lock is None:
            self._base_lock = asyncio.Lock()
        async with self._base_lock:
            if self._base_resolved:
                return
            loop = asyncio.get_running_loop()
            loaded = await loop.run_in_executor(self.pools.hash_executor(), self._base_loader)
            if loaded is not None:
                root, digests = loaded
                by_content: Dict[Tuple[Any, str], str] = {}
                for k, v in digests.items():
                    size = hashing.record_size(v)
                    for key in hashing.record_content_keys(v):
                        by_content.setdefault((size, key), k)
                self._base = (root, digests, by_content)
                self._base_needs_whole_sha = any(isinstance(v, list) for v in digests.values())
            self._base_resolved = True

    async def _link_from_base(self, path: str, digest: Any) -> bool:
        """Link the base object byte-identical to this one (size and a
        content key) in at ``path``; False when none is, or the link
        failed."""
        keys = hashing.record_content_keys(digest)
        if not keys:
            return False
        size = hashing.record_size(digest)
        root, digests, by_content = self._base
        rec = digests.get(path)
        if rec is not None and hashing.record_size(rec) == size and set(keys) & set(hashing.record_content_keys(rec)):
            src = path  # the same object at the same path
        else:
            src = next((by_content[(size, k)] for k in keys if (size, k) in by_content), None)
        if src is None or not await self.storage.link_in(os.path.join(root, src), path):
            return False
        self.bytes_deduped += size
        self.objects_linked += 1
        return True

    async def _write_one(self, path: str, buf) -> None:
        await self._write_object(path, buf)
        self._note_written(memoryview(buf).nbytes)

    async def _write_object(self, path: str, buf) -> None:
        loop = asyncio.get_running_loop()
        if not self._checksums_on:
            await self._storage_write(WriteIO(path=path, buf=buf))
            return
        if not self._base_resolved:
            await self._resolve_base()
        if self._base is not None:
            # The digest decides link or write, so it comes first.
            digest = await hashing.hash_buffer(
                memoryview(buf), self._grain, self._want_sha, loop, self.pools.hash_executor(),
                want_whole_sha=self._base_needs_whole_sha, times=self.times, path=path,
                max_inflight=self._hash_inflight,
            )
            self.checksums[path] = digest
            if not await self._link_from_base(path, digest):
                await self._storage_write(WriteIO(path=path, buf=buf))
            return
        mv = memoryview(buf).cast("B")
        if not (self._grain > 0 and mv.nbytes > self._grain):
            # A v1 record: a plugin that hashes while it writes (the native
            # fs engine) returns the crc, and only the sha256 is left here.
            write_io = WriteIO(path=path, buf=buf, want_digest=True)
            await self._storage_write(write_io)
            digest = write_io.digest_out
            if digest is None:
                digest = await loop.run_in_executor(
                    self.pools.hash_executor(), hashing.serial_digest, mv, self._want_sha, self.times, path
                )
            elif self._want_sha:
                times = self.times

                def sha256() -> str:
                    t0 = time.monotonic()
                    out = hashlib.sha256(mv).hexdigest()
                    times.record("hash", t0, time.monotonic(), path=path, nbytes=mv.nbytes)
                    return out

                sha = await loop.run_in_executor(self.pools.hash_executor(), sha256)
                digest = [digest[0], digest[1], sha]
            self.checksums[path] = digest
            return
        digest = asyncio.ensure_future(
            hashing.hash_buffer(
                mv, self._grain, self._want_sha, loop, self.pools.hash_executor(), times=self.times, path=path,
                max_inflight=self._hash_inflight,
            )
        )
        try:
            await self._storage_write(WriteIO(path=path, buf=buf))
        except BaseException:
            digest.cancel()
            await asyncio.gather(digest, return_exceptions=True)
            raise
        self.checksums[path] = await digest

    async def _stream_one(self, ctx, req: WriteReq) -> None:
        """Stage chunks and append them in order: the next chunk's staging
        overlaps this chunk's append (a one-chunk queue between the two);
        a failure aborts the storage stream, so no partial object lands."""
        loop = asyncio.get_running_loop()
        hasher = None
        if self._checksums_on:
            hasher = hashing.make_stream_hasher(
                self._grain, self._want_sha, loop, self.pools.hash_executor(), times=self.times, path=req.path,
                max_inflight=self._hash_inflight,
            )
        totals = {"bytes": 0, "chunks": 0}
        stream = await self.storage.write_stream(req.path)
        # One chunk in staging, one being appended, the rest queued.
        queue: asyncio.Queue = asyncio.Queue(maxsize=max(1, self._stream_inflight - 2))
        end = object()

        async def produce() -> None:
            agen = req.buffer_stager.stage_chunks(self.pools.staging_executor())
            try:
                while True:
                    # A higher class arriving mid-stream pauses the next
                    # chunk, not the stream.
                    await ctx.preemption_point()
                    t0 = time.monotonic()
                    try:
                        buf = await agen.__anext__()
                    except StopAsyncIteration:
                        break
                    nbytes = memoryview(buf).nbytes
                    ctx.record_interval("stream_chunk", t0, "stage", req.path, nbytes)
                    stream_select.note_stream_stage(self._label, time.monotonic() - t0)
                    self.progress.note_staged(nbytes)
                    totals["chunks"] += 1
                    await queue.put(buf)
            finally:
                await agen.aclose()
            await queue.put(end)

        async def consume() -> None:
            while True:
                buf = await queue.get()
                if buf is end:
                    return
                if hasher is not None:
                    await hasher.feed(buf)
                nbytes = memoryview(buf).nbytes
                t0 = time.monotonic()
                await stream.append(buf)
                append_s = time.monotonic() - t0
                ctx.record_interval("io", t0, "io", req.path, nbytes)
                stream_select.note_streamed(self._label, nbytes, append_s)
                if self._tm is not None:
                    self._tm.metrics.histogram(
                        f"storage.{self._label}.append_s.{_chunk_size_bucket(nbytes)}"
                    ).observe(append_s)
                totals["bytes"] += nbytes
                self.progress.note_written(nbytes)

        tasks = [asyncio.ensure_future(produce()), asyncio.ensure_future(consume())]
        try:
            await asyncio.gather(*tasks)
            t0 = time.monotonic()
            await stream.commit()
            ctx.record_interval("io", t0, "io", req.path, 0)
        except BaseException:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            if hasher is not None:
                hasher.abort()
            await stream.abort()
            raise
        self.bytes_staged += totals["bytes"]
        # A streamed request learns its size at its end.
        self.progress.adjust_total_bytes(totals["bytes"] - req.buffer_stager.get_staging_cost_bytes())
        self.progress.note_request_done()
        telemetry.counter_add("scheduler.stream_chunks", totals["chunks"])
        if hasher is not None:
            self.checksums[req.path] = await hasher.finalize()

    def _start_probe(self) -> None:
        if self._probe is None:
            self._probe = hostprobe.start_for(self._tm)

    def _stop_probe(self) -> None:
        if self._probe is not None:
            self._probe.stop()

    async def run_until_staged(self) -> None:
        """Run until every non-deferred request's bytes are held privately
        (the capture point of an async take)."""
        self._start_probe()
        t0 = time.monotonic()
        try:
            await self._engine.run(until=lambda: self._engine.unfinished_in(_STAGE_POOLS) == 0)
        except BaseException:
            self.pools.shutdown()
            self._stop_probe()
            # The engine swept its reservations: a ledger leak raises here,
            # chained onto the failure.
            self._engine.assert_balanced("write pipeline abort")
            raise
        finally:
            self.windows.append((t0, time.monotonic()))
        self._publish_progress()

    async def run_to_completion(self) -> None:
        self._start_probe()
        t0 = time.monotonic()
        try:
            self._engine.release_deferred()
            await self._engine.run()
            sidecar = f"{CHECKSUM_FILE_PREFIX}{self.rank}"
            if self.checksums:
                payload = json.dumps(self.checksums, sort_keys=True).encode()
                t_io = time.monotonic()
                await self.storage.write(WriteIO(path=sidecar, buf=payload))
                self._engine.record_interval("io", t_io, time.monotonic(), "io", sidecar, len(payload))
            else:
                # No object this take: a stale sidecar from an earlier take
                # at this path would make verify() report corruption.
                with contextlib.suppress(FileNotFoundError):
                    await self.storage.delete(sidecar)
        except BaseException:
            self._engine.assert_balanced("write pipeline abort")
            raise
        finally:
            self.pools.shutdown()
            self._stop_probe()
            self.windows.append((t0, time.monotonic()))
        # Every debit (admissions, re-costs) credited back at close.
        self._engine.assert_balanced("write pipeline close")
        drain_window = self.windows[-1]
        stage, io = self._engine.intervals["stage"], self._engine.intervals["io"]
        self.drain_stats = stream_stats([drain_window], stage, io)
        self.pipeline_stats = stream_stats(self.windows, stage, io)
        # stage_busy decomposed into its sub-streams (lanes overlap them,
        # so their sum may exceed stage_busy_s).
        for kind, ivs in self.times.intervals().items():
            merged = merge_intervals(ivs)
            self.drain_stats[f"stage_{kind}_s"] = measure(clip_merged(merged, *drain_window))
            self.pipeline_stats[f"stage_{kind}_s"] = sum(
                measure(clip_merged(merged, w0, w1)) for w0, w1 in self.windows
            )
        for stats in (self.drain_stats, self.pipeline_stats):
            stats["bytes_deduped"] = self.bytes_deduped
            stats["objects_linked"] = self.objects_linked
            stats["hash_workers"] = self.pools.hash_workers
        self._publish_progress()
        telemetry.gauge_max("scheduler.budget_hwm_bytes", self._engine.budget.high_water_bytes)
        telemetry.counter_add("scheduler.bytes_staged", self.bytes_staged)
        if self.bytes_deduped:
            telemetry.counter_add("scheduler.bytes_deduped", self.bytes_deduped)

    def _publish_progress(self) -> None:
        """The progress counters as gauges of the session (and so of the
        persisted artifact)."""
        tm = self._tm
        if tm is None:
            return
        p = self.progress
        tm.metrics.gauge("progress.bytes_staged").set(p.bytes_staged)
        tm.metrics.gauge("progress.bytes_written").set(p.bytes_written)
        tm.metrics.gauge("progress.requests_done").set(p.requests_done)


class PendingIOWork:
    """The rest of a write pipeline after the capture point."""

    def __init__(self, pipeline: _WritePipeline) -> None:
        self._pipeline = pipeline

    async def complete(self) -> None:
        await self._pipeline.run_to_completion()

    def sync_complete(self, event_loop: asyncio.AbstractEventLoop) -> None:
        event_loop.run_until_complete(self.complete())

    @property
    def budget_balanced(self) -> bool:
        """True when every budget debit has been credited back: after a
        drain, and after an aborted one."""
        return self._pipeline._engine.budget.balanced

    @property
    def progress(self) -> "telemetry.ProgressTracker":
        """The pipeline's live counters (monotonic; readable from any
        thread while the drain runs)."""
        return self._pipeline.progress

    @property
    def drain_stats(self) -> Dict[str, float]:
        """Stream overlap of the drain (the run after the capture point):
        ``wall_s``, ``stage_busy_s``, ``io_busy_s``, ``overlap_s``,
        ``idle_s``, the ``stage_<kind>_s`` sub-streams, and the dedup
        counts; derived from the intervals the trace's spans record. Also
        ``hash_workers``, the hash pool's width."""
        return dict(self._pipeline.drain_stats)

    @property
    def pipeline_stats(self) -> Dict[str, float]:
        """The same over the whole pipeline (capture point and drain)."""
        return dict(self._pipeline.pipeline_stats)

    def progress_snapshot(self) -> Dict[str, Any]:
        """Counters with rates and an ETA (``ProgressTracker.snapshot``)."""
        return self._pipeline.progress.snapshot()

    def telemetry_io_summary(self) -> Dict[str, Any]:
        """What the persisted artifact takes from this pipeline once it is
        complete: overlap stats, merged intervals and accounting windows
        (monotonic seconds; the artifact rebases them), byte and request
        counts."""
        p = self._pipeline
        counters = p.progress.counters()
        return {
            "pipeline_stats_s": {k: v for k, v in p.pipeline_stats.items() if k.endswith("_s")},
            "drain_stats_s": {k: v for k, v in p.drain_stats.items() if k.endswith("_s")},
            "bytes": {
                "staged": p.bytes_staged,
                "written": counters["bytes_written"],
                "total": counters["bytes_total"],
                "deduped": p.bytes_deduped,
            },
            "requests": {"done": counters["requests_done"], "total": counters["requests_total"]},
            "windows": list(p.windows),
            "stage_intervals": merge_intervals(p._engine.intervals["stage"]),
            "io_intervals": merge_intervals(p._engine.intervals["io"]),
            "stage_substreams": {k: merge_intervals(v) for k, v in p.times.intervals().items()},
            # QoS pause episodes, so preemption waves outlive the live metrics.
            "engine": {
                "preemptions": p._engine.preemptions,
                "preempted_wait_s": round(p._engine.preempted_wait_s, 6),
                "pause_intervals": list(p._engine.pause_intervals),
            },
        }


def sync_execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    event_loop: asyncio.AbstractEventLoop,
    base_loader: Optional[Callable[[], Optional[Tuple[str, Dict[str, Any]]]]] = None,
    on_built: Optional[Callable[[_WritePipeline], None]] = None,
    hash_workers: Optional[int] = None,
) -> PendingIOWork:
    """Run the write pipeline to its capture point; the returned handle
    finishes the rest (deferred staging and every write). ``base_loader``
    returns an incremental take's base as ``(root, {path: record})``, or
    None to write everything. ``on_built`` runs on the pipeline before it
    starts (an async take's eager D2H). ``hash_workers``: the hash pool's
    width (default ``knobs.get_hash_workers()``)."""
    return event_loop.run_until_complete(
        execute_write_reqs(write_reqs, storage, memory_budget_bytes, rank, base_loader, on_built, hash_workers)
    )


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    base_loader: Optional[Callable[[], Optional[Tuple[str, Dict[str, Any]]]]] = None,
    on_built: Optional[Callable[[_WritePipeline], None]] = None,
    hash_workers: Optional[int] = None,
) -> PendingIOWork:
    """:func:`sync_execute_write_reqs` on the running event loop."""
    pipeline = _WritePipeline(write_reqs, storage, memory_budget_bytes, rank, base_loader, hash_workers)
    if on_built is not None:
        on_built(pipeline)
    await pipeline.run_until_staged()
    return PendingIOWork(pipeline)


def _read_digest_record(digests: Optional[Dict[str, Any]], path: str) -> Any:
    """The sidecar record of ``path`` (v1 list or v2 dict), or None when
    there is none or it records no size (a legacy bare crc)."""
    if not digests:
        return None
    rec = digests.get(path)
    return rec if hashing.record_size(rec) is not None else None


async def fetch_read_io(
    storage: StoragePlugin,
    path: str,
    byte_range: Optional[Tuple[int, int]],
    progress: CollectiveProgress,
    into: Optional[memoryview] = None,
) -> ReadIO:
    """One storage fetch of ``path`` (optionally ranged, optionally into
    the caller's buffer): the one fetch of the read pipeline, the broadcast
    and the swarm restores. Transient OSErrors retry under the caller's
    collective-progress window; each attempt starts from an empty buffer
    (or overwrites ``into`` from offset 0)."""
    read_io = ReadIO(path=path, byte_range=byte_range, into=into)

    async def attempt() -> None:
        read_io.buf = None
        await storage.read(read_io)

    await retry_transient(attempt, is_transient_os_error, progress, "read_pipeline")
    return read_io


def _verify_checker(
    want: Any, byte_range: Optional[Tuple[int, int]]
) -> Optional[Callable[[memoryview], Optional[str]]]:
    """The check (run on an executor thread) of one fetch, or None when
    nothing of it is verifiable: a whole object against its whole record,
    a range of a v2 record against every chunk the range fully contains
    (a v1 record cannot verify a range)."""
    size = hashing.record_size(want)
    if byte_range is None or (size is not None and tuple(byte_range) == (0, size)):
        return lambda mv: hashing.verify_buffer(mv, want)
    begin, end = byte_range
    if hashing.range_verifiable(want, begin, end):
        return lambda mv: hashing.verify_range(mv, want, begin, end)
    return None


async def verified_fetch(
    storage: StoragePlugin,
    path: str,
    byte_range: Optional[Tuple[int, int]],
    checker: Optional[Callable[[memoryview], Optional[str]]],
    executor: Any,
    progress: CollectiveProgress,
    into: Optional[memoryview] = None,
    what: str = "read",
    failure_counter: str = "scheduler.read_verify_failures",
) -> ReadIO:
    """Fetch, and with a ``checker`` verify on ``executor``: a mismatch
    quarantines the path's read-cache entries and re-fetches once; a
    second mismatch raises :class:`ReadVerificationError`. Each mismatch
    counts in ``failure_counter``."""
    read_io = await fetch_read_io(storage, path, byte_range, progress, into)
    if checker is None:
        return read_io
    loop = asyncio.get_running_loop()
    problem = await loop.run_in_executor(executor, checker, memoryview(read_io.buf))
    if problem is None:
        return read_io
    telemetry.counter_add(failure_counter)
    logger.warning(
        "%s of %s failed digest verification (%s); quarantining cache "
        "entries and re-fetching once", what, path, problem,
    )
    from .storage_plugins.cache import find_read_cache

    cache = find_read_cache(storage)
    if cache is not None:
        await loop.run_in_executor(executor, cache.quarantine_path, path)
    read_io = await fetch_read_io(storage, path, byte_range, progress, into)
    problem = await loop.run_in_executor(executor, checker, memoryview(read_io.buf))
    if problem is not None:
        telemetry.counter_add(failure_counter)
        raise ReadVerificationError(
            f"{what} of {path} failed digest verification twice ({problem}); "
            "persistent corruption at the source, aborting instead of "
            "restoring bad bytes"
        )
    return read_io


async def execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    executor: ThreadPoolExecutor,
    digests: Optional[Dict[str, Any]] = None,
) -> Dict[str, float]:
    """Run the read graph; returns ``{"bytes_read", "wall_s",
    "requests"}``. ``digests`` (the snapshot's merged sidecars) turns on
    verification under ``TSS_TORCH_VERIFY_READS=all``."""
    t0 = time.monotonic()
    verify = knobs.is_origin_read_verify_enabled() and bool(digests)
    totals = {"bytes_read": 0}
    # One retry window for every fetch of this pipeline.
    read_progress = CollectiveProgress()
    engine = GraphExecutor(
        memory_budget_bytes,
        caps={"io": knobs.get_max_concurrent_io_for(storage), "consume": knobs.get_consuming_threads()},
        kind="read",
        span_prefix="scheduler",
        owner="read",
        bytes_done=lambda: totals["bytes_read"],
    )

    async def fetch(ctx, _payload, req: ReadReq):
        into = req.buffer_consumer.read_into() if req.byte_range is not None else None
        want = _read_digest_record(digests, req.path) if verify else None
        checker = _verify_checker(want, req.byte_range) if want is not None else None
        read_io = await verified_fetch(
            storage, req.path, req.byte_range, checker, executor, read_progress, into
        )
        nbytes = memoryview(read_io.buf).nbytes
        totals["bytes_read"] += nbytes
        ctx.note_bytes(nbytes)
        return read_io.buf

    async def consume(_ctx, buf, req: ReadReq) -> None:
        await req.buffer_consumer.consume_buffer(buf, executor)

    for req in sorted(read_reqs, key=lambda r: -r.buffer_consumer.get_consuming_cost_bytes()):
        engine.add(
            Node(
                "read_io",
                lambda ctx, p, req=req: fetch(ctx, p, req),
                cost_bytes=req.buffer_consumer.get_consuming_cost_bytes(),
                pool="io",
                stream="io",
                path=req.path,
                successor=Node(
                    "consume",
                    lambda ctx, buf, req=req: consume(ctx, buf, req),
                    pool="consume",
                    stream="stage",
                    path=req.path,
                ),
            )
        )
    probe = hostprobe.start_for(telemetry.get_active())
    try:
        await engine.run()
    except BaseException:
        engine.assert_balanced("read pipeline abort")
        raise
    finally:
        if probe is not None:
            probe.stop()
    engine.assert_balanced("read pipeline close")
    telemetry.counter_add("scheduler.bytes_read", totals["bytes_read"])
    telemetry.gauge_max("scheduler.budget_hwm_bytes", engine.budget.high_water_bytes)
    return {
        "bytes_read": float(totals["bytes_read"]),
        "wall_s": time.monotonic() - t0,
        "requests": float(len(read_reqs)),
    }


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    event_loop: asyncio.AbstractEventLoop,
    digests: Optional[Dict[str, Any]] = None,
) -> Dict[str, float]:
    with ThreadPoolExecutor(knobs.get_consuming_threads(), thread_name_prefix="tss-consume") as ex:
        return event_loop.run_until_complete(
            execute_read_reqs(read_reqs, storage, memory_budget_bytes, ex, digests)
        )

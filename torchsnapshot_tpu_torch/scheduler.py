"""The write and read pipelines, lowered onto the engine (``engine/``).

Write: each request becomes a ``stage -> io`` chain (stage: D2H +
serialize into a host buffer; io: hash + storage write, concurrently), or
one ``stream`` node for a streamable request of at least two stream
chunks: the storage append of one chunk overlaps the staging of the next,
at most ``STREAM_INFLIGHT`` chunks deep. Whether a pipeline streams at all
is decided once, by measurement (``stream_select``). The staged bytes of
every object are digested into the ``.checksums.<rank>`` sidecar, written
before the caller commits ``.snapshot_metadata``.

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
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import d2h, hashing, stream_select
from .engine import GraphExecutor, Node
from .engine.intervals import stream_stats
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq
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
# Pool widths (the JAX package's defaults): staging, hashing and consuming
# threads, and storage operations in flight per pipeline.
POOL_THREADS = 4
MAX_CONCURRENT_IO = 16


class PipelinePools:
    """Thread pools of one operation, created on first use."""

    def __init__(self) -> None:
        self._staging: Optional[ThreadPoolExecutor] = None
        self._hash: Optional[ThreadPoolExecutor] = None
        self._lanes: Optional[d2h.TransferLanes] = None

    def staging_executor(self) -> ThreadPoolExecutor:
        if self._staging is None:
            self._staging = ThreadPoolExecutor(POOL_THREADS, thread_name_prefix="tss-stage")
        return self._staging

    def hash_executor(self) -> ThreadPoolExecutor:
        if self._hash is None:
            self._hash = ThreadPoolExecutor(POOL_THREADS, thread_name_prefix="tss-hash")
        return self._hash

    def transfer_lanes(self) -> d2h.TransferLanes:
        if self._lanes is None:
            self._lanes = d2h.TransferLanes()
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
    ) -> None:
        self.storage = storage
        self.rank = rank
        self.pools = PipelinePools()
        self.checksums: Dict[str, object] = {}
        # Resolved once: a deferred background drain must not re-read knobs
        # whose environment changed since the take was planned.
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
        self._staging_ctx: Optional[d2h.StagingContext] = None
        self._engine = GraphExecutor(
            memory_budget_bytes,
            caps={"staging": None, "streaming": MAX_CONCURRENT_IO, "io": MAX_CONCURRENT_IO},
            task_context=self._staging_scope,
        )
        self.drain_stats: Dict[str, float] = {}
        # Big requests first: they dominate the critical path and admit
        # small ones into the leftover budget.
        for req in sorted(write_reqs, key=lambda r: -r.buffer_stager.get_staging_cost_bytes()):
            self._add_request(req)

    @contextlib.contextmanager
    def _staging_scope(self):
        """Makes the pipeline's transfer lanes visible to stagers (and the
        tasks they spawn) through ``d2h.get_active()``."""
        if self._staging_ctx is None:
            self._staging_ctx = d2h.StagingContext(self.pools.transfer_lanes())
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
            self._engine.add(
                Node(
                    "stream",
                    lambda ctx, _p, req=req: self._stream_one(req),
                    # Admitted at its steady-state footprint: the stream's
                    # depth in chunks.
                    cost_bytes=min(cost, self._stream_inflight * self._stream_chunk),
                    pool="streaming",
                    stream="io",
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
        buf = await req.buffer_stager.stage_buffer(self.pools.staging_executor())
        stream_select.note_whole_stage(self._label, time.monotonic() - t0)
        ctx.recost(memoryview(buf).nbytes)
        return buf

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
        loop = asyncio.get_running_loop()
        if not self._base_resolved:
            await self._resolve_base()
        if self._base is not None:
            # The digest decides link or write, so it comes first.
            digest = await hashing.hash_buffer(
                memoryview(buf), self._grain, self._want_sha, loop, self.pools.hash_executor(),
                want_whole_sha=self._base_needs_whole_sha,
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
                    self.pools.hash_executor(), hashing.serial_digest, mv, self._want_sha
                )
            elif self._want_sha:
                sha = await loop.run_in_executor(
                    self.pools.hash_executor(), lambda: hashlib.sha256(mv).hexdigest()
                )
                digest = [digest[0], digest[1], sha]
            self.checksums[path] = digest
            return
        digest = asyncio.ensure_future(
            hashing.hash_buffer(
                mv, self._grain, self._want_sha, loop, self.pools.hash_executor()
            )
        )
        try:
            await self._storage_write(WriteIO(path=path, buf=buf))
        except BaseException:
            digest.cancel()
            await asyncio.gather(digest, return_exceptions=True)
            raise
        self.checksums[path] = await digest

    async def _stream_one(self, req: WriteReq) -> None:
        """Stage chunks and append them in order: the next chunk's staging
        overlaps this chunk's append (a one-chunk queue between the two);
        a failure aborts the storage stream, so no partial object lands."""
        loop = asyncio.get_running_loop()
        hasher = hashing.make_stream_hasher(
            self._grain, self._want_sha, loop, self.pools.hash_executor()
        )
        stream = await self.storage.write_stream(req.path)
        # One chunk in staging, one being appended, the rest queued.
        queue: asyncio.Queue = asyncio.Queue(maxsize=max(1, self._stream_inflight - 2))
        end = object()

        async def produce() -> None:
            agen = req.buffer_stager.stage_chunks(self.pools.staging_executor())
            try:
                while True:
                    t0 = time.monotonic()
                    try:
                        buf = await agen.__anext__()
                    except StopAsyncIteration:
                        break
                    stream_select.note_stream_stage(self._label, time.monotonic() - t0)
                    await queue.put(buf)
            finally:
                await agen.aclose()
            await queue.put(end)

        async def consume() -> None:
            while True:
                buf = await queue.get()
                if buf is end:
                    return
                await hasher.feed(buf)
                t0 = time.monotonic()
                await stream.append(buf)
                stream_select.note_streamed(self._label, memoryview(buf).nbytes, time.monotonic() - t0)

        tasks = [asyncio.ensure_future(produce()), asyncio.ensure_future(consume())]
        try:
            await asyncio.gather(*tasks)
            await stream.commit()
        except BaseException:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            hasher.abort()
            await stream.abort()
            raise
        self.checksums[req.path] = await hasher.finalize()

    async def run_until_staged(self) -> None:
        """Run until every non-deferred request's bytes are held privately
        (the capture point of an async take)."""
        try:
            await self._engine.run(until=lambda: self._engine.unfinished_in(_STAGE_POOLS) == 0)
        except BaseException:
            self.pools.shutdown()
            raise

    async def run_to_completion(self) -> None:
        t0 = time.monotonic()
        try:
            self._engine.release_deferred()
            await self._engine.run()
            sidecar = f"{CHECKSUM_FILE_PREFIX}{self.rank}"
            if self.checksums:
                payload = json.dumps(self.checksums, sort_keys=True).encode()
                await self.storage.write(WriteIO(path=sidecar, buf=payload))
            else:
                # No object this take: a stale sidecar from an earlier take
                # at this path would make verify() report corruption.
                with contextlib.suppress(FileNotFoundError):
                    await self.storage.delete(sidecar)
        finally:
            self.pools.shutdown()
        self.drain_stats = stream_stats(
            [(t0, time.monotonic())],
            self._engine.intervals["stage"],
            self._engine.intervals["io"],
        )
        self.drain_stats["bytes_deduped"] = self.bytes_deduped
        self.drain_stats["objects_linked"] = self.objects_linked


class PendingIOWork:
    """The rest of a write pipeline after the capture point."""

    def __init__(self, pipeline: _WritePipeline) -> None:
        self._pipeline = pipeline

    def sync_complete(self, event_loop: asyncio.AbstractEventLoop) -> None:
        event_loop.run_until_complete(self._pipeline.run_to_completion())

    @property
    def drain_stats(self) -> Dict[str, float]:
        return dict(self._pipeline.drain_stats)


def sync_execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    event_loop: asyncio.AbstractEventLoop,
    base_loader: Optional[Callable[[], Optional[Tuple[str, Dict[str, Any]]]]] = None,
) -> PendingIOWork:
    """Run the write pipeline to its capture point; the returned handle
    finishes the rest (deferred staging and every write). ``base_loader``
    returns an incremental take's base as ``(root, {path: record})``, or
    None to write everything."""
    pipeline = _WritePipeline(write_reqs, storage, memory_budget_bytes, rank, base_loader)
    event_loop.run_until_complete(pipeline.run_until_staged())
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
    into: Optional[memoryview] = None,
) -> ReadIO:
    """One storage fetch of ``path`` (optionally ranged, optionally into
    the caller's buffer): the one fetch of the read pipeline, the broadcast
    and the swarm restores."""
    read_io = ReadIO(path=path, byte_range=byte_range, into=into)
    await storage.read(read_io)
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
    into: Optional[memoryview] = None,
    what: str = "read",
) -> ReadIO:
    """Fetch, and with a ``checker`` verify on ``executor``: a mismatch
    quarantines the path's read-cache entries and re-fetches once; a
    second mismatch raises :class:`ReadVerificationError`."""
    read_io = await fetch_read_io(storage, path, byte_range, into)
    if checker is None:
        return read_io
    loop = asyncio.get_running_loop()
    problem = await loop.run_in_executor(executor, checker, memoryview(read_io.buf))
    if problem is None:
        return read_io
    logger.warning(
        "%s of %s failed digest verification (%s); quarantining cache "
        "entries and re-fetching once", what, path, problem,
    )
    from .storage_plugins.cache import find_read_cache

    cache = find_read_cache(storage)
    if cache is not None:
        await loop.run_in_executor(executor, cache.quarantine_path, path)
    read_io = await fetch_read_io(storage, path, byte_range, into)
    problem = await loop.run_in_executor(executor, checker, memoryview(read_io.buf))
    if problem is not None:
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
    engine = GraphExecutor(
        memory_budget_bytes,
        caps={"io": MAX_CONCURRENT_IO, "consume": POOL_THREADS},
    )

    async def fetch(_ctx, _payload, req: ReadReq):
        into = req.buffer_consumer.read_into() if req.byte_range is not None else None
        want = _read_digest_record(digests, req.path) if verify else None
        checker = _verify_checker(want, req.byte_range) if want is not None else None
        read_io = await verified_fetch(
            storage, req.path, req.byte_range, checker, executor, into
        )
        totals["bytes_read"] += memoryview(read_io.buf).nbytes
        return read_io.buf

    async def consume(_ctx, buf, req: ReadReq) -> None:
        await req.buffer_consumer.consume_buffer(buf, executor)

    for req in sorted(read_reqs, key=lambda r: -r.buffer_consumer.get_consuming_cost_bytes()):
        engine.add(
            Node(
                "read",
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
    await engine.run()
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
    with ThreadPoolExecutor(POOL_THREADS, thread_name_prefix="tss-consume") as ex:
        return event_loop.run_until_complete(
            execute_read_reqs(read_reqs, storage, memory_budget_bytes, ex, digests)
        )

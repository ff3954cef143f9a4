"""The write and read pipelines, lowered onto the engine (``engine/``).

Write: each request becomes a ``stage -> io`` chain (stage: D2H +
serialize into a host buffer; io: hash + storage write, concurrently), or
one ``stream`` node for a streamable request of at least two stream
chunks: the storage append of one chunk overlaps the staging of the next.
Streaming is decided by size alone. The staged bytes of every object are
digested into the ``.checksums.<rank>`` sidecar, written before the
caller commits ``.snapshot_metadata``.

Read: each request becomes a ``read -> consume`` chain (fetch a byte
range; copy it into its target), budgeted by the consumer's cost.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from . import d2h, hashing
from .engine import GraphExecutor, Node
from .engine.intervals import stream_stats
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq
from .utils import knobs

logger = logging.getLogger(__name__)

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
    ) -> None:
        self.storage = storage
        self.rank = rank
        self.pools = PipelinePools()
        self.checksums: Dict[str, object] = {}
        # Resolved once: a deferred background drain must not re-read knobs
        # whose environment changed since the take was planned.
        self._want_sha = knobs.is_dedup_digests_enabled()
        self._grain = knobs.get_hash_chunk_bytes()
        self._stream_chunk = knobs.get_stream_chunk_bytes()
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

    def _add_request(self, req: WriteReq) -> None:
        stager = req.buffer_stager
        cost = stager.get_staging_cost_bytes()
        if cost >= 2 * self._stream_chunk and stager.can_stream():
            self._engine.add(
                Node(
                    "stream",
                    lambda ctx, _p, req=req: self._stream_one(req),
                    # Admitted at its steady-state footprint: the chunk in
                    # staging, the one being written, one look-ahead.
                    cost_bytes=min(cost, 3 * self._stream_chunk),
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
        buf = await req.buffer_stager.stage_buffer(self.pools.staging_executor())
        ctx.recost(memoryview(buf).nbytes)
        return buf

    async def _write_one(self, path: str, buf) -> None:
        loop = asyncio.get_running_loop()
        digest = asyncio.ensure_future(
            hashing.hash_buffer(
                memoryview(buf), self._grain, self._want_sha, loop, self.pools.hash_executor()
            )
        )
        try:
            await self.storage.write(WriteIO(path=path, buf=buf))
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
        queue: asyncio.Queue = asyncio.Queue(maxsize=1)
        end = object()

        async def produce() -> None:
            agen = req.buffer_stager.stage_chunks(self.pools.staging_executor())
            try:
                async for buf in agen:
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
                await stream.append(buf)

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
) -> PendingIOWork:
    """Run the write pipeline to its capture point; the returned handle
    finishes the rest (deferred staging and every write)."""
    pipeline = _WritePipeline(write_reqs, storage, memory_budget_bytes, rank)
    event_loop.run_until_complete(pipeline.run_until_staged())
    return PendingIOWork(pipeline)


async def execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    executor: ThreadPoolExecutor,
) -> None:
    engine = GraphExecutor(
        memory_budget_bytes,
        caps={"io": MAX_CONCURRENT_IO, "consume": POOL_THREADS},
    )

    async def fetch(_ctx, _payload, req: ReadReq):
        into = req.buffer_consumer.read_into() if req.byte_range is not None else None
        read_io = ReadIO(path=req.path, byte_range=req.byte_range, into=into)
        await storage.read(read_io)
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


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    with ThreadPoolExecutor(POOL_THREADS, thread_name_prefix="tss-consume") as ex:
        event_loop.run_until_complete(
            execute_read_reqs(read_reqs, storage, memory_budget_bytes, ex)
        )

"""One tensor <-> one storage object (or a byte range of one).

Staging always yields the tensor's little-endian C-order bytes, the
reference format, also for a non-contiguous view (made contiguous first).
A CUDA tensor is copied to a pinned host buffer on the pipeline's transfer
lanes (``d2h.py``), after the event that marks it ready. A CPU tensor is
staged zero-copy in a sync take; in an async take it is copied first, so
training may mutate it as soon as ``async_take`` returns.

Compressed entries (``TSS_TORCH_COMPRESSION``): the stager takes the raw
bytes the same way (a CUDA tensor's D2H copy into pinned host memory) and
compresses them on the staging pool, as one blob or, above the frame size,
as independent frames whose sizes a companion ``.ftab`` object records
(:class:`FrameTableStager`). A framed object streams frame by frame with
the same frame boundaries, so both routes write the same bytes, and the
JAX package's. A compressed slab member stages its raw bytes; its slab
compresses them (``batcher.CompressedSlabStager``).

Restore reads raw bytes into a flat uint8 host view of the target (the
live tensor itself when it is a CPU tensor of the same dtype and shape).
A compressed payload is decoded on the host first
(:class:`FramedSliceConsumer`); a budgeted read of a framed object fetches
and decodes only the frames each piece covers, and a slab member's read
its own frames.
"""

from __future__ import annotations

import asyncio
import json
import math
import pickle
import time
from concurrent.futures import Executor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import d2h
from ..io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from ..manifest import ArrayEntry
from ..serialization import (
    COMPRESSED,
    array_nbytes,
    codec_for_raw_serializer,
    compress_framed,
    compress_payload,
    decode_framed_payload,
    decode_raw_payload,
    dtype_to_string,
    ensure_codec_available,
    raw_serializer_for_codec,
    tensor_as_bytes,
)
from ..utils import knobs

# Side object beside a framed payload: its compressed frame sizes (JSON).
FRAME_TABLE_SUFFIX = ".ftab"


def chunk_row_ranges(
    shape, itemsize: int, max_chunk_bytes: int
) -> List[Tuple[int, int]]:
    """Row ranges [r0, r1) per dim-0 chunk, each chunk <= max_chunk_bytes
    (when a single row fits), spread evenly. Shared by the chunked-array
    preparer (one object per chunk) and streaming (one append per chunk);
    the same math as the JAX package, so chunk object names agree."""
    dim0 = int(shape[0])
    row_bytes = itemsize * int(np.prod(shape[1:])) if len(shape) > 1 else itemsize
    rows_per_chunk = max(1, max_chunk_bytes // max(row_bytes, 1))
    n_chunks = math.ceil(dim0 / rows_per_chunk)
    base = dim0 // n_chunks
    extra = dim0 % n_chunks
    ranges = []
    r0 = 0
    for i in range(n_chunks):
        rows = base + (1 if i < extra else 0)
        ranges.append((r0, r0 + rows))
        r0 += rows
    return ranges


def _host_view(t: torch.Tensor) -> memoryview:
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


class ArrayBufferStager(BufferStager):
    def __init__(
        self,
        tensor: torch.Tensor,
        entry: ArrayEntry,
        is_async_snapshot: bool = False,
        ready: Optional[Any] = None,
    ) -> None:
        self.tensor = tensor
        self.entry = entry
        self.is_async_snapshot = is_async_snapshot
        # CUDA only: the event after which the tensor's bytes are final.
        self.ready = ready
        # Resolved at planning, never at staging: a background drain must
        # not read a level whose environment changed since.
        self.compression_level: Optional[int] = None
        if entry.serializer in COMPRESSED:
            self.compression_level = knobs.get_compression_level(
                _codec=codec_for_raw_serializer(entry.serializer)
            )
        # A framed payload's compressed frame sizes, published at staging
        # for the companion FrameTableStager (or the failure that stopped
        # them, so the table's poll ends).
        self.frame_sizes: Optional[List[int]] = None
        self.frame_error: Optional[BaseException] = None
        # Set by the batcher for a member of a compressed slab: stage the
        # raw bytes; the slab compresses all its members.
        self.stage_raw = False

    def rebind(self, tensor: torch.Tensor, ready: Optional[Any]) -> None:
        """Point this stager at the next take's tensor (same dtype, shape
        and layout, which the prepared-take cache's key guarantees) and
        clear this take's frame publication."""
        self.tensor = tensor
        self.ready = ready
        self.frame_sizes = None
        self.frame_error = None

    def unbind(self) -> None:
        """Drop the tensor between takes, so a cached stager pins no
        device or host memory."""
        self.tensor = None
        self.ready = None

    @property
    def _compressed(self) -> bool:
        return self.entry.serializer in COMPRESSED and not self.stage_raw

    def get_staging_cost_bytes(self) -> int:
        nbytes = array_nbytes(self.entry.shape, self.entry.dtype)
        # Raw bytes and their compressed output coexist while compressing.
        return 2 * nbytes if self.entry.serializer in COMPRESSED else nbytes

    async def _cpu_bytes(self, t: torch.Tensor, executor: Optional[Executor], private: bool) -> memoryview:
        def work() -> memoryview:
            view = tensor_as_bytes(t)
            if private and t.is_contiguous():
                view = view.clone()  # a private copy: training resumes
            return memoryview(view.numpy())

        if executor is None:
            return work()
        return await asyncio.get_running_loop().run_in_executor(executor, work)

    async def _raw_bytes(self, t: torch.Tensor, executor: Optional[Executor]) -> memoryview:
        """The raw C-order bytes of ``t`` (all or a row block of the
        tensor) in host memory. An async take's CPU tensor is copied when
        those bytes are what gets written after ``async_take`` returns;
        compressed output and a slab member's bytes are private anyway."""
        if t.device.type == "cuda":
            host = await d2h.get_active().lanes.to_host(t, self.ready)
            return _host_view(host)
        return await self._cpu_bytes(t, executor, self.is_async_snapshot and not (self._compressed or self.stage_raw))

    async def _compress(self, view, executor: Optional[Executor], frame_bytes: Optional[int]):
        serializer, level = self.entry.serializer, self.compression_level

        def work():
            if frame_bytes:
                return compress_framed(view, serializer, level, frame_bytes)
            return compress_payload(view, serializer, level), None

        if executor is None:
            return work()
        return await asyncio.get_running_loop().run_in_executor(executor, work)

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        try:
            view = await self._raw_bytes(self.tensor, executor)
            if not self._compressed:
                return view
            payload, sizes = await self._compress(view, executor, self.entry.frame_bytes)
            if self.entry.frame_bytes:
                self.frame_sizes = sizes
            return payload
        except BaseException as e:
            self.frame_error = e
            raise

    def _stream_row_ranges(self) -> List[Tuple[int, int]]:
        shape = self.entry.shape
        if not shape or int(shape[0]) < 2:
            return []
        return chunk_row_ranges(
            shape, self.tensor.element_size(), knobs.get_stream_chunk_bytes()
        )

    def can_stream(self) -> bool:
        if self.stage_raw:
            return False  # the slab streams or not, never its member
        if self._compressed and not self.entry.frame_bytes:
            return False  # a single blob needs the whole buffer at once
        if self.is_async_snapshot and self.tensor.device.type == "cpu":
            # A mutable host source must be captured whole before
            # async_take returns; a stream would read it afterwards.
            return False
        return len(self._stream_row_ranges()) > 1

    async def _raw_chunks(self, executor: Optional[Executor]):
        """Dim-0 row blocks of raw bytes. CUDA: the next block's D2H runs
        while this one is consumed."""
        t = self.tensor
        ranges = self._stream_row_ranges()
        if t.device.type != "cuda":
            for r0, r1 in ranges:
                yield await self._cpu_bytes(t[r0:r1], executor, False)
            return
        lanes = d2h.get_active().lanes
        nxt = asyncio.ensure_future(lanes.to_host(t[ranges[0][0] : ranges[0][1]], self.ready))
        try:
            for i in range(len(ranges)):
                cur = nxt
                nxt = None
                if i + 1 < len(ranges):
                    r0, r1 = ranges[i + 1]
                    nxt = asyncio.ensure_future(lanes.to_host(t[r0:r1], self.ready))
                yield _host_view(await cur)
        finally:
            if nxt is not None:
                nxt.cancel()
                await asyncio.gather(nxt, return_exceptions=True)

    async def stage_chunks(self, executor: Optional[Executor] = None):
        """Chunks whose concatenation equals :meth:`stage_buffer`'s output.
        A framed payload emits whole frames and carries the remainder to
        the next row block, so its frames (and published sizes) are the
        unstreamed path's."""
        chunks = self._raw_chunks(executor)
        try:
            if not self._compressed:
                async for view in chunks:
                    yield view
                return
            frame_bytes = self.entry.frame_bytes
            n = len(self._stream_row_ranges())
            carry = bytearray()
            sizes: List[int] = []
            i = 0
            async for view in chunks:
                i += 1
                carry.extend(view)
                if i == n:
                    block = bytes(carry)
                    carry.clear()
                else:
                    cut = len(carry) // frame_bytes * frame_bytes
                    if cut == 0:
                        continue
                    block = bytes(carry[:cut])
                    del carry[:cut]
                payload, fsizes = await self._compress(block, executor, frame_bytes)
                sizes.extend(fsizes)
                if payload:
                    yield payload
            self.frame_sizes = sizes
        except BaseException as e:
            self.frame_error = e
            raise
        finally:
            await chunks.aclose()


class PollingTableStager(BufferStager):
    """Base of the ``.ftab`` stagers: waits for the payload stager
    (``main``) to publish its frame sizes, then writes them as JSON. The
    sizes exist only once the payload is compressed, after the manifest
    was gathered, hence a side object. Both requests run in one pipeline
    (the partitioner keeps them on one rank); the deadline turns a lost
    payload request into an error instead of a hang."""

    POLL_TIMEOUT_S = 1800.0

    def __init__(self, main: Any, described: str) -> None:
        self.main = main  # exposes frame_sizes / frame_error
        self.described = described

    def _table(self) -> dict:
        raise NotImplementedError

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        deadline = time.monotonic() + self.POLL_TIMEOUT_S
        while self.main.frame_sizes is None:
            if self.main.frame_error is not None:
                raise RuntimeError(
                    f"frame table for {self.described} unavailable: payload staging failed"
                ) from self.main.frame_error
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"frame table for {self.described} never materialised: the "
                    "payload write request did not stage within the deadline"
                )
            await asyncio.sleep(0.005)
        return json.dumps(self._table()).encode()

    def get_staging_cost_bytes(self) -> int:
        # A few bytes per frame, recosted when staged. Zero queues the table
        # behind its payload (requests are admitted in order, the biggest
        # first), so a polling table never holds the budget its payload
        # waits for.
        return 0


class FrameTableStager(PollingTableStager):
    """``.ftab`` of a framed payload: ``{"frame_bytes", "sizes"}``."""

    def __init__(self, main: ArrayBufferStager) -> None:
        super().__init__(main, described=main.entry.location)

    def _table(self) -> dict:
        return {"frame_bytes": self.main.entry.frame_bytes, "sizes": self.main.frame_sizes}


def plan_frame_groups(  # spmd-pure
    frame_sizes: Sequence[int],
    frame_bytes: int,
    raw_begin: int,
    raw_end: int,
    budget: Optional[int],
) -> List[Tuple[int, int, int, int]]:
    """Split the raw range [raw_begin, raw_end) into frame-aligned groups:
    ``(comp_begin, comp_end, group_raw_begin, group_raw_end)`` each, the
    compressed range indexing the concatenated payload and each group
    covering at most max(budget, frame_bytes) raw bytes."""
    prefix = [0]
    for s in frame_sizes:
        prefix.append(prefix[-1] + int(s))
    first = raw_begin // frame_bytes
    last = (raw_end + frame_bytes - 1) // frame_bytes  # exclusive
    per_group = max(1, (budget or raw_end) // frame_bytes)
    groups: List[Tuple[int, int, int, int]] = []
    i = first
    while i < last:
        j = min(i + per_group, last)
        groups.append((prefix[i], prefix[j], i * frame_bytes, min(j * frame_bytes, raw_end)))
        i = j
    return groups


class ByteRangeConsumer(BufferConsumer):
    """Copies one buffer into ``target[begin:end]`` of a flat uint8 view."""

    def __init__(self, target: np.ndarray, begin: int, end: int) -> None:
        self.target = target
        self.begin = begin
        self.end = end
        self._into: Optional[memoryview] = None

    def read_into(self) -> memoryview:
        self._into = memoryview(self.target[self.begin : self.end])
        return self._into

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        if buf is self._into:
            return  # the read landed in the target
        mv = memoryview(buf).cast("B")
        if mv.nbytes != self.end - self.begin:
            raise ValueError(
                f"read {mv.nbytes} bytes; expected {self.end - self.begin}"
            )

        def work() -> None:
            self.target[self.begin : self.end] = np.frombuffer(mv, dtype=np.uint8)

        if executor is None:
            work()
        else:
            await asyncio.get_running_loop().run_in_executor(executor, work)

    def get_consuming_cost_bytes(self) -> int:
        return self.end - self.begin


class FramedSliceConsumer(BufferConsumer):
    """Decodes a compressed buffer (one group of frames, or a whole
    payload) and delivers raw bytes [raw_begin, raw_end) of the entry's
    stream. The decoded region starts at ``group_raw_begin`` and may be a
    frame-aligned superset of the slice; the slice is cut out of it before
    ``deliver`` sees it."""

    def __init__(
        self,
        serializer: str,
        group_raw_begin: int,
        raw_begin: int,
        raw_end: int,
        deliver: Callable[[memoryview], None],
        decoded_raw_bytes: Optional[int] = None,
        merge_exempt: bool = True,
        framed: bool = True,
    ) -> None:
        self.serializer = serializer
        self.group_raw_begin = group_raw_begin
        self.raw_begin = raw_begin
        self.raw_end = raw_end
        self.deliver = deliver
        self.decoded_raw_bytes = decoded_raw_bytes
        # Adjacent compressed ranges of a big framed object must not merge
        # (the merged read would decode far more than the budget); members
        # of a compressed slab decode independently and may.
        self.merge_exempt = merge_exempt
        self.framed = framed

    async def consume_buffer(self, buf: BufferType, executor: Optional[Executor] = None) -> None:
        def work() -> None:
            decode = decode_framed_payload if self.framed else decode_raw_payload
            raw = memoryview(decode(buf, self.serializer)).cast("B")
            off = self.raw_begin - self.group_raw_begin
            n = self.raw_end - self.raw_begin
            if raw.nbytes < off + n:
                raise ValueError(
                    f"decoded {raw.nbytes} bytes; the slice needs {off + n}"
                )
            self.deliver(raw[off : off + n])

        if executor is None:
            work()
        else:
            await asyncio.get_running_loop().run_in_executor(executor, work)

    def get_consuming_cost_bytes(self) -> int:
        # The compressed buffer and the decoded bytes coexist.
        return 2 * (self.decoded_raw_bytes or (self.raw_end - self.raw_begin))


def flat_range_deliver(target: np.ndarray, begin: int) -> Callable[[memoryview], None]:
    """Copies delivered raw bytes into flat uint8 ``target`` from ``begin``."""

    def deliver(mv: memoryview) -> None:
        target[begin : begin + mv.nbytes] = np.frombuffer(mv, dtype=np.uint8)

    return deliver


def member_framed_reads(
    entry: ArrayEntry,
    frame_table: Optional[Dict[str, List[int]]],
    deliver: Callable[[memoryview], None],
) -> List[ReadReq]:
    """The read of one member of a compressed slab (``entry.raw_range``).
    With the slab's ``.ftab`` (``{"raw_sizes", "sizes"}``) it fetches and
    decodes the member's own frames; without it, the whole slab."""
    a, b = entry.raw_range
    if isinstance(frame_table, dict):
        raw_sizes = frame_table["raw_sizes"]
        rprefix, cprefix = [0], [0]
        for r in raw_sizes:
            rprefix.append(rprefix[-1] + int(r))
        for c in frame_table["sizes"]:
            cprefix.append(cprefix[-1] + int(c))
        i = next((k for k in range(len(raw_sizes)) if rprefix[k + 1] > a), 0)
        j = next((k + 1 for k in range(i, len(raw_sizes)) if rprefix[k + 1] >= b), len(raw_sizes))
        consumer = FramedSliceConsumer(
            entry.serializer, rprefix[i], a, b, deliver,
            decoded_raw_bytes=rprefix[j] - rprefix[i], merge_exempt=False,
        )
        return [ReadReq(path=entry.location, buffer_consumer=consumer, byte_range=(cprefix[i], cprefix[j]))]
    # The slab's raw extent is unknown here: bill the slab threshold.
    consumer = FramedSliceConsumer(
        entry.serializer, 0, a, b, deliver, decoded_raw_bytes=max(_SLAB_BYTES, b - a)
    )
    return [ReadReq(path=entry.location, buffer_consumer=consumer)]


# Slabs close at this many raw bytes (batcher.SLAB_SIZE_THRESHOLD_BYTES).
_SLAB_BYTES = 128 * 1024 * 1024


class PickledArrayConsumer(BufferConsumer):
    """An array entry the reference pickled (a numpy dtype outside the raw
    table): restored as the unpickled numpy array."""

    def __init__(self, nbytes: int, callback: Callable[[Any], None]) -> None:
        self.nbytes = nbytes
        self.callback = callback

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        self.callback(pickle.loads(bytes(buf)))

    def get_consuming_cost_bytes(self) -> int:
        return self.nbytes


class ArrayIOPreparer:
    @staticmethod
    def prepare_write(
        storage_path: str,
        tensor: torch.Tensor,
        replicated: bool = False,
        is_async_snapshot: bool = False,
        ready: Optional[Any] = None,
        dtype_str: Optional[str] = None,
    ) -> Tuple[ArrayEntry, List[WriteReq]]:
        dtype_str = dtype_str or dtype_to_string(tensor.dtype)
        serializer = raw_serializer_for_codec(knobs.get_compression())
        frame_bytes = None
        if serializer in COMPRESSED:
            f = knobs.get_compression_frame_bytes()
            if f > 0 and array_nbytes(list(tensor.shape), dtype_str) > f:
                frame_bytes = f
        entry = ArrayEntry(
            location=storage_path,
            serializer=serializer,
            dtype=dtype_str,
            shape=list(tensor.shape),
            replicated=replicated,
            frame_bytes=frame_bytes,
        )
        stager = ArrayBufferStager(tensor, entry, is_async_snapshot, ready)
        reqs = [WriteReq(path=storage_path, buffer_stager=stager)]
        if frame_bytes:
            reqs.append(
                WriteReq(path=storage_path + FRAME_TABLE_SUFFIX, buffer_stager=FrameTableStager(stager))
            )
        return entry, reqs

    @staticmethod
    def prepare_read(  # spmd-pure
        entry: ArrayEntry,
        target: np.ndarray,
        offset: int = 0,
        buffer_size_limit_bytes: Optional[int] = None,
        frame_table: Optional[Any] = None,
    ) -> List[ReadReq]:
        """Reads filling ``target[offset : offset + nbytes]`` (a flat uint8
        host view); split into budget-sized byte ranges above the limit.
        ``frame_table``: the entry's ``.ftab`` (frame sizes of a framed
        object, or a compressed slab's ``{"raw_sizes", "sizes"}``), which
        lets a framed object's budgeted reads and a slab member's read
        fetch only the frames they need."""
        ensure_codec_available(entry.serializer)
        nbytes = array_nbytes(entry.shape, entry.dtype)
        if entry.raw_range is not None:
            return member_framed_reads(entry, frame_table, flat_range_deliver(target, offset))
        if entry.serializer in COMPRESSED:
            base = entry.byte_range[0] if entry.byte_range else 0
            if (
                entry.frame_bytes
                and frame_table is not None
                and buffer_size_limit_bytes is not None
                and nbytes > buffer_size_limit_bytes
            ):
                return [
                    ReadReq(
                        path=entry.location,
                        buffer_consumer=FramedSliceConsumer(
                            entry.serializer, grb, grb, gre, flat_range_deliver(target, offset + grb)
                        ),
                        byte_range=(base + cb, base + ce),
                    )
                    for cb, ce, grb, gre in plan_frame_groups(
                        frame_table, entry.frame_bytes, 0, nbytes, buffer_size_limit_bytes
                    )
                ]
            consumer = FramedSliceConsumer(
                entry.serializer, 0, 0, nbytes, flat_range_deliver(target, offset),
                framed=bool(entry.frame_bytes),
            )
            byte_range = tuple(entry.byte_range) if entry.byte_range else None
            return [ReadReq(path=entry.location, buffer_consumer=consumer, byte_range=byte_range)]
        base = entry.byte_range[0] if entry.byte_range else 0
        step = nbytes
        if buffer_size_limit_bytes is not None and nbytes > buffer_size_limit_bytes:
            itemsize = max(1, nbytes // max(1, int(np.prod(entry.shape))))
            step = max(itemsize, buffer_size_limit_bytes - buffer_size_limit_bytes % itemsize)
        reqs = []
        for b in range(0, nbytes, step) if nbytes else [0]:
            e = min(b + step, nbytes)
            reqs.append(
                ReadReq(
                    path=entry.location,
                    buffer_consumer=ByteRangeConsumer(target, offset + b, offset + e),
                    byte_range=(base + b, base + e),
                )
            )
        return reqs

"""One tensor <-> one storage object (or a byte range of one).

Staging always yields the tensor's little-endian C-order bytes, the
reference format, also for a non-contiguous view (made contiguous first).
A CUDA tensor is copied to a pinned host buffer on the pipeline's transfer
lanes (``d2h.py``), after the event that marks it ready. A CPU tensor is
staged zero-copy in a sync take; in an async take it is copied first, so
training may mutate it as soon as ``async_take`` returns.

Eager D2H (:meth:`ArrayBufferStager.start_d2h_hint`): an ``async_take``
submits the copy of a captured CUDA tensor to the lanes before it returns;
the staging in the drain then consumes that pinned host tensor instead of
transferring again. A request that will stream hints its first chunk only;
the later chunks follow one ahead, as without a hint.

A captured CUDA tensor's version counter is recorded at capture
(:meth:`ArrayBufferStager.pin_version`) and checked once each of its D2H
copies has completed: a zero-copy capture (``ASYNC_CAPTURE=donate``)
whose tensor was changed in place before its bytes were copied fails the
take with :class:`~..io_types.CaptureViolationError`.

Compressed entries (``TSS_TORCH_COMPRESSION``): the stager takes the raw
bytes the same way (a CUDA tensor's D2H copy into pinned host memory) and
compresses them on the staging pool, as one blob or, above the frame size,
as independent frames whose sizes a companion ``.ftab`` object records
(:class:`FrameTableStager`). A framed object streams frame by frame with
the same frame boundaries, so both routes write the same bytes, and the
JAX package's. A compressed slab member stages its raw bytes; its slab
compresses them (``batcher.CompressedSlabStager``).

Restore reads raw bytes into a flat uint8 host view of the target (the
live tensor itself when it is a CPU tensor of the same dtype and shape;
for a CUDA target a pinned host tensor, allocated when the entry's first
read arrives: :class:`LazyHostTarget`).
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
import threading
import time
from concurrent.futures import Executor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import d2h
from ..io_types import (
    BufferConsumer,
    BufferStager,
    BufferType,
    CaptureViolationError,
    ReadReq,
    WriteReq,
)
from ..manifest import ArrayEntry
from ..serialization import (
    COMPRESSED,
    Serializer,
    array_nbytes,
    codec_for_raw_serializer,
    compress_framed,
    compress_payload,
    decode_framed_payload,
    decode_raw_payload,
    dtype_itemsize,
    dtype_to_string,
    ensure_codec_available,
    is_raw_family,
    numpy_dtype_to_string,
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


def entry_cost_bytes(entry: ArrayEntry) -> int:
    """Best-effort host bytes of staging or consuming one array entry: a
    compressed entry costs twice its raw bytes on the consume side (the
    payload and the decoded bytes coexist); 1 MiB when it cannot say."""
    try:
        n = 1
        for d in entry.shape:
            n *= int(d)
        if is_raw_family(entry.serializer):
            n *= dtype_itemsize(entry.dtype)
            if entry.serializer != Serializer.RAW:
                n *= 2
        else:
            n *= np.dtype(entry.dtype).itemsize
        return n
    except Exception:  # noqa: BLE001 - a cost estimate never fails a plan
        return 1024 * 1024


def _note_serialize(t0: float, path: str, nbytes: int) -> None:
    """One ``stage.serialize`` interval, from ``t0`` to now, when a write
    pipeline with telemetry is active."""
    times = d2h.current_times()
    if times is not None:
        times.record("serialize", t0, time.monotonic(), path=path, nbytes=nbytes)


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
        # A captured CUDA tensor's version at capture (pin_version).
        self.expect_version: Optional[int] = None
        # The eager D2H (start_d2h_hint): (row range or None for the whole
        # tensor, future of its pinned host copy).
        self._hint: Optional[Tuple[Optional[Tuple[int, int]], Any]] = None

    def rebind(self, tensor: torch.Tensor, ready: Optional[Any], captured: bool = False) -> None:
        """Point this stager at the next take's tensor (same dtype, shape
        and layout, which the prepared-take cache's key guarantees) and
        clear this take's frame publication and hint."""
        self.unbind()
        self.tensor = tensor
        self.ready = ready
        self.frame_sizes = None
        self.frame_error = None
        if captured:
            self.pin_version()

    def unbind(self) -> None:
        """Drop the tensor between takes, so a cached stager pins no
        device or host memory."""
        self.tensor = None
        self.ready = None
        self.expect_version = None
        if self._hint is not None:
            self._hint[1].cancel()
            self._hint = None

    def pin_version(self) -> None:
        """Record a captured CUDA tensor's version counter (views share
        it); :meth:`check_version` fails the take if it moves before the
        bytes are copied."""
        if self.tensor is not None and self.tensor.device.type == "cuda":
            self.expect_version = self.tensor._version

    def check_version(self) -> None:
        """Raise if the captured tensor was changed in place since capture
        (called once its D2H copy has completed)."""
        if self.expect_version is not None and self.tensor._version != self.expect_version:
            raise CaptureViolationError(
                f"{self.entry.location}: the tensor was changed in place after "
                "async_take captured it without a copy (TSS_TORCH_ASYNC_CAPTURE="
                "donate or TSS_TORCH_ASYNC_DEVICE_COPY=0) and before its bytes "
                "were copied; the take is abandoned"
            )

    def start_d2h_hint(self, lanes: Any, stream: bool = False) -> None:
        """Submit the D2H copy of the tensor (``stream``: of its first
        stream chunk only) to ``lanes``; the staging consumes its result."""
        t = self.tensor
        if t is None or t.device.type == "cpu" or self._hint is not None:
            return
        rows = self._stream_row_ranges()[0] if stream else None
        src = t[rows[0] : rows[1]] if rows is not None else t
        fut = lanes.submit_to_host(src, self.ready, path=self.entry.location, check=self.check_version)
        self._hint = (rows, fut)

    def _take_hint(self, rows: Optional[Tuple[int, int]]) -> Optional[Any]:
        """The hint's future when it covers ``rows``; a hint of other rows
        is dropped."""
        hint, self._hint = self._hint, None
        if hint is None:
            return None
        if hint[0] != rows:
            hint[1].cancel()
            return None
        return hint[1]

    async def _to_host(self, src: torch.Tensor, rows: Optional[Tuple[int, int]]) -> torch.Tensor:
        """The pinned host copy of ``src`` (the tensor, or its ``rows``):
        the hint's when it covers them, else a transfer on the lanes."""
        hint = self._take_hint(rows)
        if hint is not None:
            return await asyncio.wrap_future(hint)
        return await d2h.get_active().lanes.to_host(
            src, self.ready, path=self.entry.location, check=self.check_version
        )

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
            host = await self._to_host(t, None)
            t0 = time.monotonic()
            view = _host_view(host)
        else:
            t0 = time.monotonic()
            view = await self._cpu_bytes(t, executor, self.is_async_snapshot and not (self._compressed or self.stage_raw))
        if not self._compressed:
            # RAW: the view (or an async take's private host copy) is the
            # whole serialization; a compressed entry's is its codec.
            _note_serialize(t0, self.entry.location, view.nbytes)
        return view

    async def _compress(self, view, executor: Optional[Executor], frame_bytes: Optional[int]):
        serializer, level = self.entry.serializer, self.compression_level
        times = d2h.current_times()

        def work():
            t0 = time.monotonic()
            if frame_bytes:
                out = compress_framed(view, serializer, level, frame_bytes)
            else:
                out = compress_payload(view, serializer, level), None
            if times is not None:
                times.record("serialize", t0, time.monotonic(), path=self.entry.location, nbytes=len(out[0]))
            return out

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
        r0, r1 = ranges[0]
        nxt = asyncio.ensure_future(self._to_host(t[r0:r1], ranges[0]))
        try:
            for i in range(len(ranges)):
                cur = nxt
                nxt = None
                if i + 1 < len(ranges):
                    r0, r1 = ranges[i + 1]
                    nxt = asyncio.ensure_future(self._to_host(t[r0:r1], ranges[i + 1]))
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


class LazyHostTarget:
    """A flat uint8 host buffer made by ``alloc`` on its first use (the
    first read of its entry that arrives), not when the restore is
    planned, so a restore holds only the buffers of entries in flight.
    Thread-safe: reads of one entry may arrive on several threads."""

    def __init__(self, alloc: Callable[[], np.ndarray]) -> None:
        self._alloc = alloc
        self._arr: Optional[np.ndarray] = None
        self._lock = threading.Lock()

    def get(self) -> np.ndarray:
        with self._lock:
            if self._arr is None:
                self._arr = self._alloc()
            return self._arr

    def release(self) -> None:
        """Drop the buffer (its entry is finalized)."""
        with self._lock:
            self._arr = None


def resolve_target(target: Any) -> np.ndarray:
    """The flat uint8 array behind ``target`` (a :class:`LazyHostTarget`
    is allocated here on its first use)."""
    return target.get() if isinstance(target, LazyHostTarget) else target


class ByteRangeConsumer(BufferConsumer):
    """Copies one buffer into ``target[begin:end]`` of a flat uint8 view
    (an array, or a :class:`LazyHostTarget`)."""

    def __init__(self, target: Any, begin: int, end: int) -> None:
        self.target = target
        self.begin = begin
        self.end = end
        self._into: Optional[memoryview] = None

    def read_into(self) -> memoryview:
        self._into = memoryview(resolve_target(self.target)[self.begin : self.end])
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
            resolve_target(self.target)[self.begin : self.end] = np.frombuffer(mv, dtype=np.uint8)

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


def flat_range_deliver(target: Any, begin: int) -> Callable[[memoryview], None]:
    """Copies delivered raw bytes into flat uint8 ``target`` (an array or
    a :class:`LazyHostTarget`) from ``begin``."""

    def deliver(mv: memoryview) -> None:
        resolve_target(target)[begin : begin + mv.nbytes] = np.frombuffer(mv, dtype=np.uint8)

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
        entry.serializer, 0, a, b, deliver,
        decoded_raw_bytes=max(knobs.get_slab_size_threshold_bytes(), b - a),
    )
    return [ReadReq(path=entry.location, buffer_consumer=consumer)]


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


class PickledRowsConsumer(BufferConsumer):
    """One pickled chunk of a pickled array, copied into its rows of the
    restored array (``target``: a view of those rows)."""

    def __init__(self, target: np.ndarray) -> None:
        self.target = target

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        np.copyto(self.target, pickle.loads(bytes(buf)), casting="no")

    def get_consuming_cost_bytes(self) -> int:
        return max(1, int(self.target.nbytes))


class PickledArrayStager(BufferStager):
    """A numpy array whose dtype has no raw form (``<U3``, ``object``, a
    datetime), pickled at staging as the reference does. Staging runs
    before ``async_take`` returns, so a later mutation cannot reach it."""

    def __init__(self, arr: np.ndarray) -> None:
        self.arr = arr
        self.nbytes = int(arr.nbytes)

    def rebind(self, arr: np.ndarray) -> None:
        self.arr = arr

    def unbind(self) -> None:
        self.arr = None

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        arr = self.arr if self.arr.flags["C_CONTIGUOUS"] else np.ascontiguousarray(self.arr)
        return pickle.dumps(arr, protocol=pickle.HIGHEST_PROTOCOL)

    def get_staging_cost_bytes(self) -> int:
        return self.nbytes


def is_pickled_array(value: Any) -> bool:
    """A numpy array the reference pickles: its dtype has no raw form."""
    return isinstance(value, np.ndarray) and numpy_dtype_to_string(value.dtype) is None


class ArrayIOPreparer:
    @staticmethod
    def prepare_pickled_write(
        storage_path: str, arr: np.ndarray, replicated: bool = False
    ) -> Tuple[ArrayEntry, List[WriteReq]]:
        """The reference's pickle branch: ``ArrayEntry(serializer="pickle")``
        recording ``str(dtype)`` and the shape."""
        entry = ArrayEntry(
            location=storage_path,
            serializer=Serializer.PICKLE,
            dtype=str(arr.dtype),
            shape=list(arr.shape),
            replicated=replicated,
        )
        return entry, [WriteReq(path=storage_path, buffer_stager=PickledArrayStager(arr))]

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

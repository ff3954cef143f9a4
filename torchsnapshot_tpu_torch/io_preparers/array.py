"""One tensor <-> one storage object (or a byte range of one).

Staging always yields the tensor's little-endian C-order bytes, the
reference format, also for a non-contiguous view (made contiguous first).
A CUDA tensor is copied to a pinned host buffer on the pipeline's transfer
lanes (``d2h.py``), after the event that marks it ready. A CPU tensor is
staged zero-copy in a sync take; in an async take it is copied first, so
training may mutate it as soon as ``async_take`` returns.

Restore reads raw bytes into a flat uint8 host view of the target (the
live tensor itself when it is a CPU tensor of the same dtype and shape).
"""

from __future__ import annotations

import asyncio
import math
import pickle
from concurrent.futures import Executor
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import d2h
from ..io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from ..manifest import ArrayEntry
from ..serialization import (
    Serializer,
    array_nbytes,
    dtype_to_string,
    ensure_uncompressed,
    tensor_as_bytes,
)
from ..utils import knobs


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

    def get_staging_cost_bytes(self) -> int:
        return array_nbytes(self.entry.shape, self.entry.dtype)

    async def _cpu_bytes(self, t: torch.Tensor, executor: Optional[Executor]) -> memoryview:
        def work() -> memoryview:
            view = tensor_as_bytes(t)
            if self.is_async_snapshot and t.is_contiguous():
                view = view.clone()  # a private copy: training resumes
            return memoryview(view.numpy())

        if executor is None:
            return work()
        return await asyncio.get_running_loop().run_in_executor(executor, work)

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        t = self.tensor
        if t.device.type == "cuda":
            host = await d2h.get_active().lanes.to_host(t, self.ready)
            return _host_view(host)
        return await self._cpu_bytes(t, executor)

    def _stream_row_ranges(self) -> List[Tuple[int, int]]:
        shape = self.entry.shape
        if not shape or int(shape[0]) < 2:
            return []
        return chunk_row_ranges(
            shape, self.tensor.element_size(), knobs.get_stream_chunk_bytes()
        )

    def can_stream(self) -> bool:
        if self.is_async_snapshot and self.tensor.device.type == "cpu":
            # A mutable host source must be captured whole before
            # async_take returns; a stream would read it afterwards.
            return False
        return len(self._stream_row_ranges()) > 1

    async def stage_chunks(self, executor: Optional[Executor] = None):
        """Dim-0 row blocks whose concatenation equals stage_buffer's
        output. CUDA: the next block's D2H runs while this one is written."""
        t = self.tensor
        ranges = self._stream_row_ranges()
        if t.device.type != "cuda":
            for r0, r1 in ranges:
                yield await self._cpu_bytes(t[r0:r1], executor)
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
        entry = ArrayEntry(
            location=storage_path,
            serializer=Serializer.RAW,
            dtype=dtype_str or dtype_to_string(tensor.dtype),
            shape=list(tensor.shape),
            replicated=replicated,
        )
        stager = ArrayBufferStager(tensor, entry, is_async_snapshot, ready)
        return entry, [WriteReq(path=storage_path, buffer_stager=stager)]

    @staticmethod
    def prepare_read(
        entry: ArrayEntry,
        target: np.ndarray,
        offset: int = 0,
        buffer_size_limit_bytes: Optional[int] = None,
    ) -> List[ReadReq]:
        """Reads filling ``target[offset : offset + nbytes]`` (a flat uint8
        host view); split into budget-sized byte ranges above the limit."""
        ensure_uncompressed(entry.serializer, entry.location)
        nbytes = array_nbytes(entry.shape, entry.dtype)
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

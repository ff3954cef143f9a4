"""Small-write batching: coalesce many small tensors into slab objects.

Every raw tensor below :data:`SLAB_SIZE_THRESHOLD_BYTES` joins a
``batched/<uuid>`` slab; its entry is relocated with ``byte_range``. The
member byte sizes are known from (shape, dtype) at planning time, so the
slab layout is fixed before any data moves. Members are sorted
deferred-first, then by device, then by path (on one device, the JAX
package's order); a slab closes at the threshold and never mixes deferred
with captured members or two devices.

A slab whose members are all tensors of one device and of a packable
dtype is staged by :class:`DeviceBatchedBufferStager` over kernel K1
(:func:`..kernels.pack_slab`): one launch packs the slab on the card, and
one D2H copy fetches it. There is no fallback to host packing for CUDA
members: a failed pack raises. Other slabs concatenate their members'
staged bytes on the host (:class:`BatchedBufferStager`).

Compressed small tensors (``raw_zstd``/``raw_zlib``, unframed, not shard
pieces) form slabs of their own, one codec per slab: the slab is packed
raw as above (K1 on the card, one D2H), then compressed on the host with
one frame per member (:class:`CompressedSlabStager`). Compressed sizes are
unknown at planning, so the manifest gives each member its raw range
(``raw_range``) and the slab's ``.ftab`` maps raw frames to compressed
bytes (:class:`SlabFrameTableStager`).

The read side merges adjacent byte ranges of one object into one read,
except the framed groups of a big compressed object (``merge_exempt``).
"""

from __future__ import annotations

import asyncio
import threading
import uuid
from concurrent.futures import Executor
from typing import Dict, List, Optional, Tuple

from . import d2h, kernels
from .io_preparers.array import FRAME_TABLE_SUFFIX, ArrayBufferStager, PollingTableStager
from .io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from .manifest import ArrayEntry, ChunkedArrayEntry, Entry, ShardedArrayEntry
from .serialization import COMPRESSED, Serializer, array_nbytes, compress_member_framed

# Slabs close at this size; smaller tensors join them (the JAX package's
# default threshold).
SLAB_SIZE_THRESHOLD_BYTES = 128 * 1024 * 1024


def _collect_array_entries(entries: List[Entry]) -> Dict[str, ArrayEntry]:
    """location -> ArrayEntry for every array entry, chunks and shards
    included."""
    out: Dict[str, ArrayEntry] = {}
    for entry in entries:
        if isinstance(entry, ArrayEntry):
            out[entry.location] = entry
        elif isinstance(entry, ChunkedArrayEntry):
            for chunk in entry.chunks:
                out[chunk.tensor.location] = chunk.tensor
        elif isinstance(entry, ShardedArrayEntry):
            for shard in entry.shards:
                out[shard.tensor.location] = shard.tensor
    return out


class BatchedBufferStager(BufferStager):
    """Stages all members of one slab and concatenates their bytes."""

    def __init__(self, members: List[Tuple[WriteReq, int, int]]) -> None:
        self.members = members  # (member write req, begin, end) in the slab
        self.total = members[-1][2] if members else 0

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        slab = bytearray(self.total)

        async def stage_one(req: WriteReq, begin: int, end: int) -> None:
            mv = memoryview(await req.buffer_stager.stage_buffer(executor)).cast("B")
            if mv.nbytes != end - begin:
                raise RuntimeError(
                    f"Staged size {mv.nbytes} != planned slab slot "
                    f"{end - begin} for {req.path}"
                )
            slab[begin:end] = mv

        await asyncio.gather(*(stage_one(*m) for m in self.members))
        return slab

    def get_staging_cost_bytes(self) -> int:
        return self.total


class DeviceBatchedBufferStager(BatchedBufferStager):
    """Packs the members into one uint8 slab with K1 on their device, then
    fetches it with one D2H copy (CUDA), or packs on the host (CPU)."""

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        stagers = [req.buffer_stager for req, _, _ in self.members]
        tensors = [s.tensor for s in stagers]
        device = tensors[0].device
        if device.type == "cuda":
            host = await d2h.get_active().lanes.run_to_host(
                device,
                self.total,
                stagers[0].ready,
                lambda stream: kernels.pack_slab(tensors, stream=stream),
                tensors,
            )
        else:
            host = kernels.pack_slab(tensors)
        if host.numel() != self.total:
            raise RuntimeError(
                f"Device-packed slab is {host.numel()} bytes, planned {self.total}"
            )
        return memoryview(host.numpy())


class CompressedSlabStager(BufferStager):
    """Stages a slab raw (``inner``), then compresses it on the host with
    one frame per member, and publishes the frame sizes for the slab's
    :class:`SlabFrameTableStager`. For an async take's device slab this
    runs in the background drain, never inside the stall."""

    def __init__(self, inner: BatchedBufferStager, member_sizes: List[int], serializer: str, level: int) -> None:
        self.inner = inner
        self.member_sizes = member_sizes
        self.serializer = serializer
        self.level = level
        self.frame_sizes: Optional[List[int]] = None
        self.frame_error: Optional[BaseException] = None
        # frame_sizes is published from a staging thread and cleared on the
        # loop between takes (the prepared-take cache).
        self._frame_lock = threading.Lock()

    def reset_take(self) -> None:
        """Clear this take's frame publication (a cached slab's next take)."""
        with self._frame_lock:
            self.frame_sizes = None
            self.frame_error = None

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        try:
            raw = await self.inner.stage_buffer(executor)

            def work() -> bytes:
                payload, sizes = compress_member_framed(raw, self.member_sizes, self.serializer, self.level)
                with self._frame_lock:
                    self.frame_sizes = sizes
                return payload

            if executor is None:
                return work()
            return await asyncio.get_running_loop().run_in_executor(executor, work)
        except BaseException as e:
            self.frame_error = e
            raise

    def get_staging_cost_bytes(self) -> int:
        # The raw slab and its compressed output coexist.
        return 2 * self.inner.get_staging_cost_bytes()


class SlabFrameTableStager(PollingTableStager):
    """A compressed slab's ``.ftab``: per-frame raw and compressed sizes
    (frames are member-aligned, so a member's ``raw_range`` maps to its
    compressed bytes through both)."""

    def __init__(self, main: CompressedSlabStager, path: str) -> None:
        super().__init__(main, described=f"slab {path}")

    def _table(self) -> dict:
        return {"member_framed": True, "raw_sizes": self.main.member_sizes, "sizes": self.main.frame_sizes}


def _device_key(req: WriteReq) -> str:
    tensor = getattr(req.buffer_stager, "tensor", None)
    return "" if tensor is None or tensor.device.type == "cpu" else str(tensor.device)


def _device_packable(members: List[Tuple[WriteReq, int, int]]) -> bool:
    stagers = [req.buffer_stager for req, _, _ in members]
    if not all(isinstance(s, ArrayBufferStager) for s in stagers):
        return False
    if len({s.tensor.device for s in stagers}) != 1:
        return False
    return all(s.tensor.dtype in kernels.PACKABLE_DTYPES for s in stagers)


def batch_write_requests(
    entries: List[Entry], write_reqs: List[WriteReq]
) -> List[WriteReq]:
    """Coalesce small tensor writes into slabs: raw ones into raw slabs,
    compressed ones into member-framed compressed slabs (one codec each).
    Mutates the members' entries in place (new ``location`` and
    ``byte_range``, or ``raw_range`` when compressed); runs before the
    manifest is serialized."""
    threshold = SLAB_SIZE_THRESHOLD_BYTES
    by_location = _collect_array_entries(entries)
    # Shard pieces never join compressed slabs: the sharded read path
    # speaks file byte ranges, not raw slab coordinates.
    shard_locations = {
        shard.tensor.location
        for entry in entries
        if isinstance(entry, ShardedArrayEntry)
        for shard in entry.shards
    }
    small: List[Tuple[WriteReq, ArrayEntry, int]] = []
    small_compressed: List[Tuple[WriteReq, ArrayEntry, int]] = []
    passthrough: List[WriteReq] = []
    for req in write_reqs:
        entry = by_location.get(req.path)
        if entry is None:
            passthrough.append(req)
            continue
        nbytes = array_nbytes(entry.shape, entry.dtype)
        if nbytes >= threshold:
            passthrough.append(req)
        elif entry.serializer == Serializer.RAW:
            small.append((req, entry, nbytes))
        elif (
            entry.serializer in COMPRESSED
            and entry.frame_bytes is None
            and isinstance(req.buffer_stager, ArrayBufferStager)
            and req.path not in shard_locations
        ):
            small_compressed.append((req, entry, nbytes))
        else:
            passthrough.append(req)
    if len(small) + len(small_compressed) <= 1:
        return write_reqs

    batched: List[WriteReq] = []

    def pack(members: List[Tuple[WriteReq, ArrayEntry, int]], compressed: bool) -> None:
        # Deferred members first, then by device, then by path: slabs never
        # mix deferred and captured members, nor devices (a one-device slab
        # is what K1 packs). On a single device this is the JAX package's
        # order.
        members = sorted(members, key=lambda t: (0 if t[0].defer_staging else 1, _device_key(t[0]), t[0].path))
        slab: List[Tuple[WriteReq, int, int]] = []
        slab_entries: List[ArrayEntry] = []
        offset = 0

        def close_slab() -> None:
            nonlocal slab, slab_entries, offset
            if len(slab) == 1:
                # A one-member slab is strictly worse than the plain object.
                passthrough.append(slab[0][0])
            elif slab:
                slab_path = f"batched/{uuid.uuid4().hex}"
                for (_req, begin, end), entry in zip(slab, slab_entries):
                    entry.location = slab_path
                    if compressed:
                        entry.raw_range = [begin, end]
                    else:
                        entry.byte_range = [begin, end]
                stager: BufferStager = (
                    DeviceBatchedBufferStager if _device_packable(slab) else BatchedBufferStager
                )(slab)
                defer = all(req.defer_staging for req, _, _ in slab)
                if compressed:
                    for req, _, _ in slab:
                        req.buffer_stager.stage_raw = True
                    stager = CompressedSlabStager(
                        stager,
                        member_sizes=[end - begin for _, begin, end in slab],
                        serializer=slab_entries[0].serializer,
                        level=slab[0][0].buffer_stager.compression_level,
                    )
                    batched.append(WriteReq(path=slab_path, buffer_stager=stager, defer_staging=defer))
                    batched.append(
                        WriteReq(
                            path=slab_path + FRAME_TABLE_SUFFIX,
                            buffer_stager=SlabFrameTableStager(stager, slab_path),
                            defer_staging=defer,
                        )
                    )
                else:
                    batched.append(WriteReq(path=slab_path, buffer_stager=stager, defer_staging=defer))
            slab, slab_entries, offset = [], [], 0

        for req, entry, nbytes in members:
            if slab and (
                offset + nbytes > threshold
                or slab[0][0].defer_staging != req.defer_staging
                or _device_key(slab[0][0]) != _device_key(req)
            ):
                close_slab()
            slab.append((req, offset, offset + nbytes))
            slab_entries.append(entry)
            offset += nbytes
        close_slab()

    pack(small, compressed=False)
    for serializer in (Serializer.RAW_ZSTD, Serializer.RAW_ZLIB):
        pack([m for m in small_compressed if m[1].serializer == serializer], compressed=True)
    return passthrough + batched


# ---------------------------------------------------------------------------
# Read side: merge adjacent ranged reads of the same object
# ---------------------------------------------------------------------------


class BatchedBufferConsumer(BufferConsumer):
    """Fans one merged buffer out to the member consumers by sub-range."""

    def __init__(self, members: List[Tuple[ReadReq, int, int]]) -> None:
        self.members = members  # (member read req, begin, end) in the buffer

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        mv = memoryview(buf)
        await asyncio.gather(
            *(
                req.buffer_consumer.consume_buffer(mv[begin:end], executor)
                for req, begin, end in self.members
            )
        )

    def get_consuming_cost_bytes(self) -> int:
        return sum(r.buffer_consumer.get_consuming_cost_bytes() for r, _, _ in self.members)


# Reads at least this large stay unmerged: they land straight in their
# targets (``BufferConsumer.read_into``), which a merged read cannot.
_MERGE_MAX_MEMBER_BYTES = 1 << 20


def batch_read_requests(
    read_reqs: List[ReadReq],
    max_merged_bytes: Optional[int] = None,
    merge_large: bool = False,
) -> List[ReadReq]:
    """Merge exactly adjacent small byte-range reads per object into one
    read, each merged run capped at ``max_merged_bytes``. ``merge_large``
    merges large reads too, as the JAX package does: over a read cache a
    slab read whole populates one whole entry, where its members' ranges
    would each cover its hash chunks only in part."""
    member_cap = None if merge_large else _MERGE_MAX_MEMBER_BYTES
    ranged: Dict[str, List[ReadReq]] = {}
    out: List[ReadReq] = []
    for req in read_reqs:
        if (
            req.byte_range is None
            or (member_cap is not None and req.byte_range[1] - req.byte_range[0] >= member_cap)
            or getattr(req.buffer_consumer, "merge_exempt", False)
        ):
            out.append(req)
        else:
            ranged.setdefault(req.path, []).append(req)
    for path, reqs in ranged.items():
        reqs.sort(key=lambda r: r.byte_range[0])
        run: List[ReadReq] = []

        def close_run() -> None:
            if len(run) == 1:
                out.append(run[0])
            elif run:
                begin, end = run[0].byte_range[0], run[-1].byte_range[1]
                members = [(r, r.byte_range[0] - begin, r.byte_range[1] - begin) for r in run]
                out.append(
                    ReadReq(
                        path=path,
                        buffer_consumer=BatchedBufferConsumer(members),
                        byte_range=(begin, end),
                    )
                )

        for req in reqs:
            if run and (
                req.byte_range[0] != run[-1].byte_range[1]
                or (
                    max_merged_bytes is not None
                    and req.byte_range[1] - run[0].byte_range[0] > max_merged_bytes
                )
            ):
                close_run()
                run = []
            run.append(req)
        close_run()
    return out

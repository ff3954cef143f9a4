"""Sharded (DTensor) state: save each unique shard once, restore into any
other sharding.

A port of ``torchsnapshot_tpu/io_preparers/sharded_array.py`` for
``torch.distributed.tensor.DTensor``:

- **Save**: each rank writes its local shard unless it is a replica: a rank
  whose mesh coordinate is not 0 along every ``Replicate`` mesh dim holds a
  copy another rank writes (the JAX package's ``replica_id != 0``). Shard
  coordinates are global ``(offsets, sizes)`` derived from the mesh, the
  placements and the rank's coordinate, with ``torch.chunk``'s uneven
  split. A DTensor over a sub-mesh (FSDP2's ``mesh["dp"]`` of a
  ``("dp", "tp")`` mesh) is placed on that sub-mesh: where several
  sub-meshes hold the same shard (a ``tp`` replica), the partitioner elects
  one writer from what the ranks report, never from the mesh alone, since
  the sub-meshes of a pipeline stage hold different parameters.
  ``_StridedShard`` (FSDP2 over a TP-sharded dim) is supported wherever
  each rank's local tensor is one rectangle of the global array: the
  strided shard is undone by a later ``Shard`` of the same dim, which is
  the JAX package's ``NamedSharding(mesh, P(("tp", "dp")))``. Shards above
  ``MAX_SHARD_SIZE_BYTES`` are written as several pieces cut along their
  largest dim; such a piece is a strided view, which kernel K3 gathers on
  the card before its D2H copy. Empty shards carry no bytes and are not
  written.
- **Restore**: the live target's local tensor is the target shard. For
  every saved shard that overlaps it, the reader fetches exactly the rows
  the overlap needs (``shard_read_intervals``) into a pinned host buffer;
  one H2D copy moves them to a device staging buffer, and K3 scatters the
  overlap rectangles into the target in place (``ShardedArrayBufferConsumer``).
  Saved and target shardings need not match in mesh shape, placements or
  number of ranks. A compressed shard is decoded on the host first, into
  the same pinned buffer, and then takes the same H2D and K3 route; a
  budgeted read of a framed shard fetches the frames covering each piece
  of its overlap rows and cuts the piece out of their decoded bytes.

``Partial`` raises ``NotImplementedError`` (a pending sum across ranks, not
state), and so does a placement list that leaves a rank's local tensor in
several disjoint blocks of a dim (a lone ``_StridedShard``).
"""

from __future__ import annotations

import asyncio
from concurrent.futures import Executor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import hashing, kernels
from ..io_types import BufferConsumer, BufferType, ReadReq, WriteReq
from ..manifest import ArrayEntry, Shard, ShardedArrayEntry
from ..serialization import (
    COMPRESSED,
    Serializer,
    dtype_to_string,
    ensure_codec_available,
    string_to_dtype,
)
from ..utils import knobs
from .array import ArrayIOPreparer, FramedSliceConsumer, member_framed_reads

# A target to restore into: (tensor of the target shard, global offsets, sizes)
TargetShard = Tuple[torch.Tensor, Sequence[int], Sequence[int]]

# Byte gap up to which two ranged reads of one shard coalesce (the JAX
# package's READ_MERGE_GAP_BYTES default).
READ_MERGE_GAP_BYTES = 0


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def _placement_kind(placement: Any) -> Tuple[str, int]:
    """("shard", dim), ("strided", dim) or ("replicate", -1); raises for
    the rest. By type name, so no DTensor module is imported for it."""
    name = type(placement).__name__
    if name == "Replicate":
        return "replicate", -1
    if name == "Shard":
        return "shard", int(placement.dim)
    if name == "_StridedShard":
        return "strided", int(placement.dim)
    if name == "Partial":
        raise NotImplementedError(
            f"DTensor placement {placement!r} is not supported: a Partial "
            "tensor is a pending reduction across ranks, not state; reduce it "
            "(redistribute to Shard or Replicate) before taking it"
        )
    raise NotImplementedError(
        f"DTensor placement {placement!r} is not supported "
        "(only Shard, _StridedShard and Replicate)"
    )


def placement_key(placement: Any) -> Tuple[str, int, int]:
    """(kind, dim, split factor) of a placement: what shapes a plan."""
    kind, dim = _placement_kind(placement)
    return kind, dim, int(placement.split_factor) if kind == "strided" else 1


def _chunk(n: int, parts: int, i: int) -> Tuple[int, int]:
    """[start, stop) of chunk ``i`` of ``n`` items cut in ``parts`` as
    ``torch.chunk`` cuts them (ceil-sized, the last ones short or empty)."""
    full = -(-n // parts)
    start = min(full * i, n)
    return start, min(start + full, n)


def _take_runs(runs: List[Tuple[int, int]], start: int, stop: int) -> List[Tuple[int, int]]:
    """Positions [start, stop) of the index sequence that ``runs`` (global
    [begin, end) intervals, in order) spell out."""
    out: List[Tuple[int, int]] = []
    pos = 0
    for b, e in runs:
        lo, hi = max(start, pos), min(stop, pos + e - b)
        if lo < hi:
            out.append((b + lo - pos, b + hi - pos))
        pos += e - b
    return out


def placement_index_runs(  # spmd-pure
    global_shape: Sequence[int],
    mesh_shape: Sequence[int],
    placements: Sequence[Any],
    coordinate: Sequence[int],
) -> List[List[Tuple[int, int]]]:
    """Per tensor dim, the global index intervals mesh ``coordinate`` holds,
    in local order. Mesh dims apply left to right as DTensor applies them:
    ``Shard(d)`` keeps chunk ``c`` of what dim ``d`` holds so far;
    ``_StridedShard(d, split_factor=f)`` cuts it in ``f`` pieces and keeps
    chunk ``c`` of each (FSDP2's shard of each TP block, recorded before the
    TP ``Shard`` that picks the block)."""
    runs: List[List[Tuple[int, int]]] = [[(0, int(n))] if int(n) else [] for n in global_shape]
    for mesh_dim, placement in enumerate(placements):
        kind, d = _placement_kind(placement)
        if kind == "replicate":
            continue
        n, c = int(mesh_shape[mesh_dim]), int(coordinate[mesh_dim])
        length = sum(e - b for b, e in runs[d])
        if kind == "shard":
            runs[d] = _take_runs(runs[d], *_chunk(length, n, c))
            continue
        kept: List[Tuple[int, int]] = []
        factor = int(placement.split_factor)
        for j in range(factor):
            p0, p1 = _chunk(length, factor, j)
            a, b = _chunk(p1 - p0, n, c)
            kept += _take_runs(runs[d], p0 + a, p0 + b)
        runs[d] = kept
    merged: List[List[Tuple[int, int]]] = []
    for dim_runs in runs:
        out: List[Tuple[int, int]] = []
        for b, e in dim_runs:
            if out and out[-1][1] == b:
                out[-1] = (out[-1][0], e)
            else:
                out.append((b, e))
        merged.append(out)
    return merged


def placement_offsets_sizes(  # spmd-pure
    global_shape: Sequence[int],
    mesh_shape: Sequence[int],
    placements: Sequence[Any],
    coordinate: Sequence[int],
) -> Tuple[List[int], List[int]]:
    """Global (offsets, sizes) of the shard at mesh ``coordinate``, as
    DTensor's own local shape and offset give it, uneven splits included.
    An empty shard's offset is the dim's size, as DTensor reports it.
    Raises ``NotImplementedError`` when the shard is not one rectangle (a
    ``_StridedShard`` that no later ``Shard`` of its dim undoes)."""
    offsets: List[int] = []
    sizes: List[int] = []
    runs = placement_index_runs(global_shape, mesh_shape, placements, coordinate)
    for d, dim_runs in enumerate(runs):
        if not dim_runs:
            offsets.append(int(global_shape[d]))
            sizes.append(0)
        elif len(dim_runs) == 1:
            offsets.append(dim_runs[0][0])
            sizes.append(dim_runs[0][1] - dim_runs[0][0])
        else:
            raise NotImplementedError(
                f"DTensor placements {tuple(placements)} leave mesh coordinate "
                f"{tuple(coordinate)} holding {len(dim_runs)} disjoint blocks of "
                f"dim {d} ({dim_runs[:4]}{'...' if len(dim_runs) > 4 else ''}): the "
                "local tensor is not one rectangle of the global array, which no "
                "saved shard can describe (a _StridedShard needs a later Shard of "
                "the same dim, as FSDP2 over TP gives it)"
            )
    for d, s in enumerate(sizes):
        if s == 0:
            offsets[d] = int(global_shape[d])
    return offsets, sizes


@dataclass
class DTensorLeaf:
    """What planning needs of a DTensor: its local shard and where the
    shard lies. The local tensor may be replaced by a private fork (async
    take) without touching the DTensor."""

    local: torch.Tensor
    global_shape: Tuple[int, ...]
    mesh_shape: Tuple[int, ...]
    placements: Tuple[Any, ...]
    coordinate: Optional[Tuple[int, ...]]
    offsets: List[int]
    sizes: List[int]

    @property
    def fully_replicated(self) -> bool:
        return is_fully_replicated_sharding(self.placements)

    @property
    def mesh_size(self) -> int:
        return int(np.prod(self.mesh_shape)) if self.mesh_shape else 1

    @property
    def replica_id(self) -> int:
        """0 when this rank writes the shard: its coordinate is 0 along
        every ``Replicate`` mesh dim (nonzero otherwise)."""
        if self.coordinate is None:
            return 1
        return sum(
            int(c)
            for c, p in zip(self.coordinate, self.placements)
            if _placement_kind(p)[0] == "replicate"
        )


def dtensor_leaf(dt: Any) -> DTensorLeaf:
    """Describe DTensor ``dt`` over its own mesh. Offsets come from its
    placements (:func:`placement_offsets_sizes`); its local shape must
    agree."""
    mesh, placements = dt.device_mesh, tuple(dt.placements)
    for p in placements:
        _placement_kind(p)
    global_shape = tuple(int(s) for s in dt.shape)
    local = dt.to_local()
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        offsets, sizes = [0] * len(global_shape), [0] * len(global_shape)
    else:
        offsets, sizes = placement_offsets_sizes(
            global_shape, tuple(int(s) for s in mesh.shape), placements, tuple(int(c) for c in coordinate)
        )
        if list(local.shape) != sizes:
            raise ValueError(
                f"DTensor local shape {tuple(local.shape)} does not match its "
                f"placements {placements} (expected {tuple(sizes)})"
            )
    return DTensorLeaf(
        local=local,
        global_shape=global_shape,
        mesh_shape=tuple(int(s) for s in mesh.shape),
        placements=placements,
        coordinate=None if coordinate is None else tuple(int(c) for c in coordinate),
        offsets=offsets,
        sizes=sizes,
    )


def local_unique_shards(leaf: DTensorLeaf) -> List[Tuple[torch.Tensor, List[int], List[int], int]]:
    """(data, offsets, sizes, replica_id) of each unique local shard: one
    per rank for a DTensor, none for a rank outside its mesh."""
    if leaf.coordinate is None:
        return []
    return [(leaf.local, list(leaf.offsets), list(leaf.sizes), leaf.replica_id)]


def subdivide(  # spmd-pure
    offsets: List[int],
    sizes: List[int],
    itemsize: int,
    max_bytes: int,
    dim: Optional[int] = None,
) -> List[Tuple[List[int], List[int]]]:
    """Split a shard into <=max_bytes pieces along ``dim`` (default: its
    largest dim). Callers that need byte-contiguous pieces pass ``dim=0``."""
    nbytes = int(np.prod(sizes)) * itemsize if sizes else itemsize
    if nbytes <= max_bytes or not sizes:
        return [(offsets, sizes)]
    if dim is None:
        dim = int(np.argmax(sizes))
    other = int(np.prod(sizes)) // max(sizes[dim], 1) * itemsize
    rows = max(1, max_bytes // max(other, 1))
    pieces = []
    for r0 in range(0, sizes[dim], rows):
        r1 = min(r0 + rows, sizes[dim])
        o = list(offsets)
        s = list(sizes)
        o[dim] = offsets[dim] + r0
        s[dim] = r1 - r0
        pieces.append((o, s))
    return pieces


def overlap(  # spmd-pure
    src_off: Sequence[int],
    src_sz: Sequence[int],
    dst_off: Sequence[int],
    dst_sz: Sequence[int],
) -> Optional[Tuple[Tuple[slice, ...], Tuple[slice, ...]]]:
    """(src_slices, dst_slices) of the intersection, or None."""
    src_slices: List[slice] = []
    dst_slices: List[slice] = []
    for so, ss, do, ds in zip(src_off, src_sz, dst_off, dst_sz):
        lo = max(so, do)
        hi = min(so + ss, do + ds)
        if hi <= lo:
            return None
        src_slices.append(slice(lo - so, hi - so))
        dst_slices.append(slice(lo - do, hi - do))
    return tuple(src_slices), tuple(dst_slices)


def overlap_row_intervals(  # spmd-pure
    shard_off: Sequence[int],
    shard_sz: Sequence[int],
    target_rects: Sequence[Tuple[Sequence[int], Sequence[int]]],
) -> List[Tuple[int, int]]:
    """Union of the shard-relative dim-0 row intervals at least one target
    rectangle overlaps, merged and sorted. A run of whole rows of a
    C-contiguous saved shard is one byte range, so these intervals are what
    a minimal-byte reshard fetches."""
    ivals: List[Tuple[int, int]] = []
    for dst_off, dst_sz in target_rects:
        ov = overlap(shard_off, shard_sz, dst_off, dst_sz)
        if ov is None:
            continue
        sl = ov[0][0]
        ivals.append((sl.start, sl.stop))
    ivals.sort()
    merged: List[Tuple[int, int]] = []
    for b, e in ivals:
        if merged and b <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((b, e))
    return merged


def record_grain_for(  # spmd-pure
    digests: Optional[Dict[str, object]], location: str
) -> Optional[int]:
    """The hash-chunk grain of the object at ``location`` when its sidecar
    record carries a v2 chunk grid, else None."""
    if not digests:
        return None
    info = hashing.record_chunk_info(digests.get(location))
    return info[0] if info is not None else None


def shard_read_intervals(  # spmd-pure
    shard: Shard,
    target_rects: Sequence[Tuple[Sequence[int], Sequence[int]]],
    buffer_size_limit_bytes: Optional[int],
    grain: Optional[int] = None,
    merge_gap_bytes: Optional[int] = None,
) -> Optional[List[Tuple[int, int]]]:
    """The byte intervals (relative to the shard's payload) a reader must
    fetch to cover every target overlap of one RAW saved shard:

    1. the overlap row intervals become byte intervals via the row stride;
    2. each expands outward to hash-chunk boundaries (``grain``, in object
       coordinates) and then to row boundaries;
    3. intervals whose gap is at most ``merge_gap_bytes`` coalesce;
    4. intervals above ``buffer_size_limit_bytes`` split at row boundaries
       (grain-floored when a grain is known); a single row wider than the
       budget is admitted whole.

    Returns ``None`` when the plan is one read of the whole payload, ``[]``
    when no target overlaps the shard, else the intervals."""
    entry = shard.tensor
    if entry.serializer != Serializer.RAW or not shard.sizes:
        raise ValueError("shard_read_intervals needs a RAW non-scalar shard")
    rows = overlap_row_intervals(shard.offsets, shard.sizes, target_rects)
    if not rows:
        return []
    itemsize = string_to_dtype(entry.dtype).itemsize
    row_bytes = int(np.prod(shard.sizes[1:])) * itemsize
    nbytes = shard.sizes[0] * row_bytes
    base0 = entry.byte_range[0] if entry.byte_range else 0
    if merge_gap_bytes is None:
        merge_gap_bytes = READ_MERGE_GAP_BYTES

    def floor_align(pos: int) -> int:
        if grain:
            pos = (base0 + pos) // grain * grain - base0
        return max(0, pos // row_bytes * row_bytes)

    def ceil_align(pos: int) -> int:
        if grain:
            pos = -((base0 + pos) // -grain) * grain - base0
        pos = min(pos, nbytes)
        return min(-(pos // -row_bytes) * row_bytes, nbytes)

    expanded = [(floor_align(b * row_bytes), ceil_align(e * row_bytes)) for b, e in rows]
    merged: List[Tuple[int, int]] = []
    for b, e in expanded:
        if merged and b - merged[-1][1] <= merge_gap_bytes:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((b, e))
    step = None
    if buffer_size_limit_bytes is not None:
        step = max(row_bytes, buffer_size_limit_bytes // row_bytes * row_bytes)
    if len(merged) == 1 and merged[0] == (0, nbytes) and (step is None or nbytes <= step):
        return None
    if step is None:
        return merged
    split: List[Tuple[int, int]] = []
    for b, e in merged:
        cur = b
        while e - cur > step:
            cut = cur + step
            if grain:
                g = max(0, (base0 + cut) // grain * grain - base0)
                g = g // row_bytes * row_bytes
                if g > cur:
                    cut = g
            split.append((cur, cut))
            cur = cut
        split.append((cur, e))
    return split


# ---------------------------------------------------------------------------
# Restore: the overlap scatter (K3)
# ---------------------------------------------------------------------------


class ShardedArrayBufferConsumer(BufferConsumer):
    """Scatters one fetched saved-shard piece into every overlapping target.

    The piece's bytes land in a host buffer owned by this consumer (pinned
    when the targets are on a CUDA device). For CUDA targets one H2D copy
    moves them into a device staging buffer on the restore stream, and K3
    copies each overlap rectangle into its target in place; the pinned
    buffer is released once the H2D copy has run. For CPU targets K3's
    plain version copies from the host buffer."""

    def __init__(
        self,
        entry: ArrayEntry,
        copy_specs: List[Tuple[torch.Tensor, Tuple[slice, ...], Tuple[slice, ...]]],
        h2d: Any = None,
    ) -> None:
        self.entry = entry  # the piece: dtype and shape of the fetched rows
        self.copy_specs = copy_specs  # (target, src_slices, dst_slices)
        self.h2d = h2d
        self.nbytes = int(np.prod(entry.shape)) * string_to_dtype(entry.dtype).itemsize
        self.device = copy_specs[0][0].device
        if any(t.device != self.device for t, _, _ in copy_specs):
            raise ValueError("targets of one shard piece span several devices")
        self._host: Optional[torch.Tensor] = None

    def _alloc_host(self) -> torch.Tensor:
        return torch.empty(
            self.nbytes, dtype=torch.uint8, pin_memory=self.device.type == "cuda"
        )

    def read_into(self) -> memoryview:
        self._host = self._alloc_host()
        return memoryview(self._host.numpy())

    def _scatter(self, host: torch.Tensor) -> None:
        dtype = string_to_dtype(self.entry.dtype)
        shape = tuple(int(s) for s in self.entry.shape)
        if self.device.type == "cuda":
            staging, copied = self.h2d.stage(host, self.device)
            src = staging.view(dtype).view(shape)
            pairs = [(src[ss], dst[ds]) for dst, ss, ds in self.copy_specs]
            kernels.copy_blocks(pairs, stream=self.h2d.stream(self.device))
            # The pinned source may go once its copy has run.
            copied.synchronize()
        else:
            src = host.view(dtype).view(shape)
            kernels.copy_blocks([(src[ss], dst[ds]) for dst, ss, ds in self.copy_specs])

    def deliver(self, mv: memoryview) -> None:
        """Scatter the piece's decoded raw bytes (a compressed payload's,
        on a consumer thread)."""
        if mv.nbytes != self.nbytes:
            raise ValueError(f"{self.entry.location}: decoded {mv.nbytes} bytes; expected {self.nbytes}")
        host = self._alloc_host()
        host.numpy()[:] = np.frombuffer(mv, dtype=np.uint8)
        self._scatter(host)

    async def consume_buffer(self, buf: BufferType, executor: Optional[Executor] = None) -> None:
        mv = memoryview(buf).cast("B")
        if mv.nbytes != self.nbytes:
            raise ValueError(
                f"{self.entry.location}: read {mv.nbytes} bytes; expected {self.nbytes}"
            )

        # The buffer ``read_into`` lent (if any) is taken on the loop; the
        # worker thread never touches ``self._host``.
        landed, self._host = self._host, None

        def work() -> None:
            host = landed
            if host is None or not _same_buffer(mv, host):
                # A merged read handed over a slice of its own buffer.
                host = self._alloc_host()
                host.numpy()[:] = np.frombuffer(mv, dtype=np.uint8)
            self._scatter(host)

        if executor is None:
            work()
        else:
            await asyncio.get_running_loop().run_in_executor(executor, work)

    def get_consuming_cost_bytes(self) -> int:
        return self.nbytes


def _same_buffer(mv: memoryview, host: torch.Tensor) -> bool:
    """True when ``mv`` is a view of exactly ``host``'s bytes (the read
    landed in place)."""
    if mv.nbytes != host.numel():
        return False
    if mv.nbytes == 0:
        return True
    addr = np.frombuffer(mv, dtype=np.uint8).__array_interface__["data"][0]
    return addr == host.data_ptr()


def _copy_specs(off: Sequence[int], sz: Sequence[int], targets: List[TargetShard]):
    """(target, piece slices, target slices) of each target the piece
    (global ``off``, ``sz``) overlaps."""
    specs = []
    for dst, dst_off, dst_sz in targets:
        ov = overlap(off, sz, dst_off, dst_sz)
        if ov is not None:
            specs.append((dst, ov[0], ov[1]))
    return specs


def _piece_entry(entry: ArrayEntry, sizes: Sequence[int]) -> ArrayEntry:
    return ArrayEntry(
        location=entry.location,
        serializer=entry.serializer,
        dtype=entry.dtype,
        shape=list(sizes),
        replicated=entry.replicated,
    )


def _framed_shard_reads(
    shard: Shard,
    targets: List[TargetShard],
    frame_table: List[int],
    buffer_size_limit_bytes: int,
    h2d: Any,
) -> List[ReadReq]:
    """Budgeted reads of one framed compressed shard: the overlap row
    intervals cut into pieces of at most the budget (and at least one
    frame's rows), each fetching and decoding only its covering frames.
    The decoded region starts at its first frame, before the piece; the
    piece is cut out of it before the H2D and K3 see it."""
    entry = shard.tensor
    itemsize = string_to_dtype(entry.dtype).itemsize
    F = entry.frame_bytes
    base = entry.byte_range[0] if entry.byte_range else 0
    row_bytes = int(np.prod(shard.sizes[1:])) * itemsize if shard.sizes else itemsize
    total = int(np.prod(shard.sizes)) * itemsize if shard.sizes else itemsize
    effective = max(buffer_size_limit_bytes, -(-F // row_bytes) * row_bytes)
    if not shard.sizes:
        pieces = [(list(shard.offsets), list(shard.sizes))]
    else:
        rects = [(d_off, d_sz) for _dst, d_off, d_sz in targets]
        pieces = []
        for r0, r1 in overlap_row_intervals(shard.offsets, shard.sizes, rects):
            off = list(shard.offsets)
            sz = list(shard.sizes)
            off[0] = shard.offsets[0] + r0
            sz[0] = r1 - r0
            pieces.extend(subdivide(off, sz, itemsize, effective, dim=0))
    prefix = [0]
    for s in frame_table:
        prefix.append(prefix[-1] + int(s))
    reqs: List[ReadReq] = []
    for off, sz in pieces:
        specs = _copy_specs(off, sz, targets)
        if not specs:
            continue
        a = (off[0] - shard.offsets[0]) * row_bytes if sz else 0
        b = a + (int(np.prod(sz)) * itemsize if sz else itemsize)
        f0 = a // F
        f1 = min(len(frame_table), -(-b // F))
        consumer = ShardedArrayBufferConsumer(_piece_entry(entry, sz), specs, h2d)
        reqs.append(
            ReadReq(
                path=entry.location,
                buffer_consumer=FramedSliceConsumer(
                    entry.serializer, f0 * F, a, b, consumer.deliver,
                    decoded_raw_bytes=min(f1 * F, total) - f0 * F,
                ),
                byte_range=(base + prefix[f0], base + prefix[f1]),
            )
        )
    return reqs


def _decoded_shard_reads(
    shard: Shard,
    targets: List[TargetShard],
    frame_table: Optional[Any],
    buffer_size_limit_bytes: Optional[int],
    h2d: Any,
) -> List[ReadReq]:
    """Reads of one compressed shard: budgeted frame groups of a framed
    shard when its table is at hand, a compressed slab member's own frames,
    else the whole payload, decoded once."""
    entry = shard.tensor
    budgeted = frame_table is not None and buffer_size_limit_bytes is not None
    if entry.raw_range is None and entry.frame_bytes and budgeted:
        return _framed_shard_reads(shard, targets, frame_table, buffer_size_limit_bytes, h2d)
    specs = _copy_specs(shard.offsets, shard.sizes, targets)
    if not specs:
        return []
    consumer = ShardedArrayBufferConsumer(_piece_entry(entry, shard.sizes), specs, h2d)
    if entry.raw_range is not None:
        return member_framed_reads(entry, frame_table, consumer.deliver)
    decode = FramedSliceConsumer(
        entry.serializer, 0, 0, consumer.nbytes, consumer.deliver, framed=bool(entry.frame_bytes)
    )
    byte_range = tuple(entry.byte_range) if entry.byte_range else None
    return [ReadReq(path=entry.location, buffer_consumer=decode, byte_range=byte_range)]


# ---------------------------------------------------------------------------
# The preparer
# ---------------------------------------------------------------------------


class ShardedArrayIOPreparer:
    @staticmethod
    def shard_location(logical_path: str, offsets: Sequence[int]) -> str:
        suffix = "_".join(str(o) for o in offsets) or "scalar"
        return f"sharded/{logical_path}.{suffix}"

    @classmethod
    def prepare_write(
        cls,
        logical_path: str,
        leaf: DTensorLeaf,
        is_async_snapshot: bool = False,
        ready: Optional[Any] = None,
    ) -> Tuple[ShardedArrayEntry, List[WriteReq]]:
        dtype_str = dtype_to_string(leaf.local.dtype)
        itemsize = leaf.local.element_size()
        max_shard = knobs.get_max_shard_size_bytes()
        shards: List[Shard] = []
        write_reqs: List[WriteReq] = []
        for data, offsets, sizes, replica_id in local_unique_shards(leaf):
            if replica_id != 0 or 0 in sizes:
                continue  # another rank writes this copy; empty shards hold nothing
            pieces = subdivide(offsets, sizes, itemsize, max_shard)
            for sub_off, sub_sz in pieces:
                if len(pieces) == 1:
                    piece = data
                else:
                    # A strided view when cut along an inner dim: its
                    # staging gathers it with K3.
                    piece = data[
                        tuple(
                            slice(o - bo, o - bo + s)
                            for o, bo, s in zip(sub_off, offsets, sub_sz)
                        )
                    ]
                location = cls.shard_location(logical_path, sub_off)
                sub_entry, sub_reqs = ArrayIOPreparer.prepare_write(
                    location, piece, False, is_async_snapshot, ready, dtype_str
                )
                shards.append(Shard(offsets=sub_off, sizes=sub_sz, tensor=sub_entry))
                write_reqs.extend(sub_reqs)
        entry = ShardedArrayEntry(dtype=dtype_str, shape=list(leaf.global_shape), shards=shards)
        return entry, write_reqs

    @staticmethod
    def prepare_read(  # spmd-pure
        entry: ShardedArrayEntry,
        targets: List[TargetShard],
        buffer_size_limit_bytes: Optional[int] = None,
        digests: Optional[Dict[str, object]] = None,
        h2d: Any = None,
        frame_tables: Optional[Dict[str, Any]] = None,
    ) -> List[ReadReq]:
        """Plan reads scattering the saved shards into ``targets``: only the
        row ranges some target overlaps are fetched (``shard_read_intervals``),
        split at ``buffer_size_limit_bytes``; saved shards no target overlaps
        are never read. Each read carries its byte range explicitly, so it
        lands straight in its consumer's host buffer. ``h2d`` (a
        ``d2h.HostToDevice``) carries CUDA targets' copies. A compressed
        shard is decoded first (``frame_tables``: the ``.ftab`` tables by
        location, for framed shards' budgeted reads and slab members)."""
        targets = [(t, o, s) for t, o, s in targets if t.numel() > 0]
        read_reqs: List[ReadReq] = []
        for shard in entry.shards:
            ensure_codec_available(shard.tensor.serializer)
            if shard.tensor.serializer in COMPRESSED:
                read_reqs.extend(
                    _decoded_shard_reads(
                        shard,
                        targets,
                        (frame_tables or {}).get(shard.tensor.location),
                        buffer_size_limit_bytes,
                        h2d,
                    )
                )
                continue
            itemsize = string_to_dtype(shard.tensor.dtype).itemsize
            base0 = shard.tensor.byte_range[0] if shard.tensor.byte_range else 0
            if not shard.sizes:
                intervals = [(0, itemsize)]
                row_bytes = itemsize
            else:
                rects = [(d_off, d_sz) for _dst, d_off, d_sz in targets]
                intervals = shard_read_intervals(
                    shard,
                    rects,
                    buffer_size_limit_bytes,
                    grain=record_grain_for(digests, shard.tensor.location),
                )
                row_bytes = int(np.prod(shard.sizes[1:])) * itemsize
                if intervals is None:
                    intervals = [(0, shard.sizes[0] * row_bytes)]
            for b, e in intervals:
                sub_off = list(shard.offsets)
                sub_sz = list(shard.sizes)
                if sub_sz:
                    sub_off[0] = shard.offsets[0] + b // row_bytes
                    sub_sz[0] = (e - b) // row_bytes
                copy_specs = _copy_specs(sub_off, sub_sz, targets)
                if not copy_specs:
                    continue  # gap-merged rows with no overlap of their own
                read_reqs.append(
                    ReadReq(
                        path=shard.tensor.location,
                        buffer_consumer=ShardedArrayBufferConsumer(
                            _piece_entry(shard.tensor, sub_sz), copy_specs, h2d
                        ),
                        byte_range=(base0 + b, base0 + e),
                    )
                )
        return read_reqs


# ---------------------------------------------------------------------------
# Restore-side helpers: the target shards of a live DTensor, and the result
# ---------------------------------------------------------------------------


def alloc_target_shards(
    leaf: DTensorLeaf,
) -> Dict[Tuple[int, ...], Tuple[torch.Tensor, List[int], List[int]]]:
    """The target of each unique local shard: the live local tensor itself,
    filled in place (no allocation)."""
    if leaf.coordinate is None:
        return {}
    return {tuple(leaf.offsets): (leaf.local, list(leaf.offsets), list(leaf.sizes))}


def process_shard_map(  # spmd-pure
    global_shape: Sequence[int],
    mesh_shape: Sequence[int],
    placements: Sequence[Any],
    mesh_ranks: Sequence[int],
) -> Dict[int, List[Tuple[List[int], List[int]]]]:
    """Unique target-shard rectangles per rank of a mesh (``mesh_ranks``:
    the mesh's ranks in C order of its coordinates), from the placements
    alone: identical on every rank, with no collective. Rectangles are
    sorted by offsets."""
    out: Dict[int, Dict[Tuple[int, ...], Tuple[List[int], List[int]]]] = {}
    for flat, coordinate in enumerate(np.ndindex(*[int(s) for s in mesh_shape])):
        offsets, sizes = placement_offsets_sizes(global_shape, mesh_shape, placements, coordinate)
        out.setdefault(int(mesh_ranks[flat]), {}).setdefault(tuple(offsets), (offsets, sizes))
    return {r: [rect for _k, rect in sorted(rects.items())] for r, rects in sorted(out.items())}


def is_fully_replicated_sharding(placements: Sequence[Any]) -> bool:
    """True when every rank of the mesh holds the whole tensor."""
    return all(_placement_kind(p)[0] == "replicate" for p in placements)


def assemble_dtensor(leaf: DTensorLeaf, live: Any) -> Any:
    """A DTensor on live DTensor ``live``'s mesh and placements whose local
    tensor is ``leaf.local`` (filled by the restore), for a target that
    could not be filled in place: ``DTensor.from_local(...,
    run_check=False)``, no collective."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        leaf.local,
        live.device_mesh,
        list(live.placements),
        run_check=False,
        shape=torch.Size(leaf.global_shape),
        stride=contiguous_stride(leaf.global_shape),
    )


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """C-order strides of ``shape``, as torch gives them."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))

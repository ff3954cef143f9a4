"""Replicated-write load balancing across ranks.

A port of ``torchsnapshot_tpu/partitioner.py``. Every rank runs the same
deterministic greedy assignment on the same inputs (one ``all_gather`` of
the per-rank loads of non-replicated writes, integer byte counts), so no
broadcast is needed. Replicated storage paths carry no rank, so each rank
keeps exactly the write requests assigned to it. Every rank keeps every
replicated *entry* in its manifest, whoever writes the bytes.

Sharded shards ride the same gather. A DTensor over a sub-mesh (FSDP2's
``mesh["dp"]`` of a ``("dp", "tp")`` mesh) is written by the
coordinate-0 rank of its sub-mesh, so where several sub-meshes hold the
same parameter (the ``tp`` replicas) several ranks offer the same shard
object. Each rank reports the shard objects it offers; an object offered by
more than one rank goes to one of them, the least loaded, and the others
drop it from their writes and their manifest entry. Replicas are never
inferred from the mesh: the sub-meshes of pipeline stages hold different
parameters, and each offers its own.

Each rank's compression codec rides the same gather: a rank restoring a
replicated entry trusts its own manifest copy, so ranks whose codecs
differ would let one rank's copy lie about another's bytes. Such a take
fails on every rank (:class:`CodecDivergenceError`). A framed replicated
payload's ``.ftab`` follows its payload to the same writer: its stager
waits on the payload's stager. A plan-cache hit replays the cached
assignment and gathers nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import telemetry
from .io_preparers.array import FRAME_TABLE_SUFFIX
from .io_types import WriteReq
from .manifest import ArrayEntry, ChunkedArrayEntry, Entry, Manifest, ShardedArrayEntry, is_replicated
from .parallel.coordinator import Coordinator
from .utils import knobs


class CodecDivergenceError(ValueError):
    """The ranks of a take run different compression codecs. Raised on
    every rank; ``ranks`` are those whose codec differs from rank 0's."""

    def __init__(self, codecs: List[str]) -> None:
        self.codecs = codecs
        self.ranks = [r for r, c in enumerate(codecs) if c != codecs[0]]
        super().__init__(
            f"TSS_TORCH_COMPRESSION differs across ranks ({codecs}); set it "
            "identically on every process"
        )


def _estimate(req: WriteReq) -> int:
    return req.buffer_stager.get_staging_cost_bytes()


def greedy_assignment(
    loads: List[int], items: List[Tuple[int, str]]
) -> Dict[str, int]:
    """Biggest request first onto the least-loaded rank; ties go to the
    lower rank, and equal sizes are taken in path order, so every rank
    computes the same assignment. ``loads`` is updated in place."""
    assignment: Dict[str, int] = {}
    for size, path in sorted(items, key=lambda t: (-t[0], t[1])):
        target = min(range(len(loads)), key=lambda r: (loads[r], r))
        assignment[path] = target
        loads[target] += size
    return assignment


def partition_write_reqs_with_assignment(
    manifest: Manifest,
    write_reqs: List[WriteReq],
    coordinator: Coordinator,
    assignment: Optional[Dict[str, int]] = None,
) -> Tuple[List[WriteReq], Dict[str, int]]:
    """The subset of ``write_reqs`` this rank executes, and the
    ``{storage_path: writer_rank}`` assignment of replicated objects and of
    shard objects several ranks offer (``assignment``: a cached one to
    replay, with no collective). Shards this rank does not write leave its
    manifest entries."""
    world_size = coordinator.get_world_size()
    rank = coordinator.get_rank()
    if world_size == 1:
        return write_reqs, {}

    replicated_locations = set()
    shard_locations = set()
    partners: Dict[str, str] = {}  # .ftab -> its payload
    for entry in manifest.values():
        if isinstance(entry, ShardedArrayEntry):
            subs = [shard.tensor for shard in entry.shards]
            shard_locations.update(sub.location for sub in subs)
        elif is_replicated(entry):
            subs = [entry] if hasattr(entry, "location") else []
            subs += [chunk.tensor for chunk in getattr(entry, "chunks", None) or []]
            replicated_locations.update(sub.location for sub in subs)
        else:
            continue
        for sub in subs:
            if getattr(sub, "frame_bytes", None):
                partners[sub.location + FRAME_TABLE_SUFFIX] = sub.location

    replicated_reqs = [r for r in write_reqs if r.path in replicated_locations]
    shard_reqs = [r for r in write_reqs if r.path in shard_locations]
    partner_reqs = [r for r in write_reqs if r.path in partners]
    other_reqs = [
        r
        for r in write_reqs
        if r.path not in replicated_locations and r.path not in shard_locations and r.path not in partners
    ]
    if assignment is None:
        local_load = sum(_estimate(r) for r in other_reqs)
        offered = [(r.path, _estimate(r)) for r in shard_reqs]
        gathered = coordinator.all_gather_object((local_load, knobs.get_compression(), offered))
        codecs = [codec for _, codec, _ in gathered]
        if len(set(codecs)) > 1:
            raise CodecDivergenceError(codecs)
        loads: List[int] = [load for load, _, _ in gathered]
        assignment = _elect_shard_writers(loads, [offers for _, _, offers in gathered])
        assignment.update(greedy_assignment(loads, [(_estimate(r), r.path) for r in replicated_reqs]))
        _record_balance_metrics(loads, rank)
        for partner, payload in partners.items():
            if payload in assignment:
                assignment[partner] = assignment[payload]
            elif payload in replicated_locations:
                assignment[partner] = 0
    missing = [r.path for r in replicated_reqs if r.path not in assignment]
    missing += [r.path for r in partner_reqs if partners[r.path] in replicated_locations and r.path not in assignment]
    if missing:
        # A cached plan that does not know a replicated path means the take
        # fingerprint missed something that shapes storage paths; dropping
        # the request would commit an entry no rank writes.
        raise RuntimeError(
            f"plan-cache assignment is missing replicated write paths {missing[:5]}; "
            "set TSS_TORCH_PLAN_CACHE=0 to work around"
        )
    # A shard object nobody else offers is not in the assignment: its
    # holder writes it.
    mine = [r for r in replicated_reqs if assignment[r.path] == rank]
    mine += [r for r in shard_reqs + partner_reqs if assignment.get(r.path, rank) == rank]
    for entry in manifest.values():
        if isinstance(entry, ShardedArrayEntry):
            entry.shards = [s for s in entry.shards if assignment.get(s.tensor.location, rank) == rank]
    return other_reqs + mine, assignment


def _elect_shard_writers(loads: List[int], offers: List[List[Tuple[str, int]]]) -> Dict[str, int]:
    """``{location: writer}`` for each shard object that more than one rank
    offers (``offers[r]``: rank ``r``'s ``(location, bytes)``): biggest
    first onto the least-loaded of its holders, ties to the lower rank. An
    object one rank offers stays with it and counts in its load. ``loads``
    is updated in place, the same on every rank. Ranks that offer one
    object with different sizes hold different arrays at one path: raises
    ``ValueError`` on every rank."""
    holders: Dict[str, List[int]] = {}
    sizes: Dict[str, int] = {}
    for r, rank_offers in enumerate(offers):
        for loc, size in rank_offers:
            if sizes.setdefault(loc, size) != size:
                raise ValueError(
                    f"ranks {holders[loc]} and {r} offer shard object {loc} with different "
                    f"sizes ({sizes[loc]} and {size} bytes): different arrays at one path"
                )
            holders.setdefault(loc, []).append(r)
    shared: List[Tuple[int, str]] = []
    for loc, ranks in holders.items():
        if len(ranks) == 1:
            loads[ranks[0]] += sizes[loc]
        else:
            shared.append((sizes[loc], loc))
    assignment: Dict[str, int] = {}
    for size, loc in sorted(shared, key=lambda t: (-t[0], t[1])):
        target = min(holders[loc], key=lambda r: (loads[r], r))
        assignment[loc] = target
        loads[target] += size
    return assignment


def _record_balance_metrics(loads: List[int], rank: int) -> None:
    """The replicated writes' byte balance across ranks: the slowest rank
    gates the commit barrier."""
    if telemetry.get_active() is None:
        return
    telemetry.gauge_set("partitioner.local_load_bytes", loads[rank])
    telemetry.gauge_set("partitioner.load_max_bytes", max(loads))
    telemetry.gauge_set("partitioner.load_min_bytes", min(loads))
    mean = sum(loads) / len(loads) if loads else 0
    if mean > 0:
        telemetry.gauge_set("partitioner.load_balance", max(loads) / mean)


def shard_coverage_problem(global_manifest: Manifest) -> Optional[str]:  # spmd-pure
    """Why the shards the ranks wrote do not tile a sharded entry's global
    shape (a hole or an overlap), else None. Checked before commit: an
    entry with a hole would restore its target's stale values there."""
    by_path: Dict[str, Tuple[ShardedArrayEntry, List[Tuple[Tuple[int, ...], Tuple[int, ...]]]]] = {}
    for key, entry in global_manifest.items():
        if isinstance(entry, ShardedArrayEntry):
            _, _, path = key.partition("/")
            rects = by_path.setdefault(path, (entry, []))[1]
            rects.extend((tuple(s.offsets), tuple(s.sizes)) for s in entry.shards)
    for path, (entry, rects) in sorted(by_path.items()):
        shape = tuple(int(n) for n in entry.shape)
        total = 1
        for n in shape:
            total *= n
        rects = sorted(set(rects))
        covered = 0
        for off, sz in rects:
            if len(off) != len(shape) or any(o < 0 or o + z > n for o, z, n in zip(off, sz, shape)):
                return f"{path}: shard at {list(off)} of sizes {list(sz)} lies outside shape {list(shape)}"
            vol = 1
            for z in sz:
                vol *= z
            covered += vol
        for i, (off, sz) in enumerate(rects):
            for off2, sz2 in rects[i + 1 :]:
                if shape and off2[0] >= off[0] + sz[0]:
                    break
                if all(o2 < o + z and o < o2 + z2 for o, z, o2, z2 in zip(off, sz, off2, sz2)):
                    return f"{path}: shards at {list(off)} and {list(off2)} overlap"
        if covered != total:
            return (
                f"{path}: the ranks' shards cover {covered} of its {total} elements; "
                "no rank wrote the rest"
            )
    return None


def consolidate_replicated_entries(global_manifest: Manifest) -> None:
    """Make every rank's copy of a replicated entry reflect the writer's.

    Slab batching relocates an entry to ``batched/<uuid>`` with a
    ``byte_range`` on the rank that writes its bytes only, so the other
    ranks' copies go stale. Entries are merged in place per logical path,
    preferring relocated versions (chunk by chunk for chunked entries)."""
    by_path: Dict[str, List[Entry]] = {}
    for key, entry in global_manifest.items():
        if is_replicated(entry):
            _, _, path = key.partition("/")
            by_path.setdefault(path, []).append(entry)

    def relocated(e: ArrayEntry) -> bool:
        return e.byte_range is not None or e.raw_range is not None

    for entries in by_path.values():
        if isinstance(entries[0], ArrayEntry):
            chosen = next((e for e in entries if relocated(e)), entries[0])
            for e in entries:
                e.location = chosen.location
                e.byte_range = chosen.byte_range
                e.raw_range = chosen.raw_range
        elif isinstance(entries[0], ChunkedArrayEntry):
            chosen_chunks: Dict[Tuple[int, ...], object] = {}
            for e in entries:
                for chunk in e.chunks:
                    key = tuple(chunk.offsets)
                    if key not in chosen_chunks or relocated(chunk.tensor):
                        chosen_chunks[key] = chunk
            for e in entries:
                for i, chunk in enumerate(e.chunks):
                    e.chunks[i] = chosen_chunks[tuple(chunk.offsets)]

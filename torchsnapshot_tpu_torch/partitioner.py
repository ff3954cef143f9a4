"""Replicated-write load balancing across ranks.

A port of ``torchsnapshot_tpu/partitioner.py``. Every rank runs the same
deterministic greedy assignment on the same inputs (one ``all_gather`` of
the per-rank loads of non-replicated writes, integer byte counts), so no
broadcast is needed. Replicated storage paths carry no rank, so each rank
keeps exactly the write requests assigned to it. Every rank keeps every
replicated *entry* in its manifest, whoever writes the bytes.

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

from .io_preparers.array import FRAME_TABLE_SUFFIX
from .io_types import WriteReq
from .manifest import ArrayEntry, ChunkedArrayEntry, Entry, Manifest, is_replicated
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
    """The subset of ``write_reqs`` this rank executes, and the replicated
    ``{storage_path: writer_rank}`` assignment (``assignment``: a cached
    one to replay, with no collective)."""
    world_size = coordinator.get_world_size()
    rank = coordinator.get_rank()
    if world_size == 1:
        return write_reqs, {}

    replicated_locations = set()
    partners: Dict[str, str] = {}  # .ftab -> its payload
    for entry in manifest.values():
        if is_replicated(entry):
            subs = [entry] if hasattr(entry, "location") else []
            subs += [chunk.tensor for chunk in getattr(entry, "chunks", None) or []]
            for sub in subs:
                replicated_locations.add(sub.location)
                if getattr(sub, "frame_bytes", None):
                    partners[sub.location + FRAME_TABLE_SUFFIX] = sub.location

    replicated_reqs = [r for r in write_reqs if r.path in replicated_locations]
    partner_reqs = [r for r in write_reqs if r.path in partners]
    other_reqs = [
        r for r in write_reqs if r.path not in replicated_locations and r.path not in partners
    ]
    if assignment is None:
        local_load = sum(_estimate(r) for r in other_reqs)
        gathered = coordinator.all_gather_object((local_load, knobs.get_compression()))
        codecs = [codec for _, codec in gathered]
        if len(set(codecs)) > 1:
            raise CodecDivergenceError(codecs)
        loads: List[int] = [load for load, _ in gathered]
        assignment = greedy_assignment(loads, [(_estimate(r), r.path) for r in replicated_reqs])
        for partner, payload in partners.items():
            assignment[partner] = assignment.get(payload, 0)
    missing = [r.path for r in replicated_reqs + partner_reqs if r.path not in assignment]
    if missing:
        # A cached plan that does not know a replicated path means the take
        # fingerprint missed something that shapes storage paths; dropping
        # the request would commit an entry no rank writes.
        raise RuntimeError(
            f"plan-cache assignment is missing replicated write paths {missing[:5]}; "
            "set TSS_TORCH_PLAN_CACHE=0 to work around"
        )
    mine = [r for r in replicated_reqs + partner_reqs if assignment[r.path] == rank]
    return other_reqs + mine, assignment


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

"""Per-process prepared-take cache: ``prepare_write`` paid once per
structure, not once per take.

A port of ``torchsnapshot_tpu/prepare_cache.py``. Every decision of the
prepare stage (leaf classification, stager and manifest-entry
construction, the partition, slab batching) is a function of the take's
structure, which the take-plan fingerprint hashes (``take_plan.py``). So
the fingerprint keys a cache of the prepared artifacts themselves:

- the write requests after partition and batching (stagers built, slabs
  laid out, defer flags set);
- the local manifest's leaf entries (relocated into slabs);
- the partition's assignment.

On a hit, :meth:`PreparedTake.rebind` points each cached stager at the new
step's tensor (for an async take, the new fork K2 just made) and its
ready event, and resets per-take state; primitives, whose entries embed
their values, are rebuilt. Nothing the card holds is reused: a slab's K1
descriptor table is built at every launch from the stagers' current
tensors, so a hit never reads memory an earlier take's forks held.

Any structural disagreement the fingerprint should have caught (a leaf's
kind, whether it was captured, the device it stages from, its piece count)
raises :class:`RebindMismatch`, which the caller treats as a miss.

Concurrency: an entry's stagers serve one take at a time; ``acquire``
refuses a busy entry (an overlapping take misses and stores a
replacement), and ``release``, called when the pipeline completes either
way, *unbinds* every tensor so a cached entry pins no device or host
memory between takes.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .io_preparer import _as_tensor, classify
from .io_preparers.array import ArrayBufferStager, PollingTableStager, chunk_row_ranges
from .io_preparers.chunked_array import should_chunk
from .io_preparers.object import ObjectBufferStager
from .io_preparers.sharded_array import DTensorLeaf, local_unique_shards, subdivide
from .io_types import WriteReq
from .manifest import Entry, PrimitiveEntry
from .utils import knobs

Manifest = Dict[str, Entry]

# (fingerprint, storage plugin class, async): stagers carry async-dependent
# defer flags and plugin-dependent streaming, so one mode's state must not
# serve another.
CacheKey = Tuple[str, str, bool]


class RebindMismatch(RuntimeError):
    """The new step's tree disagrees with the cached plan; treat as a miss."""


def leaf_signature(value: Any, world_size: int, captured: bool) -> Tuple[str, bool, str]:
    """(kind, captured, device type staged from) of one leaf, as prepared."""
    kind = classify(value, world_size)
    t = value.local if isinstance(value, DTensorLeaf) else value
    device = t.device.type if isinstance(t, torch.Tensor) else "host"
    return kind, captured, device


@dataclass
class PreparedTake:
    """One structure's prepared artifacts (see the module docstring)."""

    key: CacheKey
    # {path: leaf_signature} recorded at preparation.
    leaf_kinds: Dict[str, Tuple[str, bool, str]]
    # {path: the write requests that leaf produced, in order}.
    leaf_index: Dict[str, List[WriteReq]]
    local_manifest: Manifest
    write_reqs: List[WriteReq]
    assignment: Dict[str, int]
    in_use: bool = field(default=False)
    hits: int = field(default=0)

    def rebind(
        self,
        flattened: Dict[str, Any],
        world_size: int,
        captured: Any,
        ready: Dict[torch.device, Any],
    ) -> Tuple[Manifest, List[WriteReq], Dict[str, int]]:
        """Bind this take's values (``flattened``, already captured for an
        async take; ``ready``: per device, the event after which they are
        final) into the cached stagers. Returns ``(local_manifest,
        write_reqs, assignment)``, the hit's stand-in for prepare_write,
        partition and batching. Raises :class:`RebindMismatch` when the
        tree disagrees with the cached plan."""
        if set(flattened) != set(self.leaf_kinds):
            raise RebindMismatch("leaf path set changed")
        for path, want in self.leaf_kinds.items():
            value = flattened[path]
            if leaf_signature(value, world_size, path in captured) != want:
                raise RebindMismatch(f"{path}: leaf kind, capture or device changed")
            kind = want[0]
            reqs = self.leaf_index.get(path, [])
            if kind == "primitive":
                old = self.local_manifest[path]
                self.local_manifest[path] = PrimitiveEntry.from_value(value, replicated=old.replicated)
            elif kind == "object":
                _rebind(path, [value], reqs, ObjectBufferStager, lambda s, v: s.rebind(v))
            else:
                pieces = _pieces_for(kind, value)
                _rebind(path, pieces, reqs, ArrayBufferStager, lambda s, t: s.rebind(t, ready.get(t.device)))
        from .batcher import CompressedSlabStager

        for req in self.write_reqs:
            if isinstance(req.buffer_stager, CompressedSlabStager):
                req.buffer_stager.reset_take()
        # A fresh list of the same requests: the pipeline may reorder it.
        return self.local_manifest, list(self.write_reqs), self.assignment

    def unbind(self) -> None:
        """Drop every tensor and object the cached stagers hold."""
        for reqs in self.leaf_index.values():
            for req in reqs:
                unbind = getattr(req.buffer_stager, "unbind", None)
                if unbind is not None:
                    unbind()


def _pieces_for(kind: str, value: Any) -> List[torch.Tensor]:
    """The leaf's staged pieces, in the order the preparers made them."""
    if kind == "sharded":
        pieces: List[torch.Tensor] = []
        itemsize = value.local.element_size()
        for data, offsets, sizes, replica_id in local_unique_shards(value):
            if replica_id != 0 or 0 in sizes:
                continue
            subs = subdivide(offsets, sizes, itemsize, knobs.get_max_shard_size_bytes())
            for sub_off, sub_sz in subs:
                if len(subs) == 1:
                    pieces.append(data)
                else:
                    rel = tuple(slice(o - bo, o - bo + s) for o, bo, s in zip(sub_off, offsets, sub_sz))
                    pieces.append(data[rel])
        return pieces
    if isinstance(value, DTensorLeaf):
        value = value.local
    tensor, _ = _as_tensor(value)
    if should_chunk(tensor):
        ranges = chunk_row_ranges(list(tensor.shape), tensor.element_size(), knobs.get_max_chunk_size_bytes())
        return [tensor[r0:r1] for r0, r1 in ranges]
    return [tensor]


def _rebind(path: str, values: List[Any], reqs: List[WriteReq], stager_type: type, bind) -> None:
    it = iter(values)
    bound = 0
    for req in reqs:
        stager = req.buffer_stager
        if isinstance(stager, stager_type):
            try:
                bind(stager, next(it))
            except StopIteration:
                raise RebindMismatch(f"{path}: fewer pieces than stagers") from None
            bound += 1
        elif not isinstance(stager, PollingTableStager):
            raise RebindMismatch(f"{path}: unexpected stager {type(stager).__name__}")
    if bound != len(values):
        raise RebindMismatch(f"{path}: {len(values)} pieces for {bound} stagers")


# ---------------------------------------------------------------------------
# The per-process store: an LRU of PREPARED_CACHE_SIZE entries on the
# long-lived coordinator, like the plan cache.
# ---------------------------------------------------------------------------

_ATTR = "_prepared_take_cache"
_LOCK = threading.Lock()


def _cache(coord) -> "OrderedDict[CacheKey, PreparedTake]":
    cache = getattr(coord, _ATTR, None)
    if cache is None:
        cache = OrderedDict()
        setattr(coord, _ATTR, cache)
    return cache


def acquire(coord, key: CacheKey) -> Optional[PreparedTake]:
    """A hit marks the entry busy until its pipeline :func:`release`\\ s
    it; a busy entry (an overlapping take of the same structure) misses."""
    with _LOCK:
        cache = _cache(coord)
        entry = cache.get(key)
        if entry is None or entry.in_use:
            return None
        entry.in_use = True
        entry.hits += 1
        cache.move_to_end(key)
        return entry


def store(coord, key: CacheKey, entry: PreparedTake) -> None:
    """Insert a freshly prepared entry (busy until released), replacing a
    same-key one, and trim idle LRU entries beyond the size knob (a busy
    evictee keeps its artifacts until its own release)."""
    with _LOCK:
        cache = _cache(coord)
        old = cache.pop(key, None)
        if old is not None and not old.in_use:
            old.unbind()
        entry.in_use = True
        cache[key] = entry
        while len(cache) > knobs.get_prepared_cache_size():
            _, evicted = cache.popitem(last=False)
            if not evicted.in_use:
                evicted.unbind()


def release(entry: Optional[PreparedTake]) -> None:
    """Pipeline completion (either way): unbind and return to the pool."""
    if entry is None:
        return
    with _LOCK:
        entry.unbind()
        entry.in_use = False


def invalidate(coord, key: CacheKey) -> None:
    """Drop one entry (the rebind-mismatch fallback)."""
    with _LOCK:
        entry = _cache(coord).pop(key, None)
        if entry is not None and not entry.in_use:
            entry.unbind()


def reset(coord) -> None:
    """Drop all of one coordinator's entries."""
    with _LOCK:
        cache = getattr(coord, _ATTR, None)
        if cache:
            for entry in cache.values():
                if not entry.in_use:
                    entry.unbind()
            cache.clear()


def stats(coord) -> Dict[str, Any]:
    """Entry count and per-entry hit counts."""
    with _LOCK:
        cache = _cache(coord)
        return {
            "entries": len(cache),
            "hits": {f"{k[0][:12]}:{'async' if k[2] else 'sync'}": e.hits for k, e in cache.items()},
        }

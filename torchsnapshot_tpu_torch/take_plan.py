"""Take planning: the preflight round and the cross-take plan cache.

A port of ``torchsnapshot_tpu/take_plan.py``. A training job takes
snapshots of the same structure every N steps; only the values and the
path change. Without a cache every take of a multi-rank job pays the whole
coordination bill: the partition ``all_gather`` (loads and codecs), the
planning-status ``all_gather`` and the manifest ``all_gather``, each
O(world) store reads on every rank. With it a steady-state take costs
constant store traffic per non-zero rank:

1. Every rank flattens its state (no collective) and hashes a
   *fingerprint* of what shapes the plan (:func:`compute_fingerprint`):
   logical paths, each leaf's dtype, shape, strides and device, a
   DTensor's mesh, placements and local shard, the world size, the
   replicated globs and every knob that shapes preparation. Not values,
   not the path.
2. One preflight round (:func:`preflight`: a ``gather_object`` to rank 0
   and a ``broadcast_object`` back) carries ``(path, base, globs,
   plan_token)``. Rank 0 takes its own path and base (warning on
   divergence; a catalog auto-base is resolved here, so the base may change
   from take to take on a hit as on a miss), intersects the globs, and
   decides HIT iff every rank holds
   a cached plan for its own fingerprint and all plans carry the same
   take-sequence token, i.e. were stored by one earlier take together.
3. On a HIT the partition replays the cached assignment (no gather), and
   the manifest exchange shrinks to a per-rank *delta* against the last
   take's entries (:func:`gather_manifest_delta`), gathered to rank 0,
   which alone needs the global manifest (it writes
   ``.snapshot_metadata``); the delta gather carries each rank's planning
   status, and rank 0 broadcasts the outcome, so a failure anywhere still
   fails every rank before any writes.

The port's counts on a HIT, per rank, on the store (``parallel/store.py``
counts them): 2 sets and 2 gets on a non-zero rank, 4 sets and
2 x world gets on rank 0. The JAX package pins 3 and 2 x world + 3
operations; the port adds the outcome broadcast.

Correctness: a rank whose structure changed holds no plan under its new
fingerprint and sends ``plan_token=None``, so rank 0 broadcasts MISS and
every rank runs the full path: the decision is itself collective, so ranks
never diverge on which collectives they issue (and a rank with the cache
off forces a MISS the same way). World size 1 runs no collective at all.
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .io_preparer import classify
from .io_preparers.sharded_array import DTensorLeaf, placement_key
from .manifest import Manifest, entry_from_dict, entry_to_dict
from .parallel.coordinator import Coordinator
from .partitioner import consolidate_replicated_entries, shard_coverage_problem
from .utils import knobs

logger = logging.getLogger(__name__)

# Keyset-divergence patterns already reported by this process (rank 0).
_WARNED_KEYSET_SIGS: Set[frozenset] = set()

# Bump when the fingerprint's payload or the cached plan's layout changes.
_FINGERPRINT_VERSION = 1


def _leaf_descriptor(value: Any, world_size: int) -> Tuple:
    """Everything about one leaf that shapes its staging, never its
    values: the kind; a tensor's dtype, shape, strides (a strided view is
    gathered by K3) and device; a DTensor's global shape, mesh shape,
    placements, mesh coordinate and local shard."""
    kind = classify(value, world_size)
    if kind in ("primitive", "object"):
        return (kind, type(value).__name__)
    if isinstance(value, np.ndarray):
        return (kind, value.dtype.str, tuple(value.shape))
    if isinstance(value, DTensorLeaf):
        t = value.local
        return (
            kind,
            str(t.dtype),
            tuple(value.global_shape),
            tuple(t.shape),
            tuple(t.stride()),
            t.device.type,
            t.device.index,
            tuple(value.mesh_shape),
            tuple(placement_key(p) for p in value.placements),
            value.coordinate,
            tuple(value.offsets),
            tuple(value.sizes),
        )
    t: torch.Tensor = value
    return (kind, str(t.dtype), tuple(t.shape), tuple(t.stride()), t.device.type, t.device.index)


def compute_fingerprint(flattened: Dict[str, Any], world_size: int, replicated_globs: List[str]) -> str:
    """Hash of the plan-shaping inputs: structure, placements and knobs."""
    knob_sig = (
        knobs.get_max_chunk_size_bytes(),
        knobs.get_max_shard_size_bytes(),
        knobs.get_slab_size_threshold_bytes(),
        knobs.is_batching_enabled(),
        knobs.is_device_batching_enabled(),
        knobs.get_compression(),
        knobs.get_compression_level(),
        knobs.get_compression_frame_bytes(),
        knobs.is_checksums_enabled(),
        # Raw strings, not resolved values: ``auto`` resolves per host, and
        # ranks with the same environment must agree.
        knobs.get_dedup_digests_env(),
        knobs.get_stream_writes_env(),
        knobs.get_hash_chunk_bytes(),
        knobs.get_stream_chunk_bytes(),
        knobs.get_stream_inflight(),
    )
    payload = (
        _FINGERPRINT_VERSION,
        world_size,
        tuple(sorted(set(replicated_globs))),
        knob_sig,
        tuple((path, _leaf_descriptor(value, world_size)) for path, value in sorted(flattened.items())),
    )
    return hashlib.sha256(repr(payload).encode()).hexdigest()


@dataclass
class CachedPlan:
    """What a hit reuses (per fingerprint, per process)."""

    # The take sequence number that stored this plan. Takes are SPMD, so
    # equal tokens on every rank certify the plans were made together.
    token: int
    # Replicated storage path -> writer rank (the partitioner's output).
    assignment: Dict[str, int]
    # This rank's last manifest as {logical path: entry dict}: the delta
    # baseline of the next take.
    local_entry_dicts: Dict[str, dict]
    # Rank 0 only: every rank's last entry dicts (the receiver's baseline).
    gathered_entry_dicts: Optional[List[Dict[str, dict]]]


@dataclass
class PreflightResult:
    hit: bool
    path: str
    base: Optional[str]
    replicated_globs: List[str]
    # The base's recorded chain length when rank 0 resolved it from the
    # catalog (>= 0; the take's own chain is one more), else -1 (an
    # explicit or absent base). Broadcast with the decision.
    base_chain_len: int = -1


@dataclass
class TakePlan:
    """The planning stage's output, consumed by ``Snapshot._take_impl``."""

    path: str
    base: Optional[str]
    replicated_globs: List[str]
    flattened: Dict[str, Any]
    manifest: Manifest  # container entries from flatten()
    rng_states: Dict[str, Tuple[Any, Any]]
    fingerprint: str
    cache_hit: bool
    cached: Optional[CachedPlan]
    # This rank's planning failure so far (reported collectively later).
    failure: Optional[Exception] = None
    # The planning phases so far, as ``take.phase`` spans
    # (``telemetry.PhaseTracker``); the take continues it.
    phase_tracker: Any = None
    # The prepared-take cache entry this take acquired or stored; released
    # when its pipeline completes, success or failure.
    prepared_entry: Any = None
    # See PreflightResult.base_chain_len.
    base_chain_len: int = -1


def get_plan_cache(coord: Coordinator) -> Dict[str, CachedPlan]:
    """The process's plan cache, on the long-lived coordinator (private
    coordinators get private caches)."""
    cache = getattr(coord, "_take_plan_cache", None)
    if cache is None:
        cache = {}
        coord._take_plan_cache = cache  # type: ignore[attr-defined]
    return cache


def probe_plan(coord: Coordinator, fingerprint: str) -> Optional[CachedPlan]:
    """Look a plan up and refresh its recency (insertion order is the LRU
    order), so a steadily hit plan survives structures passing through."""
    cache = get_plan_cache(coord)
    plan = cache.pop(fingerprint, None)
    if plan is not None:
        cache[fingerprint] = plan
    return plan


def store_plan(coord: Coordinator, fingerprint: str, plan: CachedPlan) -> None:
    """Insert or refresh a plan, keeping at most ``PLAN_CACHE_SIZE``."""
    cache = get_plan_cache(coord)
    cache.pop(fingerprint, None)
    cache[fingerprint] = plan
    while len(cache) > knobs.get_plan_cache_size():
        cache.pop(next(iter(cache)))


def preflight(
    coord: Coordinator,
    path: str,
    base: Optional[str],
    replicated_globs: List[str],
    plan_token: Optional[int],
    keys_sig: Optional[str] = None,
) -> PreflightResult:
    """One gather and one broadcast that canonicalise path, base and globs
    and decide hit or miss for every rank (see the module docstring).
    ``plan_token``: the token of this rank's cached plan for its own
    fingerprint, None when it holds none. ``keys_sig``: a checksum of this
    rank's top-level app-state keys, so rank 0 can warn about asymmetric
    keysets (a stateful whose ``state_dict`` issues collectives must exist
    on every rank)."""
    globs_local = sorted(set(replicated_globs))
    if coord.get_world_size() == 1:
        base, base_chain = _resolve_base(base, path)
        return PreflightResult(False, path, base, globs_local, base_chain)
    gathered = coord.gather_object((path, base, globs_local, plan_token, keys_sig), dst=0)
    decision = None
    if gathered is not None:  # rank 0
        paths, bases, globs, tokens, sigs = (list(x) for x in zip(*gathered))
        sig_set = frozenset(sigs)
        if len(sig_set) > 1 and sig_set not in _WARNED_KEYSET_SIGS:
            _WARNED_KEYSET_SIGS.add(sig_set)
            logger.warning(
                "Rank-divergent app_state keysets (key checksums %s). Per-rank "
                "statefuls are fine, but one whose state_dict() issues "
                "collectives must exist on every rank, or a later collective hangs.",
                sigs,
            )
        if any(p != paths[0] for p in paths):
            logger.warning("Rank-divergent snapshot paths %s; using rank 0's: %s", paths, paths[0])
        if any(b != bases[0] for b in bases):
            logger.warning("Rank-divergent base snapshots %s; using rank 0's: %s", bases, bases[0])
        common: Set[str] = set(globs[0])
        for g in globs[1:]:
            common &= set(g)
        dropped = set().union(*map(set, globs)) - common
        if dropped:
            logger.warning("Ignoring rank-asymmetric replicated globs: %s", dropped)
        hit = tokens[0] is not None and all(t == tokens[0] for t in tokens)
        # A catalog auto-base resolves here, on rank 0 only (from the chain
        # cache, or one catalog scan); the broadcast gives every rank the
        # resolved base and its chain length, on a hit as on a miss.
        base0, base_chain = _resolve_base(bases[0], paths[0])
        decision = (hit, paths[0], base0, sorted(common), base_chain)
    # Every rank issues the broadcast (the source posts, the rest read).
    hit, canonical_path, canonical_base, common_globs, base_chain = coord.broadcast_object(decision, src=0)
    return PreflightResult(hit, canonical_path, canonical_base, common_globs, base_chain)


def _resolve_base(base: Optional[str], path: str) -> Tuple[Optional[str], int]:
    """A catalog auto-base sentinel (``Snapshot.take(job=...)``) resolved
    into a base path and its recorded chain length; an explicit or absent
    base passes through with chain -1 (unknown). Local storage I/O only;
    the caller broadcasts the result."""
    from . import catalog as catalog_mod

    if base is None or not catalog_mod.is_auto_base(base):
        return base, -1
    resolved, chain = catalog_mod.resolve_auto_base(base, path)
    return resolved, (chain if resolved is not None else 0)


def gather_manifest_delta(
    manifest: Manifest,
    coord: Coordinator,
    cached: CachedPlan,
    status: Optional[str] = None,
) -> Tuple[Optional[Manifest], Optional[Tuple[int, str]]]:
    """The hit's manifest exchange: each rank sends rank 0 the entries
    whose dict changed since its last take (and the paths that vanished)
    with its planning ``status`` (None, or the failure's text); rank 0
    rebuilds the global manifest and broadcasts the outcome. Returns
    ``(global manifest on rank 0 else None, (failed rank, detail) or
    None)``. The baselines advance only when every rank succeeded."""
    local = {p: entry_to_dict(e) for p, e in manifest.items()} if status is None else {}
    delta = {p: d for p, d in local.items() if cached.local_entry_dicts.get(p) != d}
    removed = [p for p in cached.local_entry_dicts if p not in local] if status is None else []
    gathered = coord.gather_object((status, delta, removed), dst=0)
    global_manifest: Optional[Manifest] = None
    outcome = None
    if gathered is not None:  # rank 0
        failed = [(r, st) for r, (st, _, _) in enumerate(gathered) if st is not None]
        if failed:
            outcome = failed[0]
        else:
            merged_all: List[Dict[str, dict]] = []
            for r, (_, dlt, dels) in enumerate(gathered):
                merged = dict(cached.gathered_entry_dicts[r])
                merged.update(dlt)
                for p in dels:
                    merged.pop(p, None)
                merged_all.append(merged)
            global_manifest = {
                f"{r}/{p}": entry_from_dict(d) for r, m in enumerate(merged_all) for p, d in m.items()
            }
            consolidate_replicated_entries(global_manifest)
            problem = shard_coverage_problem(global_manifest)
            if problem is not None:
                outcome = (0, f"sharded entry does not tile its shape: {problem}")
            else:
                cached.gathered_entry_dicts = merged_all
    outcome = coord.broadcast_object(outcome, src=0)
    if outcome is None:
        cached.local_entry_dicts = local
    return global_manifest, outcome

"""Swarm restore: chunk-granular peer-to-peer fan-out.

Broadcast restore (``bcast.py``) moves each replicated object through the
store as one payload, so it stops at ``TSS_TORCH_BCAST_MAX_BYTES``. The
swarm covers larger objects whose sidecar record is a v2 tree digest (a
chunk grid of per-chunk sha256s and crc32s at a fixed grain): every rank
reads a distinct part of the chunk grid from the origin and receives the
rest from its peers through the coordinator's store, so the origin bytes
stay about one copy of the object at any world size.

- **SPMD.** The mode, the chunk grid and each chunk's server order are
  pure functions of the manifest entry, the knobs and the merged sidecars,
  identical on every rank; chunk ``k`` is served by
  ``reader_order(path, extent, world)[attempt]`` (the broadcast's sha1
  order, keyed per chunk).
- **Every chunk is verified** against its sidecar digest on receipt
  (unless ``TSS_TORCH_VERIFY_READS=off``): a corrupt origin read is
  quarantined and re-fetched once, then :class:`ReadVerificationError`; a
  corrupt chunk from a peer is attributed to that rank and healed by one
  direct origin read.
- **Never less available than a direct read.** A peer polls a chunk with
  ``try_get`` for ``TSS_TORCH_SWARM_CHUNK_DEADLINE_S``, then elects the
  next server; past ``TSS_TORCH_BCAST_REELECT_MAX`` re-elections it reads
  the chunk itself. A server whose read fails posts an error marker.
- **Bounded store.** Keys are fenced by a per-call token, the object, the
  chunk and the attempt. Each rank acks a chunk once it holds it; the last
  acker deletes the chunk's keys, so the store holds the chunks in flight.
  Posted keys also go to the coordinator's deferred deletion.
- **Need-aware reshard.** A sharded save restored onto DTensors sharded
  otherwise across ranks: each chunk's need set is the ranks whose
  overlap reads touch it (:func:`plan_reshard_need`, the same interval
  math as their reads). A chunk one rank needs is a plain read; a chunk
  several need is read once and traded. The pieces then reach each
  DTensor's local shard through the H2D and K3, as a reshard restore does.
- **Warm hosts.** A rank whose read cache holds the object serves its
  chunks from it; an assembled object is populated back into the cache
  (a reshard rank's chunk runs into its sparse tier).

``LAST_RESTORE_SWARM`` records this process's last restore: chunks and
bytes from the origin, peers and the cache, per object too, re-elections,
fallbacks and verification failures.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
import uuid
import zlib
from math import prod
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import hashing, telemetry
from .engine import qos as engine_qos
from .io_preparer import is_dtensor
from .io_types import ReadReq, StoragePlugin
from .manifest import ArrayEntry, ChunkedArrayEntry, Entry, ShardedArrayEntry
from .scheduler import ReadVerificationError, fetch_read_io
from .serialization import Serializer, string_to_dtype
from .storage_plugins.cloud_retry import CollectiveProgress
from .bcast import stall_watchdog
from .utils import knobs

logger = logging.getLogger(__name__)

LAST_RESTORE_SWARM: Dict[str, Any] = {}

_OK = b"O"
_ERR = b"E"


def reset_diagnostics() -> None:
    LAST_RESTORE_SWARM.clear()
    LAST_RESTORE_SWARM.update(
        {
            "objects": 0,
            "chunks": 0,
            "chunks_origin": 0,
            "chunks_peer": 0,
            "chunks_cache": 0,
            "origin_bytes": 0,
            "peer_bytes": 0,
            "cache_bytes": 0,
            "reelections": 0,
            "direct_fallbacks": 0,
            "verify_failures": 0,
            "peer_verify_failures": 0,
            # [(path, chunk)] this rank read from the origin: over all
            # ranks, each chunk once.
            "origin_reads": [],
            # [{"path", "chunk", "from_rank"}] peer chunks that failed.
            "peer_corruptions": [],
            "peer_chunks_verified": 0,
            # path -> {"origin_bytes", "peer_bytes", "cache_bytes"}.
            "per_object": {},
        }
    )


# ---------------------------------------------------------------------------
# Plan math: pure functions of manifest entries, knobs and merged sidecars.
# ---------------------------------------------------------------------------


def chunk_grid(  # spmd-pure
    digests: Optional[Dict[str, Any]], path: str
) -> Optional[Tuple[int, int, Optional[List[str]], Optional[List[int]]]]:
    """``(size, grain, chunk shas | None, chunk crcs | None)`` of a path
    whose record has a usable v2 chunk grid, else None. A grid whose shas
    do not fold to the recorded root is refused."""
    if not digests:
        return None
    rec = digests.get(path)
    info = hashing.record_chunk_info(rec)
    size = hashing.record_size(rec)
    if info is None or size is None:
        return None
    grain, shas, crcs = info
    if shas is not None and isinstance(rec, dict):
        root = rec.get("root")
        if root and hashing.tree_root(shas) != root:
            return None
    return size, grain, shas, crcs


def entry_locations(entry: Entry) -> List[str]:  # spmd-pure
    if isinstance(entry, ArrayEntry):
        return [entry.location]
    if isinstance(entry, ChunkedArrayEntry):
        return [c.tensor.location for c in entry.chunks]
    if isinstance(entry, ShardedArrayEntry):
        return [s.tensor.location for s in entry.shards]
    return []


def entry_swarmable(entry: Entry, digests: Optional[Dict[str, Any]]) -> bool:  # spmd-pure
    """Whether every object the entry reads has a v2 chunk grid."""
    locations = entry_locations(entry)
    return bool(locations) and all(chunk_grid(digests, p) is not None for p in locations)


class ObjectPlan:
    """One swarmed object: chunk extents from its grid, and per chunk the
    server order (restricted to the chunk's need set, when there is one;
    ``need`` None means every rank needs every chunk)."""

    __slots__ = ("path", "size", "grain", "shas", "crcs", "extents", "orders", "need")

    def __init__(self, path, size, grain, shas, crcs, extents, orders, need=None) -> None:
        self.path = path
        self.size = size
        self.grain = grain
        self.shas = shas
        self.crcs = crcs
        self.extents = extents
        self.orders = orders
        self.need = need


def need_order(path: str, byte_range: Tuple[int, int], members: frozenset) -> List[int]:  # spmd-pure
    """The server order of one chunk among the ranks that need it: the sha1
    election rotates the sorted need set."""
    from .bcast import elect_reader

    ranks = sorted(members)
    if not ranks:
        return []
    start = elect_reader(path, byte_range, len(ranks))
    return [ranks[(start + i) % len(ranks)] for i in range(len(ranks))]


def plan_objects(  # spmd-pure
    paths: List[str],
    digests: Optional[Dict[str, Any]],
    world: int,
    need_maps: Optional[Dict[str, List[frozenset]]] = None,
) -> List[ObjectPlan]:
    """The swarm plan of a path sequence; every rank passes the same
    ``paths``, ``digests`` and ``need_maps`` and gets the same plans."""
    from .bcast import reader_order

    plans: List[ObjectPlan] = []
    for path in paths:
        grid = chunk_grid(digests, path)
        if grid is None:
            raise ValueError(f"swarm-planned path has no chunk grid: {path}")
        size, grain, shas, crcs = grid
        extents = hashing.chunk_extents(size, grain)
        need = (need_maps or {}).get(path)
        if need is not None:
            if len(need) != len(extents):
                raise ValueError(
                    f"need map for {path} has {len(need)} chunks, grid has {len(extents)}"
                )
            orders = [need_order(path, ext, need[k]) for k, ext in enumerate(extents)]
        else:
            orders = [reader_order(path, ext, world) for ext in extents]
        plans.append(ObjectPlan(path, size, grain, shas, crcs, extents, orders, need))
    return plans


def _mesh_layout(live: Any) -> Tuple[List[int], List[int]]:
    """A DTensor's mesh shape and its ranks in C order of coordinates."""
    mesh = live.device_mesh
    return [int(s) for s in mesh.shape], [int(r) for r in mesh.mesh.flatten().tolist()]


def entry_reshardable(entry: Entry, live: Any, digests: Optional[Dict[str, Any]]) -> bool:  # spmd-pure
    """Whether a sharded save restored onto ``live`` suits the need-aware
    swarm: ``live`` a DTensor of the saved shape over a mesh of several
    ranks, every saved shard raw, non-scalar, a whole object (no byte
    range) with a v2 chunk grid."""
    if not isinstance(entry, ShardedArrayEntry) or not entry.shards or not is_dtensor(live):
        return False
    if [int(s) for s in live.shape] != [int(s) for s in entry.shape]:
        return False
    _, ranks = _mesh_layout(live)
    if len(set(ranks)) < 2:
        return False  # one rank's reads are already minimal
    for s in entry.shards:
        t = s.tensor
        if t.serializer != Serializer.RAW or not s.sizes:
            return False
        if t.byte_range is not None or t.raw_range is not None:
            return False
    return entry_swarmable(entry, digests)


def plan_reshard_need(  # spmd-pure
    entry: ShardedArrayEntry,
    live: Any,
    digests: Optional[Dict[str, Any]],
    world: int,
) -> Optional[Dict[str, List[frozenset]]]:
    """For each saved shard object, chunk ``k`` -> the ranks whose overlap
    reads (``shard_read_intervals`` with no budget and the chunk grain,
    the plan of their own reads) touch it; from the DTensor's placements
    and mesh alone, so the same on every rank. None where it cannot be
    derived (a mesh that does not span the world, such as one ``tp``
    group's ``mesh["dp"]``, whose plan each group would make over its own
    ranks; a rank outside the world; a chunk nobody reads): every rank
    then reads directly."""
    from .io_preparers.sharded_array import process_shard_map, shard_read_intervals

    mesh_shape, mesh_ranks = _mesh_layout(live)
    if sorted(mesh_ranks) != list(range(world)):
        return None
    pmap = process_shard_map(entry.shape, mesh_shape, list(live.placements), mesh_ranks)
    if len(pmap) < 2 or any(p < 0 or p >= world for p in pmap):
        return None
    need: Dict[str, List[frozenset]] = {}
    for shard in entry.shards:
        loc = shard.tensor.location
        grid = chunk_grid(digests, loc)
        if grid is None:
            return None
        size, grain, _shas, _crcs = grid
        payload = int(prod(shard.sizes)) * string_to_dtype(shard.tensor.dtype).itemsize
        if payload != size:
            return None
        extents = hashing.chunk_extents(size, grain)
        sets: List[set] = [set() for _ in extents]
        for p, rects in pmap.items():
            try:
                intervals = shard_read_intervals(shard, rects, None, grain=grain)
            except ValueError:
                return None
            if intervals is None:
                intervals = [(0, size)]
            for b, e in intervals:
                for k in range(b // grain, min(len(sets), -(e // -grain))):
                    sets[k].add(p)
        if any(not s for s in sets):
            return None
        need[loc] = [frozenset(s) for s in sets]
    return need


def chunk_check(data, shas, crcs, k: int, extent: Tuple[int, int]) -> Optional[str]:
    """Check one chunk's bytes against its recorded sha256 (else crc32)."""
    mv = memoryview(data).cast("B")
    want_len = extent[1] - extent[0]
    if mv.nbytes != want_len:
        return f"chunk {k}: {mv.nbytes} bytes != expected {want_len}"
    if shas is not None:
        got = hashlib.sha256(mv).hexdigest()
        return None if got == shas[k] else f"chunk {k}: sha256 {got} != recorded {shas[k]}"
    if crcs is not None:
        got_crc = zlib.crc32(mv)
        return None if got_crc == crcs[k] else f"chunk {k}: crc32 {got_crc} != recorded {crcs[k]}"
    return None


class SwarmItem:
    """One swarmed entry's reads and finalizer. ``paths``, when set, is the
    entry's whole object list (a reshard registers every shard object, so
    object indices agree across ranks whose reads differ)."""

    __slots__ = ("logical_path", "reqs", "finalize", "paths")

    def __init__(
        self,
        logical_path: str,
        reqs: List[ReadReq],
        finalize: Optional[Callable[[], None]],
        paths: Optional[List[str]] = None,
    ) -> None:
        self.logical_path = logical_path
        self.reqs = reqs
        self.finalize = finalize
        self.paths = paths


class _SwarmSession:
    """One :func:`run_swarm` call: keys ``swarmx/<token>/<obj>/<chunk>/<attempt>``
    and acks ``ack/<obj>/<chunk>`` beside them."""

    def __init__(self, coord, storage: StoragePlugin, executor, verify: bool) -> None:
        from .storage_plugins.cache import find_read_cache

        self.coord = coord
        self.storage = storage
        self.executor = executor
        self.verify = verify
        self.world = coord.get_world_size()
        token = coord.broadcast_object(uuid.uuid4().hex[:12] if coord.get_rank() == 0 else None, src=0)
        self.prefix = f"swarmx/{token}"
        self.ns = coord.store.prefix(self.prefix)
        self.posted: List[str] = []
        self.cache = find_read_cache(storage)
        # One transient-retry window for every origin read of this session.
        self.progress = CollectiveProgress()
        self._injector = None
        if knobs.get_faults_spec():
            from .faults import find_fault_injector

            self._injector = find_fault_injector(storage)

    async def _store_call(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(self.executor, fn, *args)

    @staticmethod
    def key(obj: int, k: int, attempt: int) -> str:
        return f"{obj}/{k}/{attempt}"

    async def post(self, obj: int, k: int, attempt: int, payload: bytes) -> None:
        key = self.key(obj, k, attempt)
        await self._store_call(self.ns.set, key, payload)
        self.posted.append(f"{self.prefix}/{key}")

    async def try_get_many(self, keys: List[str]) -> List[Optional[bytes]]:
        return await self._store_call(self.ns.try_get_many, keys)

    async def ack(self, obj: int, k: int, max_attempts: int, quorum: int) -> None:
        """This rank holds chunk ``(obj, k)``; the last of ``quorum``
        ackers deletes its payload keys and the counter."""
        n = await self._store_call(self.ns.add, f"ack/{obj}/{k}", 1)
        if n >= quorum:
            keys = [self.key(obj, k, a) for a in range(max_attempts)] + [f"ack/{obj}/{k}"]
            await self._store_call(self.ns.delete_many, keys)

    async def fetch_chunk_verified(self, plan: ObjectPlan, k: int) -> bytes:
        """One origin read of chunk ``k``, verified, with one quarantine
        and re-fetch on mismatch, then :class:`ReadVerificationError`."""
        loop = asyncio.get_running_loop()
        extent = plan.extents[k]
        # An origin fetch is the swarm's unit of storage bandwidth: a
        # strictly higher class in this process takes the next one.
        await engine_qos.pause_point()

        async def fetch_once() -> bytes:
            read_io = await fetch_read_io(self.storage, plan.path, extent, self.progress)
            return bytes(memoryview(read_io.buf).cast("B"))

        data = await fetch_once()
        if not self.verify:
            return data
        problem = await loop.run_in_executor(
            self.executor, chunk_check, data, plan.shas, plan.crcs, k, extent
        )
        if problem is None:
            return data
        telemetry.counter_add("swarm.verify_failures")
        LAST_RESTORE_SWARM["verify_failures"] += 1
        logger.warning(
            "swarm read of %s failed chunk verification (%s); quarantining cache "
            "entries and re-fetching once", plan.path, problem,
        )
        if self.cache is not None:
            await loop.run_in_executor(self.executor, self.cache.quarantine_path, plan.path)
        data = await fetch_once()
        problem = await loop.run_in_executor(
            self.executor, chunk_check, data, plan.shas, plan.crcs, k, extent
        )
        if problem is not None:
            telemetry.counter_add("swarm.verify_failures")
            LAST_RESTORE_SWARM["verify_failures"] += 1
            raise ReadVerificationError(
                f"swarm read of {plan.path} failed chunk verification twice ({problem}); "
                "persistent corruption at the source"
            )
        return data

    async def post_served(self, plan: ObjectPlan, obj: int, k: int, attempt: int, data) -> None:
        """Post chunk ``k`` for the peers. Under ``TSS_TORCH_FAULTS`` the
        ``peer_serve`` fault point runs first, on the posted copy only."""
        if self._injector is not None:
            data = bytearray(data)
            await self._injector.inject_peer_serve(f"{plan.path}#chunk{k}", data)
        await self.post(obj, k, attempt, _OK + bytes(data))

    async def cache_probe(self, plan: ObjectPlan) -> Optional[bytes]:
        if self.cache is None:
            return None
        data = await self.cache.try_read_object(plan.path)
        return data if data is not None and len(data) == plan.size else None

    async def cache_probe_range(self, plan: ObjectPlan, k: int) -> Optional[bytes]:
        if self.cache is None:
            return None
        b, e = plan.extents[k]
        try:
            data = await self.cache.try_read_range(plan.path, b, e)
        except Exception:  # noqa: BLE001 - a probe never fails the restore
            return None
        return data if data is not None and len(data) == e - b else None

    async def cache_populate(self, plan: ObjectPlan, buf: bytearray, have: List[bool]) -> None:
        if self.cache is None:
            return
        if all(have):
            await self.cache.populate_object(plan.path, bytes(buf))
            return
        # A reshard rank holds only its chunks: each run of held chunks
        # goes to the sparse tier.
        n, k = len(plan.extents), 0
        while k < n:
            if not have[k]:
                k += 1
                continue
            j = k
            while j < n and have[j]:
                j += 1
            b, e = plan.extents[k][0], plan.extents[j - 1][1]
            await self.cache.populate_range(plan.path, b, e, bytes(buf[b:e]))
            k = j


def run_swarm(
    items: List[SwarmItem],
    storage: StoragePlugin,
    coord,
    event_loop: asyncio.AbstractEventLoop,
    executor=None,
    digests: Optional[Dict[str, Any]] = None,
    need_maps: Optional[Dict[str, List[frozenset]]] = None,
) -> None:
    """The swarm phase of one stateful's swarmed entries, called at the
    same point on every rank with the same ``items``. Objects restore one
    after another (host memory: one object plus the chunks in flight);
    within one, this rank's assigned chunks are read from the origin
    (``TSS_TORCH_SWARM_FANOUT`` at a time) and posted as they land, while
    the rest are polled from peers. ``need_maps`` (``plan_reshard_need``)
    makes it need-aware: a rank touches only the chunks it needs, and acks
    count to the chunk's need set."""
    if not items:
        return
    if not LAST_RESTORE_SWARM:
        reset_diagnostics()
    rank = coord.get_rank()
    world = coord.get_world_size()
    verify = knobs.get_verify_reads_mode() != "off" and bool(digests)
    session = _SwarmSession(coord, storage, executor, verify)

    paths: List[str] = []
    for item in items:
        for p in item.paths if item.paths is not None else [req.path for req in item.reqs]:
            if p not in paths:
                paths.append(p)
    plans = plan_objects(paths, digests, world, need_maps)

    item_pending = [len(item.reqs) for item in items]
    for item in items:
        if not item.reqs and item.finalize is not None:
            item.finalize()
    deliveries: Dict[str, List[Tuple[int, ReadReq]]] = {}
    for i, item in enumerate(items):
        for req in item.reqs:
            deliveries.setdefault(req.path, []).append((i, req))

    deadline_s = knobs.get_swarm_chunk_deadline_s()
    fanout = knobs.get_swarm_fanout()
    reelect_max = knobs.get_bcast_reelect_max()
    max_attempts = 1 + min(reelect_max, world - 1)
    poll_s = max(0.01, min(0.05, deadline_s / 10.0))
    per_object = LAST_RESTORE_SWARM["per_object"]

    def needed_chunks(plan: ObjectPlan) -> List[int]:
        if plan.need is None:
            return list(range(len(plan.extents)))
        return [k for k in range(len(plan.extents)) if rank in plan.need[k]]

    total_chunks = sum(len(needed_chunks(p)) for p in plans)
    # Chunk arrivals are the stall watchdog's progress.
    tracker = telemetry.ProgressTracker()
    tracker.set_totals(requests=total_chunks, bytes_=0)
    pending_count = [total_chunks]

    def note_chunk(path: str, kind: str, nbytes: int) -> None:
        per_object.setdefault(path, {"origin_bytes": 0, "peer_bytes": 0, "cache_bytes": 0})[
            f"{kind}_bytes"
        ] += nbytes
        LAST_RESTORE_SWARM[f"{kind}_bytes"] += nbytes
        LAST_RESTORE_SWARM[f"chunks_{kind}"] += 1
        telemetry.counter_add(f"swarm.chunks_{kind}")
        telemetry.counter_add(f"swarm.{kind}_bytes", nbytes)
        tracker.note_staged(nbytes)
        tracker.note_request_done()
        pending_count[0] -= 1

    async def origin_fetch(plan: ObjectPlan, k: int) -> bytes:
        data = await session.fetch_chunk_verified(plan, k)
        LAST_RESTORE_SWARM["origin_reads"].append((plan.path, k))
        note_chunk(plan.path, "origin", len(data))
        return data

    async def restore_object(plan: ObjectPlan, obj: int) -> None:
        n = len(plan.extents)
        need = plan.need
        needed = needed_chunks(plan)
        if not needed:
            return

        def quorum(k: int) -> int:
            return world if need is None else len(need[k])

        buf = bytearray(plan.size)
        have = [False] * n

        def land(k: int, data: bytes) -> None:
            b, e = plan.extents[k]
            buf[b:e] = data
            have[k] = True

        # A warm host serves its assigned chunks from the cache; the
        # collective plan (serves, acks) is the same either way.
        cached = await session.cache_probe(plan)
        if cached is not None:
            buf[:] = cached
            have = [True] * n
            for k in needed:
                note_chunk(plan.path, "cache", plan.extents[k][1] - plan.extents[k][0])
        elif need is not None:
            for k in needed:
                data = await session.cache_probe_range(plan, k)
                if data is not None:
                    land(k, data)
                    note_chunk(plan.path, "cache", len(data))

        assigned = [k for k in needed if quorum(k) > 1 and plan.orders[k][0] == rank]
        sem = asyncio.Semaphore(fanout)
        acked = set()

        async def ack_once(k: int) -> None:
            if k not in acked and quorum(k) > 1:
                acked.add(k)
                await session.ack(obj, k, max_attempts, quorum(k))

        async def fetch_solo(k: int) -> None:
            async with sem:
                land(k, await origin_fetch(plan, k))

        async def serve_chunk(k: int) -> None:
            async with sem:
                try:
                    if not have[k]:
                        land(k, await origin_fetch(plan, k))
                    b, e = plan.extents[k]
                    await session.post_served(plan, obj, k, 0, buf[b:e])
                except ReadVerificationError:
                    raise
                except Exception as e:  # noqa: BLE001 - reported to peers
                    logger.warning("swarm server failed chunk %d of %s: %r", k, plan.path, e)
                    await session.post(obj, k, 0, _ERR + repr(e).encode())

        solo = [k for k in needed if quorum(k) <= 1 and not have[k]]
        await asyncio.gather(*(serve_chunk(k) for k in assigned), *(fetch_solo(k) for k in solo))
        for k in assigned:
            if have[k]:
                await ack_once(k)

        wanted = [k for k in needed if not have[k]]
        attempt = {k: 0 for k in wanted}
        deadline = {k: time.monotonic() + deadline_s for k in wanted}

        def att_max(k: int) -> int:
            return 1 + min(reelect_max, len(plan.orders[k]) - 1)

        async def take_direct(k: int, why: str) -> None:
            telemetry.counter_add("swarm.direct_fallbacks")
            LAST_RESTORE_SWARM["direct_fallbacks"] += 1
            logger.warning("swarm chunk %d of %s: %s; reading it directly", k, plan.path, why)
            land(k, await origin_fetch(plan, k))

        loop = asyncio.get_running_loop()
        while wanted:
            served_now = []
            for k in list(wanted):
                if plan.orders[k][attempt[k]] != rank:
                    continue
                # Re-elected, or this rank's first serve failed.
                try:
                    data = await origin_fetch(plan, k)
                except ReadVerificationError:
                    raise
                except Exception as e:  # noqa: BLE001 - reported to peers
                    await session.post(obj, k, attempt[k], _ERR + repr(e).encode())
                    raise
                land(k, data)
                await session.post_served(plan, obj, k, attempt[k], data)
                served_now.append(k)
            for k in served_now:
                wanted.remove(k)
                await ack_once(k)
            if not wanted:
                break
            payloads = await session.try_get_many([session.key(obj, k, attempt[k]) for k in wanted])
            now = time.monotonic()
            for k, payload in list(zip(list(wanted), payloads)):
                server = plan.orders[k][attempt[k]]
                if payload is None:
                    if now < deadline[k]:
                        continue
                    if attempt[k] + 1 < att_max(k):
                        telemetry.counter_add("swarm.reelections")
                        LAST_RESTORE_SWARM["reelections"] += 1
                        logger.warning(
                            "swarm server rank %d missed the %.1fs deadline for chunk %d "
                            "of %s; electing rank %d", server, deadline_s, k, plan.path,
                            plan.orders[k][attempt[k] + 1],
                        )
                        attempt[k] += 1
                        deadline[k] = now + deadline_s
                    else:
                        wanted.remove(k)
                        await take_direct(k, "re-election budget exhausted")
                        await ack_once(k)
                    continue
                wanted.remove(k)
                if payload[:1] == _ERR:
                    await take_direct(
                        k, f"server rank {server} failed ({payload[1:].decode(errors='replace')})"
                    )
                    await ack_once(k)
                    continue
                data = payload[1:]
                problem = None
                if verify:
                    problem = await loop.run_in_executor(
                        executor, chunk_check, data, plan.shas, plan.crcs, k, plan.extents[k]
                    )
                if problem is not None:
                    telemetry.counter_add("swarm.verify_failures")
                    LAST_RESTORE_SWARM["peer_verify_failures"] += 1
                    LAST_RESTORE_SWARM["peer_corruptions"].append(
                        {"path": plan.path, "chunk": k, "from_rank": server}
                    )
                    logger.warning(
                        "swarm chunk %d of %s from rank %d failed verification (%s); "
                        "reading it directly", k, plan.path, server, problem,
                    )
                    land(k, await origin_fetch(plan, k))
                else:
                    land(k, data)
                    if verify:
                        LAST_RESTORE_SWARM["peer_chunks_verified"] += 1
                    note_chunk(plan.path, "peer", len(data))
                await ack_once(k)
            if wanted:
                # A fleet wait edge per round: the ranks serving what this
                # rank still waits for.
                telemetry.fleet.note_blocked(
                    "swarm.chunk", sorted({plan.orders[k][attempt[k]] for k in wanted} - {rank})
                )
                await asyncio.sleep(poll_s)
        telemetry.fleet.clear_blocked("swarm.chunk")

        # Chunks this rank held from its cache still count to the quorum.
        for k in needed:
            await ack_once(k)
        await session.cache_populate(plan, buf, have)
        view = memoryview(buf)
        for item_index, req in deliveries.get(plan.path, []):
            if req.byte_range is not None:
                b, e = req.byte_range
                await req.buffer_consumer.consume_buffer(view[b:e], executor)
            else:
                await req.buffer_consumer.consume_buffer(view, executor)
            item_pending[item_index] -= 1
            if item_pending[item_index] == 0 and items[item_index].finalize is not None:
                items[item_index].finalize()

    async def drive() -> None:
        async with stall_watchdog(tracker, rank, lambda: {"swarm_wait": pending_count[0]}):
            for obj, plan in enumerate(plans):
                await restore_object(plan, obj)

    telemetry.counter_add("swarm.objects", len(plans))
    telemetry.counter_add("swarm.chunks", total_chunks)
    LAST_RESTORE_SWARM["objects"] += len(plans)
    LAST_RESTORE_SWARM["chunks"] += total_chunks
    with telemetry.span("swarm.restore", cat="restore", objects=len(plans), chunks=total_chunks, world=world):
        try:
            event_loop.run_until_complete(drive())
        finally:
            telemetry.fleet.clear_blocked("swarm.chunk")
            coord.defer_delete_many(session.posted)

"""Single-reader broadcast restore of replicated entries.

A serving fleet restores the same replicated weights on every rank; left
alone, that is ``world_size`` reads of every replicated object from the
origin. With broadcast restore on (``TSS_TORCH_BCAST_RESTORE``), each
object elects one reader (sha1 of its path and range, so reads spread over
the ranks); the reader fetches it and posts the bytes to the coordinator's
store, and every other rank polls for them. Each rank then consumes the
bytes locally: they are copied into the pinned host target before its H2D,
never moved to the card from pageable memory.

- **SPMD.** Eligibility and the read plan are pure functions of the
  manifest entry, the knobs and the kind of target, never of per-rank
  state: eligible entries are planned with no memory-budget split.
- **Bounded.** Objects above ``TSS_TORCH_BCAST_MAX_BYTES`` (256 MiB) are
  not broadcast (the swarm covers them); the phase holds this rank's
  fetches and one payload in flight.
- **Never less available than a direct read.** Payload keys are fenced by
  a per-call token and a per-object attempt. A peer polls with
  ``try_get`` until ``TSS_TORCH_BCAST_READER_DEADLINE_S`` and then elects
  the next rank in the sha1 order; after ``REELECT_MAX``
  re-elections it reads the origin itself. A reader whose fetch fails
  posts an error marker, and peers read directly at once. With the
  sidecars at hand (and ``TSS_TORCH_VERIFY_READS`` not ``off``) every
  payload is verified before it is posted, with one re-fetch on mismatch.

``LAST_RESTORE_BCAST`` records this process's last restore: the objects
read from the origin here and received from peers, their bytes,
re-elections and direct fallbacks.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from .io_preparer import is_dtensor
from .io_types import ReadReq, StoragePlugin
from .manifest import ArrayEntry, ChunkedArrayEntry, Entry, ObjectEntry, ShardedArrayEntry
from .scheduler import MAX_CONCURRENT_IO, _read_digest_record, _verify_checker, verified_fetch
from .serialization import COMPRESSED, array_nbytes
from .utils import knobs

logger = logging.getLogger(__name__)

LAST_RESTORE_BCAST: Dict[str, Any] = {}

# Re-elections per object (or swarm chunk) before a peer reads it from the
# origin itself: the JAX package's default.
REELECT_MAX = 1

# One byte before a payload, so an error report rides the same fenced key.
_OK = b"O"
_ERR = b"E"

Key = Tuple[str, Optional[Tuple[int, int]]]


def reset_diagnostics() -> None:
    LAST_RESTORE_BCAST.clear()
    LAST_RESTORE_BCAST.update(
        {
            "origin_reads": [],
            "received": [],
            "origin_bytes": 0,
            "recv_bytes": 0,
            "entries": 0,
            "reelections": 0,
            "direct_fallbacks": 0,
            # storage path -> {"origin_bytes", "peer_bytes"} as this rank
            # got it; summed over ranks, an object's origin bytes are its
            # size, not world x its size.
            "per_object": {},
        }
    )


def entry_cost_bytes(entry: ArrayEntry) -> int:
    """Host bytes of one array entry (a compressed one counts twice: the
    payload and its decoded bytes)."""
    try:
        n = array_nbytes(entry.shape, entry.dtype)
    except Exception:  # noqa: BLE001 - an unknown dtype: a conservative guess
        return 1024 * 1024
    return 2 * n if entry.serializer in COMPRESSED else n


def is_fully_replicated_target(live: Any) -> bool:  # spmd-pure
    """Whether every rank restores the whole array into ``live``: a plain
    tensor, a host array or no target, or a DTensor whose placements are
    all ``Replicate()``."""
    if is_dtensor(live):
        from .io_preparers.sharded_array import is_fully_replicated_sharding

        return is_fully_replicated_sharding(live.placements)
    return True


def replicated_read_cost(entry: Entry, live: Any) -> Optional[int]:  # spmd-pure
    """The bytes every rank would read of this entry in a direct restore
    when they are the same bytes on every rank, else None (not replicated,
    a compressed slab member, a sharded save onto a sharded target). A
    replicated pickled object records no size: 0."""
    if isinstance(entry, ArrayEntry):
        if not entry.replicated or entry.raw_range is not None:
            return None
        return entry_cost_bytes(entry)
    if isinstance(entry, ChunkedArrayEntry):
        if not entry.replicated or any(c.tensor.raw_range is not None for c in entry.chunks):
            return None
        return sum(entry_cost_bytes(c.tensor) for c in entry.chunks)
    if isinstance(entry, ObjectEntry):
        return 0 if entry.replicated else None
    if isinstance(entry, ShardedArrayEntry):
        # Saved sharded, restored replicated (train sharded, serve
        # replicated): every rank reads every shard.
        if any(s.tensor.raw_range is not None for s in entry.shards):
            return None
        if not is_fully_replicated_target(live):
            return None
        return sum(entry_cost_bytes(s.tensor) for s in entry.shards)
    return None


def eligible(entry: Entry, live: Any) -> bool:  # spmd-pure
    cost = replicated_read_cost(entry, live)
    return cost is not None and cost <= knobs.get_broadcast_max_bytes()


def select_restore_mode(  # spmd-pure
    entry: Entry,
    live: Any,
    bcast_enabled: bool,
    swarm_enabled: bool,
    digests: Optional[Dict[str, Any]],
) -> str:
    """``direct``, ``bcast``, ``swarm`` or ``reshard`` for one entry, the
    same on every rank: replicated up to ``BCAST_MAX_BYTES`` -> bcast;
    replicated above it, every object with a v2 chunk grid -> swarm; a
    sharded save onto DTensors sharded otherwise across ranks, chunk
    gridded -> reshard (the need-aware swarm); else direct."""
    from . import swarm as swarm_mod

    cost = replicated_read_cost(entry, live)
    if cost is None:
        if swarm_enabled and swarm_mod.entry_reshardable(entry, live, digests):
            return "reshard"
        return "direct"
    if cost <= knobs.get_broadcast_max_bytes():
        return "bcast" if bcast_enabled else "direct"
    if swarm_enabled and swarm_mod.entry_swarmable(entry, digests):
        return "swarm"
    return "direct"


def elect_reader(path: str, byte_range: Optional[Tuple[int, int]], world: int) -> int:  # spmd-pure
    """The rank that reads one object: sha1, not ``hash``, so every
    process agrees whatever its hash seed."""
    key = f"{path}|{byte_range}"
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:4], "big") % max(1, world)


def reader_order(path: str, byte_range: Optional[Tuple[int, int]], world: int) -> List[int]:  # spmd-pure
    """The elected reader, then its successors modulo ``world``: attempt
    ``a`` is served by ``order[a]``."""
    first = elect_reader(path, byte_range, world)
    return [(first + i) % max(1, world) for i in range(max(1, world))]


class BroadcastItem:
    """One eligible entry's planned reads and finalizer."""

    __slots__ = ("logical_path", "reqs", "finalize")

    def __init__(
        self, logical_path: str, reqs: List[ReadReq], finalize: Optional[Callable[[], None]]
    ) -> None:
        self.logical_path = logical_path
        self.reqs = reqs
        self.finalize = finalize


class _BcastSession:
    """One :func:`run_broadcast` call: keys ``bcastx/<token>/<object>/<attempt>``
    (the token from rank 0 fences restores apart), posted keys handed to
    the coordinator's deferred deletion, and the verified fetch."""

    def __init__(self, coord, storage: StoragePlugin, executor, digests) -> None:
        self.coord = coord
        self.storage = storage
        self.executor = executor
        self.digests = digests
        token = coord.broadcast_object(uuid.uuid4().hex[:12] if coord.get_rank() == 0 else None, src=0)
        self.prefix = f"bcastx/{token}"
        self.ns = coord.store.prefix(self.prefix)
        self.verify = knobs.get_verify_reads_mode() != "off" and bool(digests)

    async def _store_call(self, fn, *args):
        # Store round trips off the event loop.
        return await asyncio.get_running_loop().run_in_executor(self.executor, fn, *args)

    async def post(self, idx: int, attempt: int, payload: bytes) -> None:
        key = f"{idx}/{attempt}"
        await self._store_call(self.ns.set, key, payload)
        self.coord.defer_delete(f"{self.prefix}/{key}")

    async def try_get(self, idx: int, attempt: int) -> Optional[bytes]:
        return await self._store_call(self.ns.try_get, f"{idx}/{attempt}")

    async def fetch_verified(self, key: Key) -> bytes:
        """One origin read, verified when the sidecars cover it: a reader
        must never fan corrupt bytes out to the fleet."""
        path, byte_range = key
        want = _read_digest_record(self.digests, path) if self.verify else None
        checker = _verify_checker(want, byte_range) if want is not None else None
        read_io = await verified_fetch(
            self.storage, path, byte_range, checker, self.executor, what="broadcast read"
        )
        return bytes(memoryview(read_io.buf).cast("B"))


async def _poll(session: _BcastSession, idx: int, attempt: int, deadline: float, poll_s: float):
    """Poll one fenced key until it holds a payload or ``deadline`` passes
    (None). ``try_get`` only: a blocking get would wait out the store's own
    timeout, not the reader deadline."""
    while True:
        payload = await session.try_get(idx, attempt)
        if payload is not None:
            return payload
        if time.monotonic() >= deadline:
            return None
        await asyncio.sleep(poll_s)


def run_broadcast(
    items: List[BroadcastItem],
    storage: StoragePlugin,
    coord,
    event_loop: asyncio.AbstractEventLoop,
    executor=None,
    digests: Optional[Dict[str, Any]] = None,
) -> None:
    """The broadcast phase of one stateful's eligible entries, called at
    the same point on every rank with the same ``items``. This rank's
    elected reads run first, concurrently, each posted as it lands; then
    the objects are consumed in order, each from this rank's fetch, a
    peer's post, a re-elected reader's post, or a direct read."""
    if not items:
        return
    if not LAST_RESTORE_BCAST:
        reset_diagnostics()
    rank = coord.get_rank()
    world = coord.get_world_size()
    session = _BcastSession(coord, storage, executor, digests)

    keys: List[Key] = []
    key_to_idx: Dict[Key, int] = {}
    for item in items:
        for req in item.reqs:
            key = (req.path, tuple(req.byte_range) if req.byte_range is not None else None)
            if key not in key_to_idx:
                key_to_idx[key] = len(keys)
                keys.append(key)
    orders = {key: reader_order(key[0], key[1], world) for key in keys}
    fetched: Dict[Key, bytes] = {}
    deadline_s = knobs.get_bcast_reader_deadline_s()
    # order[] has world distinct ranks; more attempts would wrap back.
    max_attempts = 1 + min(REELECT_MAX, world - 1)
    poll_s = max(0.01, min(0.05, deadline_s / 10.0))

    async def fetch_assigned() -> None:
        sem = asyncio.Semaphore(MAX_CONCURRENT_IO)

        async def fetch_one(key: Key) -> None:
            idx = key_to_idx[key]
            async with sem:
                try:
                    data = await session.fetch_verified(key)
                except Exception as e:  # noqa: BLE001 - reported to peers
                    # Peers read directly at once; this rank retries at
                    # consume time and fails there if it must.
                    logger.warning("elected reader failed to read %s: %r", key[0], e)
                    await session.post(idx, 0, _ERR + repr(e).encode())
                    return
            fetched[key] = data
            await session.post(idx, 0, _OK + data)

        await asyncio.gather(*(fetch_one(k) for k in keys if orders[k][0] == rank))

    async def obtain(key: Key) -> Tuple[bytes, str]:
        """This rank's bytes of one object and how they came:
        ``fetched``, ``received`` or ``direct``."""
        idx = key_to_idx[key]
        order = orders[key]
        for attempt in range(max_attempts):
            reader = order[attempt]
            if reader == rank:
                if key in fetched:
                    return fetched[key], "fetched"
                # Re-elected, or the first fetch failed: serve this attempt.
                try:
                    data = await session.fetch_verified(key)
                except Exception as e:  # noqa: BLE001 - reported to peers
                    await session.post(idx, attempt, _ERR + repr(e).encode())
                    raise
                await session.post(idx, attempt, _OK + data)
                fetched[key] = data
                return data, "fetched"
            payload = await _poll(session, idx, attempt, time.monotonic() + deadline_s, poll_s)
            if payload is not None and payload[:1] == _OK:
                return payload[1:], "received"
            if payload is None:
                if attempt + 1 < max_attempts:
                    LAST_RESTORE_BCAST["reelections"] += 1
                    logger.warning(
                        "broadcast reader rank %d missed the %.1fs deadline for %s; "
                        "electing rank %d", reader, deadline_s, key[0], order[attempt + 1],
                    )
                continue
            logger.warning(
                "broadcast reader rank %d failed to read %s (%s); reading it directly",
                reader, key[0], payload[1:].decode(errors="replace"),
            )
            break
        LAST_RESTORE_BCAST["direct_fallbacks"] += 1
        return await session.fetch_verified(key), "direct"

    async def drive() -> None:
        await fetch_assigned()
        obtained: Dict[Key, Tuple[bytes, str]] = {}
        per_object = LAST_RESTORE_BCAST["per_object"]
        for item in items:
            for req in item.reqs:
                key = (req.path, tuple(req.byte_range) if req.byte_range is not None else None)
                if key not in obtained:
                    obtained[key] = await obtain(key)
                    data, how = obtained[key]
                    rec = per_object.setdefault(key[0], {"origin_bytes": 0, "peer_bytes": 0})
                    rec["peer_bytes" if how == "received" else "origin_bytes"] += len(data)
                data, how = obtained[key]
                if how == "received":
                    LAST_RESTORE_BCAST["received"].append(key[0])
                    LAST_RESTORE_BCAST["recv_bytes"] += len(data)
                await req.buffer_consumer.consume_buffer(memoryview(data), executor)
            if item.finalize is not None:
                item.finalize()

    LAST_RESTORE_BCAST["entries"] += len(items)
    event_loop.run_until_complete(drive())
    if fetched:
        LAST_RESTORE_BCAST["origin_reads"].extend(sorted(k[0] for k in fetched))
        LAST_RESTORE_BCAST["origin_bytes"] += sum(len(v) for v in fetched.values())

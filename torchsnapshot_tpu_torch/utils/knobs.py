"""Environment knobs of the port, under the ``TSS_TORCH_`` prefix.

A subset of ``torchsnapshot_tpu/utils/knobs.py``, with the same defaults:
the layout and digest settings the format tests pin, batching, the
host memory budget, the shard size, the barrier timeout, the
collective sanitizer, compression (codec, level, frame size), the plan and
prepared-take caches, the streaming mode, the native O_DIRECT engine,
read verification, the read cache, and the broadcast and swarm restores.
The JAX package's tuning knobs (thread and I/O widths, the D2H window,
device batching, the async device copy, checksums off) are constants here
until a workload needs another value. The prefix differs from the JAX package's on purpose, so
the two packages' settings never alias. Context-manager overrides let
tests force chunking, batching or small hash grains on tiny tensors.
"""

from __future__ import annotations

import contextlib
import os
from typing import Generator, Optional

_P = "TSS_TORCH_"
_ENV_MAX_CHUNK = _P + "MAX_CHUNK_SIZE_BYTES"
_ENV_ENABLE_BATCHING = _P + "ENABLE_BATCHING"
_ENV_DEDUP_DIGESTS = _P + "DEDUP_DIGESTS"
_ENV_HASH_CHUNK = _P + "HASH_CHUNK_BYTES"
_ENV_STREAM_CHUNK = _P + "STREAM_CHUNK_BYTES"
_ENV_MEMORY_BUDGET = _P + "PER_RANK_MEMORY_BUDGET_BYTES"
_ENV_MAX_SHARD = _P + "MAX_SHARD_SIZE_BYTES"
_ENV_BARRIER_TIMEOUT = _P + "BARRIER_TIMEOUT_S"
_ENV_DEBUG_COLLECTIVES = _P + "DEBUG_COLLECTIVES"
_ENV_COMPRESSION = _P + "COMPRESSION"
_ENV_COMPRESSION_LEVEL = _P + "COMPRESSION_LEVEL"
_ENV_COMPRESSION_FRAME = _P + "COMPRESSION_FRAME_BYTES"
_ENV_PLAN_CACHE = _P + "PLAN_CACHE"
_ENV_PLAN_CACHE_SIZE = _P + "PLAN_CACHE_SIZE"
_ENV_PREPARED_CACHE = _P + "PREPARED_CACHE"
_ENV_PREPARED_CACHE_SIZE = _P + "PREPARED_CACHE_SIZE"
_ENV_STREAM_WRITES = _P + "STREAM_WRITES"
_ENV_STREAM_INFLIGHT = _P + "STREAM_INFLIGHT"
_ENV_DISABLE_NATIVE_IO = _P + "DISABLE_NATIVE_IO"
_ENV_DIRECT_IO_THRESHOLD = _P + "DIRECT_IO_THRESHOLD_BYTES"
_ENV_DIRECT_IO_CONCURRENCY = _P + "DIRECT_IO_CONCURRENCY"
_ENV_DIRECT_IO_CHUNK = _P + "DIRECT_IO_CHUNK_BYTES"
_ENV_READ_CACHE_DIR = _P + "READ_CACHE_DIR"
_ENV_READ_CACHE_BYTES = _P + "READ_CACHE_BYTES"
_ENV_READ_CACHE_VERIFY = _P + "READ_CACHE_VERIFY"
_ENV_VERIFY_READS = _P + "VERIFY_READS"
_ENV_BCAST_RESTORE = _P + "BCAST_RESTORE"
_ENV_BCAST_MAX_BYTES = _P + "BCAST_MAX_BYTES"
_ENV_BCAST_READER_DEADLINE = _P + "BCAST_READER_DEADLINE_S"
_ENV_SWARM_RESTORE = _P + "SWARM_RESTORE"
_ENV_SWARM_CHUNK_DEADLINE = _P + "SWARM_CHUNK_DEADLINE_S"

_FALSE = ("0", "", "false", "False", "off")


def _get_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    return int(val) if val is not None else default


def _get_bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    return default if val is None else val not in _FALSE


def get_max_chunk_size_bytes() -> int:
    """Arrays above this many bytes are split into dim-0 chunk objects."""
    return _get_int(_ENV_MAX_CHUNK, 512 * 1024 * 1024)


def get_max_shard_size_bytes() -> int:
    """Local shards above this many bytes are written as several pieces,
    cut along the shard's largest dim."""
    return _get_int(_ENV_MAX_SHARD, 512 * 1024 * 1024)


def get_barrier_timeout_s() -> float:
    """Seconds a commit barrier or a coordinator collective waits for the
    slowest rank (it waits out that rank's whole data write)."""
    val = os.environ.get(_ENV_BARRIER_TIMEOUT)
    return float(val) if val is not None else 1800.0


def is_debug_collectives_enabled() -> bool:
    """The collective lockstep sanitizer (``collective_tracer.py``): every
    coordinator collective and barrier phase is journaled and cross-checked
    across ranks at each barrier. Off allocates nothing."""
    return _get_bool(_ENV_DEBUG_COLLECTIVES, False)


def is_batching_enabled() -> bool:
    """Coalesce small arrays into ``batched/<uuid>`` slab objects."""
    return _get_bool(_ENV_ENABLE_BATCHING, False)


def get_dedup_digests_env() -> str:
    """The raw knob string, ``auto`` included: the take fingerprint folds
    this in rather than the resolved value, which depends on the host's
    core count, so ranks with the same environment agree."""
    return os.environ.get(_ENV_DEDUP_DIGESTS, "auto").lower()


def is_dedup_digests_enabled(has_base: bool = False) -> bool:
    """Record a sha256 beside each crc32, the identity incremental takes
    match objects by. ``auto``: on with more than one usable core, and
    whenever the take passes ``base=``. A snapshot taken without them
    cannot serve as a base: pin ``1`` for every take of an incremental
    chain."""
    val = get_dedup_digests_env()
    if val in ("auto", ""):
        return has_base or len(os.sched_getaffinity(0)) > 1
    return val not in _FALSE


def get_stream_chunk_bytes() -> int:
    """Bytes per streamed append (and the default hash grain)."""
    return max(1, _get_int(_ENV_STREAM_CHUNK, 64 * 1024 * 1024))


def get_hash_chunk_bytes() -> int:
    """Grain of the chunked hashing; 0 is the serial v1 fold."""
    val = os.environ.get(_ENV_HASH_CHUNK)
    if val is None:
        return get_stream_chunk_bytes()
    return max(0, int(val))


def get_compression() -> str:
    """Codec of array payloads: ``none`` (default), ``zstd`` or ``zlib``.
    Recorded per entry, so restore needs no knob. ``zstd`` needs the
    ``zstandard`` package: without it a take raises here, at planning,
    never writing uncompressed bytes in its place."""
    val = os.environ.get(_ENV_COMPRESSION, "none").lower()
    if val in ("", "0", "false", "off"):
        return "none"
    if val not in ("none", "zstd", "zlib"):
        raise ValueError(f"{_ENV_COMPRESSION}={val!r}: expected 'none', 'zstd' or 'zlib'")
    if val == "zstd":
        try:
            import zstandard  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                f"{_ENV_COMPRESSION}=zstd requires the 'zstandard' package; "
                "install it or use 'zlib'"
            ) from e
    get_compression_level(_codec=val)
    return val


def get_compression_level(_codec: Optional[str] = None) -> int:
    """Codec level (zstd 1-22, default 3; zlib 0-9, default 1)."""
    codec = _codec if _codec is not None else get_compression()
    if codec == "none":
        return 1  # unused; a stale level must not fail an uncompressed take
    val = os.environ.get(_ENV_COMPRESSION_LEVEL)
    if val is None:
        return 3 if codec == "zstd" else 1
    level = int(val)
    lo, hi = (1, 22) if codec == "zstd" else (0, 9)
    if not lo <= level <= hi:
        raise ValueError(f"{_ENV_COMPRESSION_LEVEL}={level} out of range for {codec} ({lo}-{hi})")
    return level


def get_compression_frame_bytes() -> int:
    """Raw bytes per independent compression frame of an array whose raw
    size exceeds it (default 8 MiB); 0 writes single-blob payloads. Frames
    keep budgeted sub-reads of big compressed objects byte-range
    addressable."""
    return _get_int(_ENV_COMPRESSION_FRAME, 8 * 1024 * 1024)


def is_plan_cache_enabled() -> bool:
    """Reuse a multi-rank take's plan (replicated-write assignment, the
    manifest baseline) when the next take has the same structure
    (``take_plan.py``). A rank with it off forces a global miss."""
    return _get_bool(_ENV_PLAN_CACHE, True)


def get_plan_cache_size() -> int:
    """Distinct structures whose plans a process keeps (LRU)."""
    return max(1, _get_int(_ENV_PLAN_CACHE_SIZE, 4))


def is_prepared_cache_enabled() -> bool:
    """Reuse a take's prepared stagers and write requests when the next
    take has the same structure (``prepare_cache.py``)."""
    return _get_bool(_ENV_PREPARED_CACHE, True)


def get_prepared_cache_size() -> int:
    """Distinct prepared takes a process keeps (LRU). Cached stagers hold
    no tensor between takes."""
    return max(1, _get_int(_ENV_PREPARED_CACHE_SIZE, 4))


# The last streaming decision ``stream_select`` made under ``auto`` (None
# before any), so code without a storage plugin in hand can read it.
_STREAM_AUTO_RESOLVED: Optional[bool] = None


def get_stream_writes_mode() -> str:
    """``on``, ``off`` or ``auto`` (default): under ``auto`` each write
    pipeline streams only where ``stream_select`` measured streaming at
    least as fast as whole-buffer writes on that storage plugin (it
    streams until both sides have credible evidence)."""
    val = os.environ.get(_ENV_STREAM_WRITES, "auto").lower()
    if val in ("auto", ""):
        return "auto"
    return "off" if val in ("0", "false", "off") else "on"


def get_stream_writes_env() -> str:
    """The raw knob string (a fingerprint input, like the dedup one)."""
    return os.environ.get(_ENV_STREAM_WRITES, "auto")


def note_stream_auto_resolution(enabled: Optional[bool]) -> None:
    global _STREAM_AUTO_RESOLVED
    _STREAM_AUTO_RESOLVED = enabled


def is_stream_writes_enabled() -> bool:
    """The streaming decision in force: the forced mode, or under ``auto``
    the last resolved one (True before any)."""
    mode = get_stream_writes_mode()
    if mode == "auto":
        return _STREAM_AUTO_RESOLVED if _STREAM_AUTO_RESOLVED is not None else True
    return mode == "on"


def get_stream_inflight() -> int:
    """Chunks a streamed write may hold staged but not yet written
    (default 4): the stream's depth, and its admission cost in chunks."""
    return max(1, _get_int(_ENV_STREAM_INFLIGHT, 4))


def get_memory_budget_bytes() -> int:
    """Host bytes a pipeline may hold staged at once."""
    val = os.environ.get(_ENV_MEMORY_BUDGET)
    if val is not None:
        return int(val)
    available = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return min(int(available * 0.6), 32 * 1024**3)


def is_native_io_enabled() -> bool:
    """Use the native O_DIRECT engine (``native/``) for large transfers;
    ``TSS_TORCH_DISABLE_NATIVE_IO=1`` turns it off."""
    return os.environ.get(_ENV_DISABLE_NATIVE_IO, "0") in _FALSE


def get_direct_io_threshold_bytes() -> int:
    """Writes and reads of at least this many bytes go through the native
    engine (default 4 MiB); smaller ones stay buffered in Python."""
    return _get_int(_ENV_DIRECT_IO_THRESHOLD, 4 * 1024 * 1024)


# Ranks sharing this host (one disk): from LOCAL_WORLD_SIZE, which torchrun
# and this package's launcher set, else 1.
_local_world_size: Optional[int] = None


def set_local_world_size(n: int) -> None:
    global _local_world_size
    _local_world_size = max(1, int(n))


def get_local_world_size() -> int:
    if _local_world_size is not None:
        return _local_world_size
    return max(1, _get_int("LOCAL_WORLD_SIZE", 1))


def get_direct_io_concurrency() -> int:
    """Concurrent O_DIRECT transfers per storage plugin. The default, 2,
    is divided by the ranks sharing the host's disk; an explicit value is
    used as it is."""
    val = os.environ.get(_ENV_DIRECT_IO_CONCURRENCY)
    if val is not None:
        return max(1, int(val))
    return max(1, 2 // get_local_world_size())


def get_direct_io_chunk_bytes() -> int:
    """Bounce-buffer bytes of one native O_DIRECT transfer step."""
    return _get_int(_ENV_DIRECT_IO_CHUNK, 64 * 1024 * 1024)


def get_read_cache_dir() -> Optional[str]:
    """Root of the content-addressed read-through cache
    (``storage_plugins/cache.py``); unset (default) disables it. Its
    on-disk layout is the JAX package's, so one directory serves both."""
    return os.environ.get(_ENV_READ_CACHE_DIR) or None


def get_read_cache_bytes() -> int:
    """Byte budget of the read cache (default 10 GiB); least recently used
    entries are evicted past it after each populate."""
    return max(0, _get_int(_ENV_READ_CACHE_BYTES, 10 * 1024**3))


def get_verify_reads_mode() -> str:
    """Read-side verification against the checksum sidecars: ``auto``
    (default: cache hits and broadcast/swarm payloads are verified, origin
    reads of the direct pipeline are trusted), ``all`` (``1``: every
    full-object or chunk-covering fetch is verified too, with one re-fetch
    before :class:`~..scheduler.ReadVerificationError`), ``off`` (``0``:
    nothing, cache hits included)."""
    val = os.environ.get(_ENV_VERIFY_READS, "auto").lower()
    if val in ("", "auto"):
        return "auto"
    return "off" if val in _FALSE else "all"


def is_origin_read_verify_enabled() -> bool:
    return get_verify_reads_mode() == "all"


def is_read_cache_verify_enabled() -> bool:
    """Verify cache hits against their recorded digests before serving
    (default on; ``VERIFY_READS=off`` turns it off too)."""
    if get_verify_reads_mode() == "off":
        return False
    return _get_bool(_ENV_READ_CACHE_VERIFY, True)


def _collective_restore_enabled(name: str, world_size: int) -> bool:
    if world_size <= 1:
        return False
    val = os.environ.get(name, "auto").lower()
    if val in ("auto", ""):
        # Off on every storage, where the JAX package turns it on for all but
        # the local disk: the payloads ride the coordinator's c10d TCPStore,
        # one server that every byte crosses twice, and on one H100 80GB HBM3
        # (700 W) two ranks restored through it at 0.10-0.17 GB/s each
        # against 1.16-1.42 GB/s for direct reads (chip_smoke.py phase 6).
        return False
    return val not in _FALSE


def is_broadcast_restore_enabled(world_size: int) -> bool:
    """Single-reader restore of replicated entries up to
    ``BCAST_MAX_BYTES``: one elected rank reads each object and the bytes
    fan out over the coordinator's store. ``auto`` (default) is off until a
    faster channel than the store is measured; ``1``/``0`` force it."""
    return _collective_restore_enabled(_ENV_BCAST_RESTORE, world_size)


def get_broadcast_max_bytes() -> int:
    """Largest replicated object restored by broadcast (default 256 MiB);
    it bounds the store payload and the host memory of the phase."""
    return max(1, _get_int(_ENV_BCAST_MAX_BYTES, 256 * 1024 * 1024))


def get_bcast_reader_deadline_s() -> float:
    """Seconds a peer polls for the elected reader's payload before it
    re-elects the next rank in the sha1 order (default 60)."""
    try:
        return max(0.05, float(os.environ.get(_ENV_BCAST_READER_DEADLINE, 60.0)))
    except ValueError:
        return 60.0


def is_swarm_restore_enabled(world_size: int) -> bool:
    """Chunk-granular peer-to-peer restore of replicated objects above
    ``BCAST_MAX_BYTES`` (and of reshards shared by several ranks): each
    rank reads a distinct part of each object's v2 chunk grid and trades
    the rest through the store. The same ``auto`` gate as broadcast."""
    return _collective_restore_enabled(_ENV_SWARM_RESTORE, world_size)


def get_swarm_chunk_deadline_s() -> float:
    """Seconds a swarm peer polls for one chunk before it re-elects the
    next server in the chunk's sha1 order (default 30)."""
    try:
        return max(0.05, float(os.environ.get(_ENV_SWARM_CHUNK_DEADLINE, 30.0)))
    except ValueError:
        return 30.0


@contextlib.contextmanager
def _override_env(name: str, value: str) -> Generator[None, None, None]:
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            del os.environ[name]
        else:
            os.environ[name] = prev


def override_max_chunk_size_bytes(value: int):
    return _override_env(_ENV_MAX_CHUNK, str(value))


def override_batching_enabled(enabled: bool):
    return _override_env(_ENV_ENABLE_BATCHING, "1" if enabled else "0")


def override_hash_chunk_bytes(value: int):
    return _override_env(_ENV_HASH_CHUNK, str(value))


def override_stream_chunk_bytes(value: int):
    return _override_env(_ENV_STREAM_CHUNK, str(value))


def override_max_shard_size_bytes(value: int):
    return _override_env(_ENV_MAX_SHARD, str(value))


def override_barrier_timeout_s(value: float):
    return _override_env(_ENV_BARRIER_TIMEOUT, str(value))


def override_debug_collectives(enabled: bool):
    return _override_env(_ENV_DEBUG_COLLECTIVES, "1" if enabled else "0")


def override_compression(codec: str):
    return _override_env(_ENV_COMPRESSION, codec)


def override_compression_frame_bytes(value: int):
    return _override_env(_ENV_COMPRESSION_FRAME, str(value))


def override_stream_writes_mode(mode: str):
    return _override_env(_ENV_STREAM_WRITES, mode)


"""Environment knobs of the port, under the ``TSS_TORCH_`` prefix.

A subset of ``torchsnapshot_tpu/utils/knobs.py``, with the same defaults:
the layout and digest settings the format tests pin, batching, the
host memory budget, the shard size, the barrier timeout, the
collective sanitizer, compression (codec, level, frame size), the plan and
prepared-take caches, and the streaming mode. The JAX package's tuning
knobs (thread and I/O widths, the D2H window, device batching, the async
device copy, checksums off) are constants here until a workload needs
another value. The prefix differs from the JAX package's on purpose, so
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

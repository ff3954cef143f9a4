"""Environment knobs of the port, under the ``TSS_TORCH_`` prefix.

Every knob of ``torchsnapshot_tpu/utils/knobs.py`` has a counterpart here
with the same parsing and default, except the deliberate differences
``ROADMAP.md`` lists: the coordinator's address, rank and world size (the
port's coordinator rides ``torch.distributed``'s c10d store), the test
launcher's drain, and two defaults: the D2H window's (512 MiB, where the
JAX package's is 128 MB) and eager D2H's (off, where the JAX package's is
on). The prefix differs from the JAX package's on
purpose, so the two packages' settings never alias. Every knob the JAX
package gives an ``override_*`` context manager has one here, with the
same name and value encoding: it sets the variable for its block and
restores the previous value (or its absence) on exit.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Any, Generator, Optional

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
_ENV_SWARM_FANOUT = _P + "SWARM_FANOUT"
_ENV_BCAST_REELECT_MAX = _P + "BCAST_REELECT_MAX"
_ENV_CATALOG = _P + "CATALOG"
_ENV_MAX_CHAIN_LEN = _P + "MAX_CHAIN_LEN"

logger = logging.getLogger(__name__)

_FALSE = ("0", "", "false", "False", "off")


def _get_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    return int(val) if val is not None else default


# Switches that read some strings otherwise than the port did before it
# took the JAX package's parsing: name -> the strings whose meaning changed.
_warned_reparsed: set = set()


def _warn_if_reparsed(name: str, val: Optional[str], changed: tuple, now: bool) -> None:
    """Log once per switch when it reads a string whose meaning changed."""
    if val in changed and name not in _warned_reparsed:
        _warned_reparsed.add(name)
        logger.warning(
            "%s=%r now turns it %s, as the JAX package reads it; it turned it %s "
            "before. Set 0 or 1.", name, val, "on" if now else "off", "off" if now else "on",
        )


def _on_unless_off(name: str) -> bool:
    """A default-on switch, parsed as the JAX package parses its own
    (``off`` and the empty string, once off, now leave it on)."""
    val = os.environ.get(name)
    _warn_if_reparsed(name, val, ("off", ""), True)
    return (val if val is not None else "1") not in ("0", "false", "False")


def _off_unless_on(name: str) -> bool:
    """A default-off switch, parsed as the JAX package parses its own
    (``off``, once off, now turns it on)."""
    val = os.environ.get(name)
    on = (val if val is not None else "") not in ("", "0", "false", "False")
    _warn_if_reparsed(name, val, ("off",), on)
    return on


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
    return _off_unless_on(_ENV_DEBUG_COLLECTIVES)


def is_batching_enabled() -> bool:
    """Coalesce small arrays into ``batched/<uuid>`` slab objects."""
    return _off_unless_on(_ENV_ENABLE_BATCHING)


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
    return _on_unless_off(_ENV_PLAN_CACHE)


def get_plan_cache_size() -> int:
    """Distinct structures whose plans a process keeps (LRU)."""
    return max(1, _get_int(_ENV_PLAN_CACHE_SIZE, 4))


def is_prepared_cache_enabled() -> bool:
    """Reuse a take's prepared stagers and write requests when the next
    take has the same structure (``prepare_cache.py``)."""
    return _on_unless_off(_ENV_PREPARED_CACHE)


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


def get_memory_budget_override_bytes() -> Optional[int]:
    """The per-rank staging budget, verbatim, when set; else None and
    ``scheduler.get_process_memory_budget_bytes`` derives it."""
    val = os.environ.get(_ENV_MEMORY_BUDGET)
    return int(val) if val is not None else None


def is_native_io_enabled() -> bool:
    """Use the native O_DIRECT engine (``native/``) for large transfers;
    ``TSS_TORCH_DISABLE_NATIVE_IO=1`` turns it off."""
    val = os.environ.get(_ENV_DISABLE_NATIVE_IO)
    _warn_if_reparsed(_ENV_DISABLE_NATIVE_IO, val, ("off",), True)
    return (val if val is not None else "0") in ("0", "", "false", "False")


def get_direct_io_threshold_bytes() -> int:
    """Writes and reads of at least this many bytes go through the native
    engine (default 4 MiB); smaller ones stay buffered in Python."""
    return _get_int(_ENV_DIRECT_IO_THRESHOLD, 4 * 1024 * 1024)


# Ranks sharing this host (one disk): set by
# ``scheduler.derive_local_world_size`` from a hostname gather over a
# coordinator of several processes; before any such gather,
# LOCAL_WORLD_SIZE (which torchrun and this package's launcher set), else 1.
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
    return _on_unless_off(_ENV_READ_CACHE_VERIFY)


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
    return val not in ("0", "false", "off")


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


def get_bcast_reelect_max() -> int:
    """Reader re-elections per broadcast object (and per swarm chunk)
    before a peer stops waiting and reads it from the origin itself
    (default 1, floor 0)."""
    return max(0, _get_int(_ENV_BCAST_REELECT_MAX, 1))


def get_swarm_fanout() -> int:
    """Concurrent chunk transfers per swarm object: this rank's origin
    fetches plus the chunks it serves (default 8, floor 1)."""
    return max(1, _get_int(_ENV_SWARM_FANOUT, 8))


def is_catalog_enabled() -> bool:
    """The bucket catalog (``catalog.py``). Off, a ``job=`` take is a
    plain full take: no auto-base, no commit-time record, no chain-cache
    refresh, and a ``job=`` restore appends no rollout record."""
    return os.environ.get(_ENV_CATALOG, "1").lower() not in ("0", "false", "off")


def get_max_chain_len() -> int:
    """The depth at which a ``job=`` take without ``max_chain_len=``
    refuses its auto-selected base and rebases to a full snapshot (default
    16, floor 1)."""
    return max(1, _get_int(_ENV_MAX_CHAIN_LEN, 16))


# -- telemetry (the JAX package's knobs and defaults) ------------------------

_ENV_TRACE = _P + "TRACE"
_ENV_TELEMETRY_ARTIFACTS = _P + "TELEMETRY_ARTIFACTS"
_ENV_STALL_WARN_S = _P + "STALL_WARN_S"
_ENV_RECORDER = _P + "RECORDER"
_ENV_RECORDER_CAPACITY = _P + "RECORDER_CAPACITY"
_ENV_RECORDER_INTERVAL_S = _P + "RECORDER_INTERVAL_S"
_ENV_RECORDER_DUMP = _P + "RECORDER_DUMP"
_ENV_STEP_TELEMETRY = _P + "STEP_TELEMETRY"
_ENV_FLEET_TELEMETRY = _P + "FLEET_TELEMETRY"
_ENV_FLEET_BEACON_S = _P + "FLEET_BEACON_S"
_ENV_CLI_TRACEBACK = _P + "CLI_TRACEBACK"


def get_trace_path() -> Optional[str]:
    """Chrome/Perfetto trace destination: when set, every take, async_take
    and restore records a telemetry session and writes it here when the
    operation ends (rank 0 the path verbatim, rank N the path plus
    ``.rankN``)."""
    return os.environ.get(_ENV_TRACE) or None


def is_telemetry_artifacts_enabled() -> bool:
    """Persist the per-rank artifact ``.telemetry/rank_<k>.json`` inside
    every snapshot (fail-open; on by default). Off, and with no trace or
    ``_telemetry=``, an operation runs with no session at all."""
    return _on_unless_off(_ENV_TELEMETRY_ARTIFACTS)


def get_stall_warn_s() -> float:
    """Seconds without byte progress after which the write pipeline's
    watchdog logs one structured stall warning (0 or unset: off)."""
    val = os.environ.get(_ENV_STALL_WARN_S)
    return float(val) if val else 0.0


def is_recorder_enabled() -> bool:
    """The process-wide flight recorder of engine samples (on by default)."""
    return _on_unless_off(_ENV_RECORDER)


def get_recorder_capacity() -> int:
    """Flight-recorder ring capacity in samples (default 4096, at least 16)."""
    return max(16, _get_int(_ENV_RECORDER_CAPACITY, 4096))


def get_recorder_interval_s() -> float:
    """Least spacing of two engine samples of one engine (default 0.25 s)."""
    try:
        return max(0.0, float(os.environ.get(_ENV_RECORDER_INTERVAL_S, 0.25)))
    except ValueError:
        return 0.25


def get_recorder_dump_path() -> Optional[str]:
    """File the flight recorder mirrors its ring to (at most once a second),
    for ``python -m torchsnapshot_tpu_torch monitor``; unset: no mirror."""
    return os.environ.get(_ENV_RECORDER_DUMP) or None


def is_step_telemetry_enabled() -> bool:
    """A ``job=`` take's commit appends a step record under
    ``<bucket>/.catalog/telemetry/``, and a ``restore(job=)`` a rollout
    record (on by default; needs the artifacts)."""
    return _on_unless_off(_ENV_STEP_TELEMETRY)


def get_fleet_telemetry_mode() -> str:
    """Fleet beacons over the coordinator store: ``auto`` (default: on when
    the coordinator spans several processes), ``1`` or ``0``."""
    val = os.environ.get(_ENV_FLEET_TELEMETRY, "auto").strip().lower()
    if val in ("0", "false", "off"):
        return "0"
    if val in ("1", "true", "on"):
        return "1"
    return "auto"


def get_fleet_beacon_s() -> float:
    """Least spacing of two beacon publishes of one process (default 0.5 s)."""
    try:
        return max(0.05, float(os.environ.get(_ENV_FLEET_BEACON_S, 0.5)))
    except ValueError:
        return 0.5


def is_cli_traceback_enabled() -> bool:
    """The CLI raises with a traceback instead of a one-line error."""
    return _off_unless_on(_ENV_CLI_TRACEBACK)


def env_fingerprint() -> dict:
    """Every ``TSS_TORCH_*`` variable set, verbatim (the artifact's
    environment fingerprint)."""
    return {k: v for k, v in sorted(os.environ.items()) if k.startswith(_P)}


# -- QoS classes and the budget ledger (the JAX package's defaults) ---------

_ENV_QOS = _P + "QOS"
_ENV_QOS_POLL_S = _P + "QOS_POLL_S"
_ENV_QOS_MAX_PAUSE_S = _P + "QOS_MAX_PAUSE_S"
_ENV_DEBUG_LEDGER = _P + "DEBUG_LEDGER"


def is_qos_enabled() -> bool:
    """Priority-aware admission (``engine/qos.py``): while an operation of
    a higher class (FOREGROUND > NORMAL > BACKGROUND) has registered demand
    in this process, engines of lower classes admit no new work (budget,
    pool slots, stream chunks) until it clears; work in flight finishes.
    Off: every operation competes first come, first served."""
    return os.environ.get(_ENV_QOS, "1") not in ("0", "false", "False")


def get_qos_poll_s() -> float:
    """How often a paused engine re-checks the arbiter (default 20 ms)."""
    val = os.environ.get(_ENV_QOS_POLL_S)
    return float(val) if val else 0.02


def get_qos_max_pause_s() -> float:
    """Starvation bound: an engine paused this long (default 60 s) admits
    one round of work anyway and re-arms. 0: no bound."""
    val = os.environ.get(_ENV_QOS_MAX_PAUSE_S)
    return float(val) if val else 60.0


def is_debug_ledger_enabled() -> bool:
    """The budget-ledger sanitizer (``ledger.py``): every engine budget
    journals each debit with its owner and call site, and pipelines assert
    zero outstanding bytes at close and on every abort path, raising
    ``LedgerLeakError`` naming the leaking sites. Off allocates nothing."""
    return os.environ.get(_ENV_DEBUG_LEDGER, "") not in ("", "0", "false", "False")


# -- capture, transfer and pipeline sizing (the JAX package's defaults) -----

_ENV_SLAB_SIZE_THRESHOLD = _P + "SLAB_SIZE_THRESHOLD_BYTES"
_ENV_DEVICE_BATCHING = _P + "DEVICE_BATCHING"
_ENV_ASYNC_DEVICE_COPY = _P + "ASYNC_DEVICE_COPY"
_ENV_ASYNC_FORK_HBM_LIMIT = _P + "ASYNC_FORK_HBM_LIMIT_BYTES"
_ENV_ASYNC_EAGER_D2H = _P + "ASYNC_EAGER_D2H"
_ENV_ASYNC_CAPTURE = _P + "ASYNC_CAPTURE"
_ENV_CHECKSUMS = _P + "CHECKSUMS"
_ENV_RESTORE_OVERLAP = _P + "RESTORE_OVERLAP"
_ENV_D2H_LANES = _P + "D2H_LANES"
_ENV_D2H_WINDOW = _P + "D2H_WINDOW_BYTES"
_ENV_HASH_WORKERS = _P + "HASH_WORKERS"
_ENV_STAGING_THREADS = _P + "STAGING_THREADS"
_ENV_MAX_CONCURRENT_IO = _P + "MAX_CONCURRENT_IO"
_ENV_CONSUMING_THREADS = _P + "CONSUMING_THREADS"
_ENV_READ_MERGE_GAP = _P + "READ_MERGE_GAP_BYTES"

_OFF = ("0", "false", "False")


def get_slab_size_threshold_bytes() -> int:
    """Raw tensors below this many bytes join ``batched/<uuid>`` slabs,
    and a slab closes at it (default 128 MiB)."""
    return _get_int(_ENV_SLAB_SIZE_THRESHOLD, 128 * 1024 * 1024)


def is_device_batching_enabled() -> bool:
    """Pack a slab of one device's tensors on the card (K1) and fetch it
    with one D2H copy (default on). Off, a CUDA slab stages each member's
    own D2H and concatenates on the host."""
    return os.environ.get(_ENV_DEVICE_BATCHING, "1") not in _OFF


def is_async_device_copy_enabled() -> bool:
    """Fork CUDA tensors on the card (K2) at ``async_take`` (default on).
    Off is ``ASYNC_CAPTURE=donate``: :func:`get_async_capture_mode` reads
    both and decides."""
    return os.environ.get(_ENV_ASYNC_DEVICE_COPY, "1") not in _OFF


def get_async_fork_hbm_limit_bytes() -> Optional[int]:
    """A simulated free-device-memory cap for the async fork: a fork that
    would bring the take's cumulative forked bytes above it counts as out
    of memory, which sends the capture down its degraded path (bisect,
    fork what fits, host-capture the rest) without real memory pressure.
    Unset (default): only a real ``torch.cuda.OutOfMemoryError`` does."""
    val = os.environ.get(_ENV_ASYNC_FORK_HBM_LIMIT)
    return int(val) if val is not None else None


def is_async_eager_d2h_enabled() -> bool:
    """Start the D2H of this rank's deferred requests at ``async_take``,
    right after partition: the copies run on the transfer lanes while
    training resumes, into pinned host buffers that the background staging
    consumes. Those buffers sit outside the staging budget, bounded by the
    captured state. Off (default, where the JAX package's is on): every
    byte is budgeted and the D2H runs in the drain. On one NVIDIA H100
    80GB HBM3 at 700 W the drain is write-bound either way, and eager D2H
    lengthened the stall and, in most runs, the first training step after
    it (``chip_smoke.py`` phase 11 (a))."""
    val = os.environ.get(_ENV_ASYNC_EAGER_D2H)
    return val is not None and val not in _OFF


def get_async_capture_mode() -> str:
    """How ``async_take`` detaches CUDA tensors from the training step:
    ``fork`` (default) copies them on the card (K2), paying device memory
    equal to the captured state; ``donate`` (``ASYNC_CAPTURE=donate``, or
    ``ASYNC_DEVICE_COPY=0``) captures them zero-copy. Under ``donate`` the
    caller promises not to change the captured tensors in place until the
    snapshot commits; each tensor's version counter is checked once its
    D2H has completed, and a broken promise fails the take
    (``PendingSnapshot.wait()`` raises, nothing is committed)."""
    val = os.environ.get(_ENV_ASYNC_CAPTURE, "fork").lower()
    return "donate" if val == "donate" or not is_async_device_copy_enabled() else "fork"


def is_checksums_enabled() -> bool:
    """Write the ``.checksums.<rank>`` sidecars (default on). Off, a take
    records no digest: its reads cannot be verified and it cannot serve
    as an incremental base."""
    return os.environ.get(_ENV_CHECKSUMS, "1") not in _OFF


def is_restore_overlap_enabled(
    has_device_targets: bool = False, target_platforms: Any = None
) -> bool:
    """Finalize each restored entry (its H2D copy) as its last read is
    consumed, so the copies overlap the reads still in flight and each
    entry's pinned host buffer is released as it lands. ``auto``
    (default): on with more than one usable CPU; on one CPU only where
    the restore has live device targets and all of them are on an
    accelerator (``target_platforms``: a set of device types, or a
    callable returning one, evaluated only on that branch). ``1``/``0``
    force it. Off: every read first, then every finalizer."""
    val = os.environ.get(_ENV_RESTORE_OVERLAP, "auto").lower()
    if val in ("auto", ""):
        if _usable_cpu_count() > 1:
            return True
        if not has_device_targets:
            return False
        if callable(target_platforms):
            target_platforms = target_platforms()
        if target_platforms:
            return all(p != "cpu" for p in target_platforms)
        return False
    return val not in ("0", "false", "off")


def _usable_cpu_count() -> int:
    """CPUs this process may run on (affinity aware)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # pragma: no cover - non-Linux
        return os.cpu_count() or 1


def get_d2h_lanes() -> int:
    """Concurrent device-to-host transfer lanes per write pipeline
    (default 4)."""
    return max(1, _get_int(_ENV_D2H_LANES, 4))


def get_d2h_window_bytes() -> int:
    """Device-to-host bytes in flight at once on the lanes (default
    512 MiB; the JAX package's default is 128 MB). A transfer larger than
    the window runs alone."""
    return max(0, _get_int(_ENV_D2H_WINDOW, 512 * 1024 * 1024))


def get_hash_workers(caller_waits: bool = False) -> int:
    """Width of a pipeline's hash pool: ``TSS_TORCH_HASH_WORKERS`` when set.
    Else, for a take whose caller waits for its commit, the usable CPUs over
    the ranks sharing this host less two (for the event loop, the transfer
    lanes and the storage copies), and at least the staging width; else,
    for a drain that races the caller's own work, the staging width."""
    val = os.environ.get(_ENV_HASH_WORKERS)
    if val is not None:
        return max(1, int(val))
    if caller_waits:
        return max(get_staging_threads(), len(os.sched_getaffinity(0)) // get_local_world_size() - 2)
    return get_staging_threads()


def get_staging_threads() -> int:
    """Width of the staging (serialize, compress) pool (default 4)."""
    return max(1, _get_int(_ENV_STAGING_THREADS, 4))


def get_consuming_threads() -> int:
    """Width of the restore's consuming (copy, decode, scatter) pool
    (default 4)."""
    return max(1, _get_int(_ENV_CONSUMING_THREADS, 4))


def get_max_concurrent_io(shared_local_device: bool = False) -> int:
    """Storage operations in flight per pipeline (default 16). With
    ``shared_local_device`` (a plugin whose ``scales_io_with_local_world``
    is set: the local disk) the default divides by the ranks sharing this
    host, so co-hosted ranks keep about 16 together. An explicit value is
    used as it is."""
    val = os.environ.get(_ENV_MAX_CONCURRENT_IO)
    if val is not None:
        return max(1, int(val))
    if shared_local_device:
        return max(1, 16 // get_local_world_size())
    return 16


def get_max_concurrent_io_for(storage: Any) -> int:
    """The I/O cap for ``storage``: the one reader of its
    ``scales_io_with_local_world`` flag."""
    return get_max_concurrent_io(bool(getattr(storage, "scales_io_with_local_world", False)))


def get_read_merge_gap_bytes() -> int:
    """Largest gap between two ranged reads of one object that the read
    batcher still merges into one read (default 0: exactly adjacent only).
    Gap bytes are read and dropped; each consumer gets exactly its own
    range."""
    return max(0, _get_int(_ENV_READ_MERGE_GAP, 0))


def override_async_fork_hbm_limit_bytes(value: int):
    return _override_env(_ENV_ASYNC_FORK_HBM_LIMIT, str(value))


def override_async_eager_d2h(enabled: bool):
    return _override_env(_ENV_ASYNC_EAGER_D2H, "1" if enabled else "0")


def override_restore_overlap(enabled: bool):
    return _override_env(_ENV_RESTORE_OVERLAP, "1" if enabled else "0")


def override_max_concurrent_io(value: int):
    return _override_env(_ENV_MAX_CONCURRENT_IO, str(value))


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


def override_trace_path(path: str):
    return _override_env(_ENV_TRACE, path)


def override_telemetry_artifacts(enabled: bool):
    return _override_env(_ENV_TELEMETRY_ARTIFACTS, "1" if enabled else "0")


def override_stall_warn_s(value: float):
    return _override_env(_ENV_STALL_WARN_S, str(value))


def override_recorder(enabled: bool):
    return _override_env(_ENV_RECORDER, "1" if enabled else "0")


def override_step_telemetry(enabled: bool):
    return _override_env(_ENV_STEP_TELEMETRY, "1" if enabled else "0")


def override_fleet_telemetry(value: str):
    return _override_env(_ENV_FLEET_TELEMETRY, value)


def override_fleet_beacon_s(value: float):
    return _override_env(_ENV_FLEET_BEACON_S, str(value))


def override_qos(enabled: bool):
    return _override_env(_ENV_QOS, "1" if enabled else "0")


def override_qos_poll_s(value: float):
    return _override_env(_ENV_QOS_POLL_S, str(value))


def override_qos_max_pause_s(value: float):
    return _override_env(_ENV_QOS_MAX_PAUSE_S, str(value))


def override_debug_ledger(enabled: bool):
    return _override_env(_ENV_DEBUG_LEDGER, "1" if enabled else "0")


def override_async_capture(mode: str):
    return _override_env(_ENV_ASYNC_CAPTURE, mode)


def override_async_device_copy(enabled: bool):
    return _override_env(_ENV_ASYNC_DEVICE_COPY, "1" if enabled else "0")


def override_device_batching(enabled: bool):
    return _override_env(_ENV_DEVICE_BATCHING, "1" if enabled else "0")


def override_slab_size_threshold_bytes(value: int):
    return _override_env(_ENV_SLAB_SIZE_THRESHOLD, str(value))


def override_checksums(enabled: bool):
    return _override_env(_ENV_CHECKSUMS, "1" if enabled else "0")


def override_compression_level(level: int):
    return _override_env(_ENV_COMPRESSION_LEVEL, str(level))


def override_dedup_digests(enabled: bool):
    return _override_env(_ENV_DEDUP_DIGESTS, "1" if enabled else "0")


def override_hash_workers(value: int):
    return _override_env(_ENV_HASH_WORKERS, str(value))


def override_staging_threads(value: int):
    return _override_env(_ENV_STAGING_THREADS, str(value))


def override_consuming_threads(value: int):
    return _override_env(_ENV_CONSUMING_THREADS, str(value))


def override_d2h_lanes(value: int):
    return _override_env(_ENV_D2H_LANES, str(value))


def override_d2h_window_bytes(value: int):
    return _override_env(_ENV_D2H_WINDOW, str(value))


def override_memory_budget_bytes(value: int):
    return _override_env(_ENV_MEMORY_BUDGET, str(value))


def override_native_io_enabled(enabled: bool):
    return _override_env(_ENV_DISABLE_NATIVE_IO, "0" if enabled else "1")


def override_direct_io_threshold_bytes(value: int):
    return _override_env(_ENV_DIRECT_IO_THRESHOLD, str(value))


def override_plan_cache(enabled: bool):
    return _override_env(_ENV_PLAN_CACHE, "1" if enabled else "0")


def override_plan_cache_size(value: int):
    return _override_env(_ENV_PLAN_CACHE_SIZE, str(value))


def override_prepared_cache(enabled: bool):
    return _override_env(_ENV_PREPARED_CACHE, "1" if enabled else "0")


def override_prepared_cache_size(value: int):
    return _override_env(_ENV_PREPARED_CACHE_SIZE, str(value))


def override_stream_writes(enabled: bool):
    return _override_env(_ENV_STREAM_WRITES, "1" if enabled else "0")


def override_stream_inflight(value: int):
    return _override_env(_ENV_STREAM_INFLIGHT, str(value))


def override_read_cache_dir(path: str):
    return _override_env(_ENV_READ_CACHE_DIR, path)


def override_read_cache_bytes(value: int):
    return _override_env(_ENV_READ_CACHE_BYTES, str(value))


def override_read_cache_verify(enabled: bool):
    return _override_env(_ENV_READ_CACHE_VERIFY, "1" if enabled else "0")


def override_verify_reads(mode: str):
    return _override_env(_ENV_VERIFY_READS, mode)


def override_read_merge_gap_bytes(value: int):
    return _override_env(_ENV_READ_MERGE_GAP, str(value))


def override_broadcast_restore(enabled: bool):
    return _override_env(_ENV_BCAST_RESTORE, "1" if enabled else "0")


def override_broadcast_max_bytes(value: int):
    return _override_env(_ENV_BCAST_MAX_BYTES, str(value))


def override_bcast_reader_deadline_s(value: float):
    return _override_env(_ENV_BCAST_READER_DEADLINE, str(value))


def override_swarm_restore(enabled: bool):
    return _override_env(_ENV_SWARM_RESTORE, "1" if enabled else "0")


def override_swarm_chunk_deadline_s(value: float):
    return _override_env(_ENV_SWARM_CHUNK_DEADLINE, str(value))


def override_swarm_fanout(value: int):
    return _override_env(_ENV_SWARM_FANOUT, str(value))


def override_bcast_reelect_max(value: int):
    return _override_env(_ENV_BCAST_REELECT_MAX, str(value))


def override_catalog(enabled: bool):
    return _override_env(_ENV_CATALOG, "1" if enabled else "0")


def override_max_chain_len(value: int):
    return _override_env(_ENV_MAX_CHAIN_LEN, str(value))


def override_recorder_capacity(value: int):
    return _override_env(_ENV_RECORDER_CAPACITY, str(value))


def override_recorder_interval_s(value: float):
    return _override_env(_ENV_RECORDER_INTERVAL_S, str(value))


def override_recorder_dump_path(path: str):
    return _override_env(_ENV_RECORDER_DUMP, path)


# -- robustness and cloud storage (the JAX package's defaults) -------------

_ENV_FAULTS = _P + "FAULTS"
_ENV_DEBUG_EFFECTS = _P + "DEBUG_EFFECTS"
_ENV_GCS_CHUNK = _P + "GCS_CHUNK_BYTES"
_ENV_S3_CHUNK = _P + "S3_CHUNK_BYTES"


def get_faults_spec() -> Optional[str]:
    """The deterministic fault-injection spec (``faults.py``): when set,
    ``url_to_storage_plugin`` wraps every plugin it builds in
    ``faults.FaultyStoragePlugin``. Tests only; unset, ``faults`` is never
    imported."""
    return os.environ.get(_ENV_FAULTS) or None


def is_debug_effects_enabled() -> bool:
    """The durable-effect journal (``effect_journal.py``): every plugin
    ``url_to_storage_plugin`` builds records each mutating op, the input of
    ``crash_explorer``. Off allocates nothing and imports nothing."""
    return _off_unless_on(_ENV_DEBUG_EFFECTS)


def get_gcs_chunk_bytes() -> int:
    """GCS resumable-upload chunk (default 100 MB): larger objects upload
    through a resumable session with cursor recovery, smaller ones in one
    PUT. The session rounds up to the wire's 256 KiB quantum."""
    return max(1, _get_int(_ENV_GCS_CHUNK, 100 * 1024 * 1024))


def get_s3_chunk_bytes() -> int:
    """S3 multipart part size (default 100 MB): larger objects upload in
    parts, each retried alone; smaller ones in one PUT. Real S3 needs parts
    of at least 5 MiB; smaller values serve fake backends in tests."""
    return max(1, _get_int(_ENV_S3_CHUNK, 100 * 1024 * 1024))


def override_faults(spec: str):
    return _override_env(_ENV_FAULTS, spec)


def override_debug_effects(enabled: bool):
    return _override_env(_ENV_DEBUG_EFFECTS, "1" if enabled else "0")


def override_gcs_chunk_bytes(value: int):
    return _override_env(_ENV_GCS_CHUNK, str(value))


def override_s3_chunk_bytes(value: int):
    return _override_env(_ENV_S3_CHUNK, str(value))

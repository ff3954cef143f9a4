"""Environment knobs of the port, under the ``TSS_TORCH_`` prefix.

A subset of ``torchsnapshot_tpu/utils/knobs.py``, with the same defaults:
the layout and digest settings the format tests pin, batching, the
host memory budget, the shard size, the barrier timeout and the
collective sanitizer. The JAX package's tuning knobs (thread and I/O widths,
the D2H window, device batching, the async device copy, checksums off)
are constants here until a workload needs another value. The prefix differs from the JAX package's on purpose, so
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


def is_dedup_digests_enabled() -> bool:
    """Record a sha256 beside each crc32 (``auto``: on with more than one
    usable core)."""
    val = os.environ.get(_ENV_DEDUP_DIGESTS, "auto").lower()
    if val in ("auto", ""):
        return len(os.sched_getaffinity(0)) > 1
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

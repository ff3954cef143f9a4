"""Loader and bindings of the native I/O engine (``tss_io.cpp``).

The engine is one C++ translation unit, the port's own copy of the JAX
package's, built at first use with the host's ``g++ -O2 -std=c++17
-shared -fPIC ... -lz`` into ``torchsnapshot_tpu_torch/_build/`` (keyed by
the source's hash, never next to the source) and loaded with
:mod:`ctypes`. ctypes releases the GIL for each call, so bounce-buffer
copies and ``pwrite``/``pread`` overlap the event loop; every binding
below keeps the buffer it passes referenced until the call returns.

The engine is absent when ``TSS_TORCH_DISABLE_NATIVE_IO=1`` is set, or
when the host cannot build it: with no ``g++`` that is silent, but a build
that fails on a host that has ``g++`` logs a warning. Callers (the fs
plugin) then use buffered Python I/O. Where the file system refuses
O_DIRECT (tmpfs, overlayfs, unaligned tails), the engine itself falls back
to buffered I/O: :func:`io_counts` says which way each transfer went.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

from ..utils import knobs

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tss_io.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
ABI_VERSION = 3

# _lock guards the published (_lib, _load_attempted) state and is never
# held across a compile; _build_lock serialises builds within the process
# (a file lock serialises them across processes).
_lock = threading.Lock()
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_bg_build: Optional[threading.Thread] = None

# Transfers the fs plugin made in Python, without the engine (the engine
# disabled or absent, or an object below the direct-I/O threshold).
_py_counts = {"python_writes": 0, "python_write_bytes": 0, "python_reads": 0, "python_read_bytes": 0}
_py_lock = threading.Lock()
_COUNT_NAMES = ("direct_writes", "buffered_writes", "direct_reads", "buffered_reads")


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libtss_io-{tag}.so")


def _build(out_path: str) -> None:
    """Compile the engine to ``out_path`` (under a file lock, through a
    temporary name, so concurrent processes never load a half-written
    library)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "tss_io.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out_path):
            return
        tmp = f"{out_path}.tmp.{os.getpid()}"
        base = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
        try:
            proc = subprocess.run(base + ["-lz"], capture_output=True, text=True)
            if proc.returncode != 0:
                # No zlib headers: the engine without the inline-crc digest
                # call (Python hashes those objects instead).
                proc = subprocess.run(
                    base + ["-DTSS_NO_ZLIB"], capture_output=True, text=True
                )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()}")
            os.replace(tmp, out_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tss_io_version.restype = ctypes.c_int
    lib.tss_io_version.argtypes = []
    if lib.tss_io_version() != ABI_VERSION:
        raise OSError(f"native I/O engine reports ABI {lib.tss_io_version()}, expected {ABI_VERSION}")
    lib.tss_write_file.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.tss_write_file.restype = ctypes.c_int
    lib.tss_read_file.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_uint64,
    ]
    lib.tss_read_file.restype = ctypes.c_int
    lib.tss_file_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.tss_file_size.restype = ctypes.c_int
    lib.tss_write_at.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int64,
    ]
    lib.tss_write_at.restype = ctypes.c_int
    lib.tss_io_counts.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    lib.tss_io_counts.restype = None
    lib.tss_io_reset_counts.argtypes = []
    lib.tss_io_reset_counts.restype = None
    try:
        lib.tss_write_file_digest.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.tss_write_file_digest.restype = ctypes.c_int
        lib._tss_has_digest = True
    except AttributeError:  # built with -DTSS_NO_ZLIB
        lib._tss_has_digest = False
    return lib


def _publish(lib: Optional[ctypes.CDLL]) -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    with _lock:
        if not _load_attempted:
            _lib = lib
            _load_attempted = True
        return _lib


def _load_built() -> Optional[ctypes.CDLL]:
    path = _lib_path()
    if not os.path.exists(path):
        return None
    return _configure(ctypes.CDLL(path))


def load_native() -> Optional[ctypes.CDLL]:
    """The engine, building it if needed; None when it is disabled or
    cannot be built here."""
    if not knobs.is_native_io_enabled():
        return None
    with _lock:
        if _load_attempted:
            return _lib
    with _build_lock:
        with _lock:
            if _load_attempted:
                return _lib
        lib = None
        try:
            lib = _load_built()
            if lib is None:
                if shutil.which("g++") is None:
                    logger.info("no g++ on this host: the native I/O engine is not built")
                    return _publish(None)
                _build(_lib_path())
                lib = _load_built()
        except (OSError, RuntimeError) as e:
            logger.warning(
                "native I/O engine unavailable (%s); the fs plugin uses buffered "
                "Python I/O", e,
            )
            lib = None
        return _publish(lib)


def load_native_nonblocking() -> Optional[ctypes.CDLL]:
    """Like :func:`load_native`, but never waits for a compile: a built
    library loads at once (a dlopen); otherwise the build runs on a daemon
    thread and this returns None until it is done, so the first take's
    writes go buffered rather than wait for ``g++``."""
    global _bg_build
    if not knobs.is_native_io_enabled():
        return None
    if _load_attempted:
        return _lib
    if os.path.exists(_lib_path()):
        return load_native()
    with _lock:
        if _load_attempted:
            return _lib
        if _bg_build is None or not _bg_build.is_alive():
            _bg_build = threading.Thread(target=load_native, daemon=True, name="tss-native-build")
            _bg_build.start()
    return None


def io_counts() -> Dict[str, int]:
    """Transfers since load (or :func:`reset_io_counts`): the engine's
    direct and buffered writes and reads, each as calls and bytes
    (``direct_writes``, ``direct_write_bytes``, ...), and the fs plugin's
    Python-path ones (``python_writes``, ...)."""
    out = {}
    for name in _COUNT_NAMES:
        out[name] = out[name[:-1] + "_bytes"] = 0
    lib = _lib
    if lib is not None:
        raw = (ctypes.c_uint64 * 8)()
        lib.tss_io_counts(raw)
        for i, name in enumerate(_COUNT_NAMES):
            out[name] = int(raw[i])
            out[name[:-1] + "_bytes"] = int(raw[4 + i])
    with _py_lock:
        out.update(_py_counts)
    return out


def reset_io_counts() -> None:
    if _lib is not None:
        _lib.tss_io_reset_counts()
    with _py_lock:
        for k in _py_counts:
            _py_counts[k] = 0


def note_python_io(kind: str, nbytes: int) -> None:
    """Count one Python-path transfer (``kind``: ``write`` or ``read``)."""
    with _py_lock:
        _py_counts[f"python_{kind}s"] += 1
        _py_counts[f"python_{kind}_bytes"] += nbytes


def _as_uint8_view(buf) -> memoryview:
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.format not in ("B", "b", "c"):
        mv = mv.cast("B")
    return mv


def _buf_address(mv: memoryview) -> int:
    # numpy gives a stable pointer for read-only buffers, which
    # ctypes.from_buffer refuses. The caller holds ``mv`` (and so the
    # buffer) until the native call returns.
    return np.frombuffer(mv, dtype=np.uint8).ctypes.data if mv.nbytes else 0


def _check(rc: int, path: str) -> None:
    if rc < 0:
        raise OSError(-rc, os.strerror(-rc), path)


def write_file(lib: ctypes.CDLL, path: str, buf, *, direct: bool, chunk_bytes: int) -> None:
    """Write ``buf`` (any buffer-protocol object) to ``path``."""
    mv = _as_uint8_view(buf)
    _check(
        lib.tss_write_file(os.fsencode(path), _buf_address(mv), mv.nbytes, int(direct), chunk_bytes),
        path,
    )


def write_file_digest(lib: ctypes.CDLL, path: str, buf, *, direct: bool, chunk_bytes: int):
    """Write ``buf`` and return its ``[crc32, size, None]`` record, the crc
    computed inside the write loop; None when the engine was built without
    zlib (the caller then writes with :func:`write_file` and hashes in
    Python). The sha256 slot stays for Python's hashlib to fill."""
    if not getattr(lib, "_tss_has_digest", False):
        return None
    mv = _as_uint8_view(buf)
    crc = ctypes.c_uint32(0)
    _check(
        lib.tss_write_file_digest(
            os.fsencode(path), _buf_address(mv), mv.nbytes, int(direct), chunk_bytes,
            ctypes.byref(crc),
        ),
        path,
    )
    return [crc.value, mv.nbytes, None]


def write_at(
    lib: ctypes.CDLL,
    path: str,
    buf,
    *,
    offset: int,
    direct: bool,
    chunk_bytes: int,
    truncate_to: int = -1,
) -> None:
    """Write ``buf`` at byte ``offset`` of ``path`` (created, never
    truncated on open). O_DIRECT engages only for a sector-aligned offset
    and length: a streamed object carries its unaligned tail in Python and
    flushes it buffered at commit, with ``truncate_to`` fixing the size."""
    mv = _as_uint8_view(buf)
    _check(
        lib.tss_write_at(
            os.fsencode(path), _buf_address(mv), mv.nbytes, offset, int(direct), chunk_bytes,
            truncate_to,
        ),
        path,
    )


def read_into(
    lib: ctypes.CDLL,
    path: str,
    dst,
    *,
    offset: int = 0,
    direct: bool = True,
    chunk_bytes: int = 64 << 20,
) -> None:
    """Fill the writable buffer ``dst`` from ``path[offset : offset+len(dst)]``."""
    mv = _as_uint8_view(dst)
    if mv.readonly:
        raise ValueError("read_into requires a writable buffer")
    _check(
        lib.tss_read_file(
            os.fsencode(path), _buf_address(mv), offset, mv.nbytes, int(direct), chunk_bytes
        ),
        path,
    )


def file_size(lib: ctypes.CDLL, path: str) -> int:
    out = ctypes.c_uint64(0)
    _check(lib.tss_file_size(os.fsencode(path), ctypes.byref(out)), path)
    return out.value

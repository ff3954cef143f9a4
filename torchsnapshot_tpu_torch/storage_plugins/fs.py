"""Local filesystem storage.

Crash-safe: every object is written to ``<path>.tmp.<id>`` and renamed into
place, so a crash mid-write never leaves a truncated object under its real
name. Transfers of at least ``TSS_TORCH_DIRECT_IO_THRESHOLD_BYTES`` go
through the native O_DIRECT engine (``native/``), which bypasses the page
cache; smaller ones, and every transfer when the engine is disabled
(``TSS_TORCH_DISABLE_NATIVE_IO=1``) or absent, are buffered Python I/O.
Where the file system refuses O_DIRECT the engine itself finishes
buffered. A streamed object appends through positioned O_DIRECT writes of
its sector-aligned spans, carrying the unaligned tail in Python until the
commit writes it and sets the final size.

Writes and reads retry transient OSErrors (``cloud_retry``: a stale NFS
handle, a timed-out round trip) under a collective-progress window.
Blocking work runs on the plugin's own thread pool; a semaphore caps the
concurrent O_DIRECT transfers (``get_direct_io_concurrency``, divided by
the ranks sharing the host's disk). An incremental take links unchanged
objects of its base in with hard links (:meth:`FSStoragePlugin.link_in`).

Telemetry (the JAX package's names): ``storage.write``, ``storage.read``,
``storage.link_in`` and ``storage.write_stream`` spans (``plugin="fs"``),
and the ``storage.fs.write_bytes`` / ``read_bytes`` / ``link_in_count``
counters.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from .. import native, telemetry
from ..io_types import BufferType, ReadIO, StoragePlugin, StorageWriteStream, WriteIO
from ..utils import knobs
from .cloud_retry import CollectiveProgress, is_transient_os_error, retry_transient

_IO_THREADS = 16
_DIRECT_ALIGN = 4096  # the native engine's kAlign


def _tmp_name(path: str) -> str:
    return f"{path}.tmp.{uuid.uuid4().hex[:8]}"


def _byte_view(buf: BufferType) -> memoryview:
    mv = memoryview(buf)
    return mv if mv.format == "B" and mv.ndim == 1 else mv.cast("B")


class _FSWriteStream(StorageWriteStream):
    """A streamed object written into a temporary file and renamed into
    place at commit. With the engine, each append writes its
    sector-aligned span at the running offset through O_DIRECT; the
    unaligned rest (< 4 KiB) is copied into a carry of the stream's own,
    never a view of the caller's buffer, which the staging pool reuses."""

    def __init__(self, plugin: "FSStoragePlugin", abs_path: str, path: str = "") -> None:
        self._plugin = plugin
        self._abs_path = abs_path
        self._path = path
        self._t0 = time.monotonic()
        self._total = 0
        self._tmp_path = _tmp_name(abs_path)
        # Created at once: abort() always has a file to remove.
        open(self._tmp_path, "wb").close()
        self._offset = 0  # bytes written (sector-aligned with the engine)
        self._carry = bytearray()
        self._file = None  # the buffered mode's open file
        # Fixed at the first append: one file is never written through
        # both O_DIRECT and buffered descriptors mid-stream.
        self._native_mode: Optional[bool] = None

    def _append_work(self, buf: BufferType) -> None:
        mv = _byte_view(buf)
        if self._native_mode is None:
            self._native_mode = self._plugin._native is not None
        if not self._native_mode:
            if self._file is None:
                self._file = open(self._tmp_path, "r+b")
            self._file.write(mv)
            self._offset += mv.nbytes
            native.note_python_io("write", mv.nbytes)
            return
        lib = self._plugin._native
        chunk_bytes = knobs.get_direct_io_chunk_bytes()
        carry = self._carry
        total = len(carry) + mv.nbytes
        aligned = total - total % _DIRECT_ALIGN
        if aligned == 0:
            carry.extend(mv)
            return
        with self._plugin._get_direct_sem():
            if carry:
                head = _DIRECT_ALIGN - len(carry)
                block = bytes(carry) + bytes(mv[:head])
                native.write_at(
                    lib, self._tmp_path, block, offset=self._offset, direct=True,
                    chunk_bytes=chunk_bytes,
                )
                self._offset += _DIRECT_ALIGN
                mv = mv[head:]
                carry.clear()
                aligned -= _DIRECT_ALIGN
            if aligned:
                native.write_at(
                    lib, self._tmp_path, mv[:aligned], offset=self._offset, direct=True,
                    chunk_bytes=chunk_bytes,
                )
                self._offset += aligned
                mv = mv[aligned:]
        carry.extend(mv)

    def _commit_work(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        elif self._native_mode:
            # The unaligned tail, buffered, and the exact final size.
            native.write_at(
                self._plugin._native,
                self._tmp_path,
                bytes(self._carry),
                offset=self._offset,
                direct=False,
                chunk_bytes=knobs.get_direct_io_chunk_bytes(),
                truncate_to=self._offset + len(self._carry),
            )
            self._offset += len(self._carry)
            self._carry.clear()
        os.replace(self._tmp_path, self._abs_path)

    def _abort_work(self) -> None:
        if self._file is not None:
            with contextlib.suppress(OSError):
                self._file.close()
            self._file = None
        with contextlib.suppress(OSError):
            os.remove(self._tmp_path)

    async def append(self, buf: BufferType) -> None:
        await self._plugin._run(self._append_work, buf)
        self._total += memoryview(buf).nbytes

    async def commit(self) -> None:
        await self._plugin._run(self._commit_work)
        tm = telemetry.get_active()
        if tm is not None:
            tm.add_span(
                "storage.write_stream",
                "storage",
                self._t0,
                time.monotonic() - self._t0,
                {"plugin": "fs", "path": self._path, "nbytes": self._total},
            )
        telemetry.counter_add("storage.fs.write_bytes", self._total)

    async def abort(self) -> None:
        await self._plugin._run(self._abort_work)


class FSStoragePlugin(StoragePlugin):
    supports_streaming = True
    # Ranks of one host share its disk: concurrency defaults divide by
    # them, and broadcast/swarm restores stay off under ``auto``.
    scales_io_with_local_world = True

    def __init__(self, root: str) -> None:
        self.root = root
        self._executor: Optional[ThreadPoolExecutor] = None
        # A threading semaphore, held inside executor threads; created at
        # first use, after the operation has fixed the local world size.
        self._direct_sem: Optional[threading.Semaphore] = None
        self._sem_lock = threading.Lock()
        # Transient OSErrors of a network file system (a stale handle, a
        # timed-out round trip) retry under the cloud plugins' policy.
        self._progress = CollectiveProgress()

    @property
    def _native(self):
        # Never waits for a compile: writes go buffered until it is built.
        return native.load_native_nonblocking()

    def _abs(self, path: str) -> str:
        return os.path.join(self.root, path)

    def _get_direct_sem(self) -> threading.Semaphore:
        with self._sem_lock:
            if self._direct_sem is None:
                self._direct_sem = threading.Semaphore(knobs.get_direct_io_concurrency())
            return self._direct_sem

    def _use_native(self, nbytes: int) -> bool:
        return self._native is not None and nbytes >= knobs.get_direct_io_threshold_bytes()

    async def _run(self, fn, *args):
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=_IO_THREADS, thread_name_prefix="tss-fs"
            )
        return await asyncio.get_running_loop().run_in_executor(self._executor, fn, *args)

    def _write_file(self, write_io: WriteIO) -> None:
        path = self._abs(write_io.path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = _tmp_name(path)
        mv = _byte_view(write_io.buf)
        try:
            if self._use_native(mv.nbytes):
                lib = self._native
                chunk = knobs.get_direct_io_chunk_bytes()
                with self._get_direct_sem():
                    digest = None
                    if write_io.want_digest:
                        # The crc rides the write loop; the caller fills the
                        # sha256 slot if it needs one.
                        digest = native.write_file_digest(
                            lib, tmp, mv, direct=True, chunk_bytes=chunk
                        )
                        write_io.digest_out = digest
                    if digest is None:
                        native.write_file(lib, tmp, mv, direct=True, chunk_bytes=chunk)
            else:
                with open(tmp, "wb") as f:
                    f.write(mv)
                native.note_python_io("write", mv.nbytes)
            os.replace(tmp, path)
        except BaseException:
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
            raise

    async def write(self, write_io: WriteIO) -> None:
        nbytes = memoryview(write_io.buf).nbytes
        with telemetry.span("storage.write", cat="storage", plugin="fs", path=write_io.path, nbytes=nbytes):
            # Each attempt writes a fresh temp file, which its error path
            # unlinks: a retry never sees or leaves an earlier attempt's bytes.
            await retry_transient(
                lambda: self._run(self._write_file, write_io),
                is_transient_os_error,
                self._progress,
                "fs",
            )
        telemetry.counter_add("storage.fs.write_bytes", nbytes)

    async def write_stream(self, path: str) -> StorageWriteStream:
        abs_path = self._abs(path)

        def open_stream() -> _FSWriteStream:
            os.makedirs(os.path.dirname(abs_path), exist_ok=True)
            return _FSWriteStream(self, abs_path, path)

        return await self._run(open_stream)

    def _read_file(self, path: str, byte_range, into: Optional[memoryview]):
        lib = self._native
        if byte_range is None:
            if lib is None:
                with open(path, "rb") as f:
                    data = bytearray(f.read())
                native.note_python_io("read", len(data))
                return data
            begin, n = 0, native.file_size(lib, path)
        else:
            begin, n = byte_range[0], byte_range[1] - byte_range[0]
        buf = into if into is not None else bytearray(n)
        if lib is not None and n >= knobs.get_direct_io_threshold_bytes():
            with self._get_direct_sem():
                native.read_into(
                    lib, path, buf, offset=begin, direct=True,
                    chunk_bytes=knobs.get_direct_io_chunk_bytes(),
                )
            return buf
        if lib is not None and byte_range is None:
            native.read_into(lib, path, buf, offset=0, direct=False)
            return buf
        view = _byte_view(buf)
        with open(path, "rb", buffering=0) as f:
            done = 0
            while done < n:
                got = os.preadv(f.fileno(), [view[done:]], begin + done)
                if got == 0:
                    raise IOError(f"short read of {path}: {done} of {n} bytes at {begin}")
                done += got
        native.note_python_io("read", n)
        return buf

    async def read(self, read_io: ReadIO) -> None:
        with telemetry.span("storage.read", cat="storage", plugin="fs", path=read_io.path) as sp:
            # Each attempt reads into a fresh buffer, or overwrites the
            # caller's ``into`` from offset 0.
            read_io.buf = await retry_transient(
                lambda: self._run(
                    self._read_file, self._abs(read_io.path), read_io.byte_range, read_io.into
                ),
                is_transient_os_error,
                self._progress,
                "fs",
            )
            nbytes = memoryview(read_io.buf).nbytes
            sp.set_attrs(nbytes=nbytes)
        telemetry.counter_add("storage.fs.read_bytes", nbytes)

    async def delete(self, path: str) -> None:
        await self._run(os.remove, self._abs(path))

    async def link_in(self, src_abs_path: str, path: str) -> bool:
        """Hard-link ``src_abs_path`` to ``path``, atomically through a
        temporary name. Fails soft: a cross-device link, a deleted base or
        a filesystem without hard links returns False and the caller
        writes the bytes. The link shares the inode, so deleting the base
        later leaves this snapshot whole."""
        with telemetry.span("storage.link_in", cat="storage", plugin="fs", path=path) as sp:
            ok = await self._run(self._link_in_inner, src_abs_path, path)
            sp.set_attrs(linked=ok)
        if ok:
            telemetry.counter_add("storage.fs.link_in_count")
        return ok

    def _link_in_inner(self, src_abs_path: str, path: str) -> bool:
        dst = self._abs(path)
        tmp = _tmp_name(dst)
        try:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.link(src_abs_path, tmp)
            os.replace(tmp, dst)
            return True
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False

    async def list_prefix(self, prefix: str) -> List[str]:
        """Every file under ``root/prefix``, relative to ``root``, sorted."""

        def work() -> List[str]:
            base = self._abs(prefix) if prefix else self.root
            if os.path.isfile(base):
                return [os.path.relpath(base, self.root)]
            out = []
            for dirpath, _, names in os.walk(base):
                out.extend(os.path.relpath(os.path.join(dirpath, n), self.root) for n in names)
            return sorted(out)

        return await self._run(work)

    async def prune_empty(self) -> None:
        """Remove the directories deletions left empty, bottom-up (a
        collected snapshot leaves no skeleton); the root stays."""

        def work() -> None:
            for dirpath, _, _ in os.walk(self.root, topdown=False):
                if dirpath != self.root and not os.listdir(dirpath):
                    with contextlib.suppress(OSError):
                        os.rmdir(dirpath)

        await self._run(work)

    async def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

"""Local filesystem storage.

Crash-safe: every object is written to ``<path>.tmp.<id>`` and renamed into
place, so a crash mid-write never leaves a truncated object under its real
name. Plain buffered I/O on a thread pool (the JAX package's O_DIRECT
engine is not ported; its ``DISABLE_NATIVE_IO`` path writes the same
bytes as this one). An incremental take links unchanged objects of its
base in with hard links (:meth:`FSStoragePlugin.link_in`).
"""

from __future__ import annotations

import asyncio
import os
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..io_types import BufferType, ReadIO, StoragePlugin, StorageWriteStream, WriteIO

_IO_THREADS = 16


def _tmp_name(path: str) -> str:
    return f"{path}.tmp.{uuid.uuid4().hex[:8]}"


class _FSWriteStream(StorageWriteStream):
    def __init__(self, plugin: "FSStoragePlugin", abs_path: str) -> None:
        self._plugin = plugin
        self._abs_path = abs_path
        self._tmp_path = _tmp_name(abs_path)
        self._file = open(self._tmp_path, "wb")

    async def append(self, buf: BufferType) -> None:
        await self._plugin._run(self._file.write, buf)

    async def commit(self) -> None:
        await self._plugin._run(self._file.close)
        await self._plugin._run(os.replace, self._tmp_path, self._abs_path)

    async def abort(self) -> None:
        self._file.close()
        try:
            os.remove(self._tmp_path)
        except FileNotFoundError:
            pass


class FSStoragePlugin(StoragePlugin):
    supports_streaming = True

    def __init__(self, root: str) -> None:
        self.root = root
        self._executor: Optional[ThreadPoolExecutor] = None

    def _abs(self, path: str) -> str:
        return os.path.join(self.root, path)

    async def _run(self, fn, *args):
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=_IO_THREADS, thread_name_prefix="tss-fs"
            )
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, fn, *args
        )

    def _write_file(self, path: str, buf: BufferType) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = _tmp_name(path)
        try:
            with open(tmp, "wb") as f:
                f.write(buf)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except FileNotFoundError:
                pass
            raise

    async def write(self, write_io: WriteIO) -> None:
        await self._run(self._write_file, self._abs(write_io.path), write_io.buf)

    async def write_stream(self, path: str) -> StorageWriteStream:
        abs_path = self._abs(path)
        await self._run(
            lambda: os.makedirs(os.path.dirname(abs_path), exist_ok=True)
        )
        return _FSWriteStream(self, abs_path)

    def _read_file(self, path: str, byte_range, into):
        with open(path, "rb", buffering=0) as f:
            if byte_range is None:
                return bytearray(f.read())
            begin, end = byte_range
            buf = into if into is not None else bytearray(end - begin)
            view = memoryview(buf).cast("B")
            done = 0
            while done < end - begin:
                n = os.preadv(f.fileno(), [view[done:]], begin + done)
                if n == 0:
                    raise IOError(
                        f"short read of {path}: {done} of {end - begin} bytes at {begin}"
                    )
                done += n
            return buf

    async def read(self, read_io: ReadIO) -> None:
        read_io.buf = await self._run(
            self._read_file, self._abs(read_io.path), read_io.byte_range, read_io.into
        )

    async def delete(self, path: str) -> None:
        await self._run(os.remove, self._abs(path))

    async def link_in(self, src_abs_path: str, path: str) -> bool:
        """Hard-link ``src_abs_path`` to ``path``, atomically through a
        temporary name. Fails soft: a cross-device link, a deleted base or
        a filesystem without hard links returns False and the caller
        writes the bytes. The link shares the inode, so deleting the base
        later leaves this snapshot whole."""
        return await self._run(self._link_in_inner, src_abs_path, path)

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

    async def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

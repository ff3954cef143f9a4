"""In-memory storage, for tests and single-process pipelines.

``memory://<name>`` resolves to one store per name and process, so a
snapshot taken and restored within one process sees the same objects.
Objects become visible whole: a write at once, a stream at its commit.
"""

from __future__ import annotations

from typing import Dict, List

from ..io_types import BufferType, ReadIO, StoragePlugin, StorageWriteStream, WriteIO


class _MemoryWriteStream(StorageWriteStream):
    def __init__(self, plugin: "MemoryStoragePlugin", path: str) -> None:
        self._plugin = plugin
        self._path = path
        self._buf = bytearray()

    async def append(self, buf: BufferType) -> None:
        self._buf.extend(memoryview(buf).cast("B"))

    async def commit(self) -> None:
        self._plugin.objects[self._path] = bytes(self._buf)
        self._buf = bytearray()

    async def abort(self) -> None:
        self._buf = bytearray()


# name -> store, for ``memory://<name>`` URLs.
SHARED_ROOTS: Dict[str, "MemoryStoragePlugin"] = {}


class MemoryStoragePlugin(StoragePlugin):
    supports_streaming = True

    def __init__(self, root: str = "") -> None:
        self.root = root
        self.objects: Dict[str, bytes] = {}

    async def write(self, write_io: WriteIO) -> None:
        self.objects[write_io.path] = bytes(memoryview(write_io.buf).cast("B"))

    async def write_stream(self, path: str) -> StorageWriteStream:
        return _MemoryWriteStream(self, path)

    async def read(self, read_io: ReadIO) -> None:
        try:
            data = self.objects[read_io.path]
        except KeyError:
            raise FileNotFoundError(read_io.path) from None
        if read_io.byte_range is not None:
            begin, end = read_io.byte_range
            data = data[begin:end]
        if read_io.into is not None:
            memoryview(read_io.into).cast("B")[:] = data
            read_io.buf = read_io.into
        else:
            read_io.buf = data

    async def delete(self, path: str) -> None:
        try:
            del self.objects[path]
        except KeyError:
            raise FileNotFoundError(path) from None

    async def list_prefix(self, prefix: str) -> List[str]:
        return sorted(p for p in self.objects if p.startswith(prefix))

    async def close(self) -> None:
        pass

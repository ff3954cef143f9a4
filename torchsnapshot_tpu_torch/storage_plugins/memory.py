"""In-memory storage, for tests and single-process pipelines.

``memory://<name>`` resolves to one store per name and process, so a
snapshot taken and restored within one process sees the same objects.
Objects become visible whole: a write at once, a stream at its commit.
Telemetry: ``storage.write``, ``storage.read`` and ``storage.write_stream``
spans (``plugin="memory"``) and the ``storage.memory.*_bytes`` counters.
"""

from __future__ import annotations

import time
from typing import Dict, List

from .. import telemetry
from ..io_types import BufferType, ReadIO, StoragePlugin, StorageWriteStream, WriteIO


class _MemoryWriteStream(StorageWriteStream):
    def __init__(self, plugin: "MemoryStoragePlugin", path: str) -> None:
        self._plugin = plugin
        self._path = path
        self._buf = bytearray()
        self._t0 = time.monotonic()

    async def append(self, buf: BufferType) -> None:
        self._buf.extend(memoryview(buf).cast("B"))

    async def commit(self) -> None:
        nbytes = len(self._buf)
        self._plugin.objects[self._path] = bytes(self._buf)
        self._buf = bytearray()
        tm = telemetry.get_active()
        if tm is not None:
            tm.add_span(
                "storage.write_stream",
                "storage",
                self._t0,
                time.monotonic() - self._t0,
                {"plugin": "memory", "path": self._path, "nbytes": nbytes},
            )
        telemetry.counter_add("storage.memory.write_bytes", nbytes)

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
        # The span times the copy into ``bytes``, which is the write.
        with telemetry.span("storage.write", cat="storage", plugin="memory", path=write_io.path) as sp:
            data = bytes(memoryview(write_io.buf).cast("B"))
            sp.set_attrs(nbytes=len(data))
            self.objects[write_io.path] = data
        telemetry.counter_add("storage.memory.write_bytes", len(data))

    async def write_stream(self, path: str) -> StorageWriteStream:
        return _MemoryWriteStream(self, path)

    async def read(self, read_io: ReadIO) -> None:
        with telemetry.span("storage.read", cat="storage", plugin="memory", path=read_io.path) as sp:
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
            sp.set_attrs(nbytes=len(data))
        telemetry.counter_add("storage.memory.read_bytes", len(data))

    async def delete(self, path: str) -> None:
        try:
            del self.objects[path]
        except KeyError:
            raise FileNotFoundError(path) from None

    async def list_prefix(self, prefix: str) -> List[str]:
        return sorted(p for p in self.objects if p.startswith(prefix))

    async def close(self) -> None:
        pass

"""The I/O request model shared by preparers, the scheduler and storage.

A write is planned as :class:`WriteReq` (a storage path and the
:class:`BufferStager` that produces its bytes); a read as :class:`ReadReq`
(a path, an optional byte range, and the :class:`BufferConsumer` that puts
the bytes where they belong). Storage plugins implement
:class:`StoragePlugin`.
"""

from __future__ import annotations

import abc
import asyncio
from concurrent.futures import Executor
from dataclasses import dataclass
from typing import AsyncIterator, Optional, Tuple, Union

BufferType = Union[bytes, bytearray, memoryview]


class BufferStager(abc.ABC):
    """Produces one storage object's bytes.

    A stager whose :meth:`can_stream` is True may also produce them as a
    sequence of chunks (:meth:`stage_chunks`) whose concatenation equals
    :meth:`stage_buffer`'s output; the scheduler then overlaps the storage
    write of one chunk with the staging of the next."""

    @abc.abstractmethod
    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        ...

    @abc.abstractmethod
    def get_staging_cost_bytes(self) -> int:
        ...

    def can_stream(self) -> bool:
        return False

    async def stage_chunks(
        self, executor: Optional[Executor] = None
    ) -> AsyncIterator[BufferType]:
        raise NotImplementedError
        yield  # pragma: no cover


@dataclass
class WriteReq:
    path: str
    buffer_stager: BufferStager
    # Staging may run after async_take returns: the source is a private
    # fork that the training step cannot touch.
    defer_staging: bool = False


class BufferConsumer(abc.ABC):
    def read_into(self) -> Optional[memoryview]:
        """A writable view of exactly the bytes this consumer wants, for
        the storage read to fill in place (the consume step then has
        nothing left to copy); None to receive a fresh buffer."""
        return None

    @abc.abstractmethod
    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        ...

    @abc.abstractmethod
    def get_consuming_cost_bytes(self) -> int:
        ...


@dataclass
class ReadReq:
    path: str
    buffer_consumer: BufferConsumer
    byte_range: Optional[Tuple[int, int]] = None  # [begin, end)


@dataclass
class WriteIO:
    path: str
    buf: BufferType
    # Set by a caller that will use ``digest_out``: a plugin that hashes
    # while it writes (the native fs engine folds crc32 into its write
    # loop) leaves the ``[crc32, size, None]`` record there; None means it
    # did not, and the caller hashes.
    want_digest: bool = False
    digest_out: Optional[list] = None


@dataclass
class ReadIO:
    path: str
    byte_range: Optional[Tuple[int, int]] = None
    buf: Optional[BufferType] = None  # filled by StoragePlugin.read
    # When set, the plugin reads the bytes straight into this writable
    # buffer (of exactly the range's size) and sets ``buf`` to it.
    into: Optional[memoryview] = None


class StorageWriteStream(abc.ABC):
    """One object written as a sequence of appends, made visible only by
    :meth:`commit` (:meth:`abort` leaves nothing behind)."""

    @abc.abstractmethod
    async def append(self, buf: BufferType) -> None:
        ...

    @abc.abstractmethod
    async def commit(self) -> None:
        ...

    @abc.abstractmethod
    async def abort(self) -> None:
        ...


class StoragePlugin(abc.ABC):
    """Storage backend. A missing object raises ``FileNotFoundError``."""

    # Whether appends (write_stream) are worth streaming a large object
    # through; the streaming decision (stream_select) only considers such
    # plugins.
    supports_streaming = False
    # Whether co-hosted ranks share this backend's device (a local disk):
    # I/O concurrency divides by them, and the broadcast and swarm
    # restores stay off under ``auto``.
    scales_io_with_local_world = False

    @abc.abstractmethod
    async def write(self, write_io: WriteIO) -> None:
        ...

    @abc.abstractmethod
    async def write_stream(self, path: str) -> StorageWriteStream:
        ...

    @abc.abstractmethod
    async def read(self, read_io: ReadIO) -> None:
        ...

    @abc.abstractmethod
    async def delete(self, path: str) -> None:
        ...

    @abc.abstractmethod
    async def close(self) -> None:
        ...

    async def link_in(self, src_abs_path: str, path: str) -> bool:
        """Alias the existing file at absolute ``src_abs_path`` into this
        store at ``path`` without copying bytes (incremental takes).
        Returns False when unsupported or failed; the caller then writes
        the bytes. Default: unsupported."""
        return False

    def sync_write(
        self, write_io: WriteIO, event_loop: asyncio.AbstractEventLoop
    ) -> None:
        event_loop.run_until_complete(self.write(write_io))

    def sync_read(
        self, read_io: ReadIO, event_loop: asyncio.AbstractEventLoop
    ) -> None:
        event_loop.run_until_complete(self.read(read_io))

    def sync_close(self, event_loop: asyncio.AbstractEventLoop) -> None:
        event_loop.run_until_complete(self.close())

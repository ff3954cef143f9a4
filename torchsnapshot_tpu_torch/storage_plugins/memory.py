"""In-memory storage, for tests and single-process pipelines.

``memory://<name>`` resolves to one store per name and process, so a
snapshot taken and restored within one process sees the same objects.
Objects become visible whole: a write at once, a stream at its commit.

Copies stay off the interpreter lock and off the event loop: every copy of
at least :data:`INLINE_MAX_BYTES` runs on the plugin's own thread pool
(``tss-memory``, :data:`COPY_THREADS` wide, made at first use and shut down
by :meth:`MemoryStoragePlugin.close`) in ``np.copyto``, which lets go of the
lock. Smaller copies stay an inline ``bytes``. No byte is copied twice: a
stream keeps each appended chunk as its own buffer and its commit publishes
them as the object.

Buffers are recycled across snapshots (:data:`RECYCLED`, one pool per
process, since a job's successive snapshots are different stores and a
store is closed once its snapshot is deleted). A ``delete`` or an
overwrite gives each array of the object it drops to the pool when no one
else references it: a reader's view, or the stored object held by a
caller, keeps its array out. A copy of ``n`` bytes fills a pooled buffer of
exactly ``n`` bytes when there is one, else pages allocated untouched
(``np.empty``), which cost the copy their faults; the copy overwrites every
byte. The pool holds at most the most bytes one store has held (one
snapshot), freeing its oldest arrays to stay within it;
:func:`release_recycled_buffers` empties it, as every ``Snapshot.restore``
does first (a restore's pages come on top of a take's peak). A take into
the store counts the pool as available memory in its staging budget.

A stored object is ``bytes`` (a small write) or a :class:`Chunks` of the
buffers its write or its appends filled; either compares equal to the bytes
written. The store owns them: a caller may reuse its buffer once ``write``
or ``append`` has returned. A ranged read ``into`` a buffer copies the parts
of the chunks it covers straight there; a read without ``into`` returns a
read-only view of one chunk with no copy, or joins several in one copy.

Telemetry: ``storage.write``, ``storage.read`` and ``storage.write_stream``
spans (``plugin="memory"``; ``storage.write`` times the awaited copy; the
write spans' ``recycled`` is the bytes written into pooled buffers), the
``storage.memory.*_bytes`` counters, ``storage.memory.unlocked_copy_bytes``,
the bytes copied with the lock let go, and ``storage.memory.recycled_bytes``
and ``storage.memory.fresh_bytes``, the bytes a write or an append copied
into pooled buffers and into new ones (``np.empty``, or an inline
``bytes``).
"""

from __future__ import annotations

import asyncio
import bisect
import sys
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import telemetry
from ..io_types import BufferType, ReadIO, StoragePlugin, StorageWriteStream, WriteIO

# A copy this small holds the interpreter lock well under
# ``sys.getswitchinterval()`` (5 ms): 1 MiB at ~2 GB/s is 0.5 ms.
INLINE_MAX_BYTES = 1 << 20
# Copies of this many objects at once: copies into fresh pages run at ~2 GB/s
# a thread, and the host's CPUs are shared with the caller's own work.
COPY_THREADS = 4


def _byte_view(buf) -> memoryview:
    return memoryview(buf).cast("B")


def _fill(dst: memoryview, pieces: Sequence[memoryview]) -> None:
    """Copy ``pieces`` end to end into ``dst`` (on a pool thread: ``np.copyto``
    lets go of the interpreter lock for each piece)."""
    out = np.frombuffer(dst, np.uint8)
    off = 0
    for p in pieces:
        n = p.nbytes
        np.copyto(out[off : off + n], np.frombuffer(p, np.uint8))
        off += n


class Chunks:
    """A stored object: the buffers its write or its appends filled, in
    order, never copied again. Compares equal to the bytes written, and
    ``bytes()``, ``len()`` and the buffer protocol see those bytes."""

    __slots__ = ("parts", "nbytes", "_starts")

    def __init__(self, parts: Sequence[BufferType]) -> None:
        self.parts = tuple(parts)
        self._starts: List[int] = []
        n = 0
        for p in self.parts:
            self._starts.append(n)
            n += _byte_view(p).nbytes
        self.nbytes = n

    def pieces(self, begin: int, end: int) -> List[memoryview]:
        """Views of the parts covering ``[begin, end)``, in order."""
        out = []
        i = max(0, bisect.bisect_right(self._starts, begin) - 1)
        while i < len(self.parts) and self._starts[i] < end:
            view, start = _byte_view(self.parts[i]), self._starts[i]
            lo, hi = max(begin - start, 0), min(end - start, view.nbytes)
            if hi > lo:
                out.append(view[lo:hi])
            i += 1
        return out

    def __len__(self) -> int:
        return self.nbytes

    def __bytes__(self) -> bytes:
        return b"".join(self.parts)

    def __buffer__(self, flags: int) -> memoryview:
        if len(self.parts) == 1:
            return _byte_view(self.parts[0]).toreadonly()
        return memoryview(bytes(self))

    def __eq__(self, other) -> bool:
        try:
            mv = _byte_view(other)
        except TypeError:
            return NotImplemented
        if mv.nbytes != self.nbytes:
            return False
        return all(
            np.array_equal(np.frombuffer(p, np.uint8), np.frombuffer(mv[s : s + p.nbytes], np.uint8))
            for p, s in zip(map(_byte_view, self.parts), self._starts)
        )

    __hash__ = None  # type: ignore[assignment]


StoredObject = Union[bytes, Chunks]


class BufferPool:
    """Arrays of dropped objects, by exact size, for the next copies of that
    size. Holds at most :attr:`bound` bytes, the most one store has held:
    an array given beyond it frees the oldest kept first, so sizes no
    snapshot writes any more (a trace's artifact, a sidecar) age out."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # size -> {id: array}, the last given last; and every kept array,
        # the oldest first.
        self._by_size: Dict[int, "OrderedDict[int, np.ndarray]"] = {}
        self._order: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.nbytes = 0
        self.bound = 0

    def note_held(self, nbytes: int) -> None:
        """A store now holds ``nbytes``: the bound rises to it."""
        with self._lock:
            self.bound = max(self.bound, nbytes)

    def give(self, arr: np.ndarray) -> None:
        """Keep ``arr``, which no one else references, freeing the oldest
        kept arrays as the bound needs; an array larger than the bound is
        let go."""
        n = arr.nbytes
        with self._lock:
            if n > self.bound:
                return
            while self.nbytes + n > self.bound:
                self._drop(*self._order.popitem(last=False))
            self._by_size.setdefault(n, OrderedDict())[id(arr)] = arr
            self._order[id(arr)] = arr
            self.nbytes += n

    def _drop(self, key: int, arr: np.ndarray) -> None:
        kept = self._by_size[arr.nbytes]
        del kept[key]
        if not kept:
            del self._by_size[arr.nbytes]
        self.nbytes -= arr.nbytes

    def take(self, nbytes: int) -> Optional[np.ndarray]:
        """A kept array of exactly ``nbytes``, the last one given first."""
        with self._lock:
            kept = self._by_size.get(nbytes)
            if not kept:
                return None
            key, arr = kept.popitem()
            if not kept:
                del self._by_size[nbytes]
            del self._order[key]
            self.nbytes -= nbytes
            return arr

    def release(self) -> int:
        """Free every kept array; returns their bytes."""
        with self._lock:
            freed, self.nbytes = self.nbytes, 0
            self._by_size.clear()
            self._order.clear()
            return freed


# The process's pool: every store draws on it and gives to it.
RECYCLED = BufferPool()


def recycled_bytes() -> int:
    """Bytes the pool holds for the next snapshot's copies."""
    return RECYCLED.nbytes


def release_recycled_buffers() -> int:
    """Empty the pool, giving its memory back; returns the bytes freed."""
    return RECYCLED.release()


def _stored(parts: List[BufferType]) -> StoredObject:
    if not parts:
        return b""
    if len(parts) == 1 and not isinstance(parts[0], np.ndarray):
        return parts[0]
    return Chunks(parts)


class _MemoryWriteStream(StorageWriteStream):
    def __init__(self, plugin: "MemoryStoragePlugin", path: str) -> None:
        self._plugin = plugin
        self._path = path
        self._parts: List[BufferType] = []
        self._recycled = 0
        self._t0 = time.monotonic()

    async def append(self, buf: BufferType) -> None:
        src = _byte_view(buf)
        if src.nbytes:
            part, recycled = await self._plugin._own(src)
            self._parts.append(part)
            self._recycled += recycled

    async def commit(self) -> None:
        # The chunks become the object as they are: nothing is copied here.
        parts, self._parts = self._parts, []
        obj = _stored(parts)
        self._plugin._put(self._path, obj)
        nbytes = len(obj)
        tm = telemetry.get_active()
        if tm is not None:
            tm.add_span(
                "storage.write_stream",
                "storage",
                self._t0,
                time.monotonic() - self._t0,
                {"plugin": "memory", "path": self._path, "nbytes": nbytes, "recycled": self._recycled},
            )
        telemetry.counter_add("storage.memory.write_bytes", nbytes)

    async def abort(self) -> None:
        self._parts = []


# name -> store, for ``memory://<name>`` URLs.
SHARED_ROOTS: Dict[str, "MemoryStoragePlugin"] = {}


class MemoryStoragePlugin(StoragePlugin):
    supports_streaming = True

    def __init__(self, root: str = "") -> None:
        self.root = root
        self.objects: Dict[str, StoredObject] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        # Pipelines on several event loops may share this store.
        self._pool_lock = threading.Lock()
        # Bytes of the objects put and not yet dropped.
        self._held = 0

    async def _copy(self, dst: memoryview, pieces: Sequence[memoryview]) -> None:
        """Fill ``dst`` with ``pieces``: inline when small, else on the pool."""
        if dst.nbytes < INLINE_MAX_BYTES:
            _fill(dst, pieces)
            return
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=COPY_THREADS, thread_name_prefix="tss-memory")
            fut = asyncio.get_running_loop().run_in_executor(self._pool, _fill, dst, pieces)
        await fut
        telemetry.counter_add("storage.memory.unlocked_copy_bytes", dst.nbytes)

    async def _own(self, src: memoryview) -> Tuple[BufferType, int]:
        """A copy of ``src`` that the store owns, and the bytes of it written
        into a pooled buffer."""
        n = src.nbytes
        out = RECYCLED.take(n) if n >= INLINE_MAX_BYTES else None
        recycled = n if out is not None else 0
        telemetry.counter_add("storage.memory.recycled_bytes", recycled)
        telemetry.counter_add("storage.memory.fresh_bytes", n - recycled)
        if n < INLINE_MAX_BYTES:
            return bytes(src), 0
        if out is None:
            out = np.empty(n, np.uint8)
        await self._copy(memoryview(out), (src,))
        return out, recycled

    def _put(self, path: str, obj: Optional[StoredObject]) -> bool:
        """Make ``obj`` the object at ``path`` (None: delete it) and give the
        arrays of the object it replaces that no one else references to the
        pool. False when ``path`` held nothing."""
        old = self.objects.pop(path, None)
        if obj is not None:
            self.objects[path] = obj
        delta = (len(obj) if obj is not None else 0) - (len(old) if old is not None else 0)
        with self._pool_lock:
            self._held = max(0, self._held + delta)
            held = self._held
        RECYCLED.note_held(held)
        if old is None:
            return False
        # Held by this frame alone, ``old`` counts two references: ``old``
        # and getrefcount's argument. A caller that kept the object (and so
        # could still read its parts) adds one.
        if isinstance(old, Chunks) and sys.getrefcount(old) == 2:
            for arr in old.parts:
                # The parts' tuple, ``arr`` and getrefcount's argument: any
                # more is a view a reader holds.
                if type(arr) is np.ndarray and arr.flags.owndata and sys.getrefcount(arr) == 3:
                    RECYCLED.give(arr)
        return True

    async def write(self, write_io: WriteIO) -> None:
        src = _byte_view(write_io.buf)
        # The span times the copy, which is the write.
        with telemetry.span(
            "storage.write", cat="storage", plugin="memory", path=write_io.path, nbytes=src.nbytes
        ) as sp:
            part, recycled = await self._own(src)
            self._put(write_io.path, _stored([part]))
            sp.set_attrs(recycled=recycled)
        telemetry.counter_add("storage.memory.write_bytes", src.nbytes)

    async def write_stream(self, path: str) -> StorageWriteStream:
        return _MemoryWriteStream(self, path)

    async def read(self, read_io: ReadIO) -> None:
        with telemetry.span("storage.read", cat="storage", plugin="memory", path=read_io.path) as sp:
            try:
                obj = self.objects[read_io.path]
            except KeyError:
                raise FileNotFoundError(read_io.path) from None
            begin, end = _clamp(read_io.byte_range, len(obj))
            nbytes = end - begin
            pieces = (obj if isinstance(obj, Chunks) else Chunks((obj,))).pieces(begin, end)
            if read_io.into is not None:
                dst = _byte_view(read_io.into)
                if dst.nbytes != nbytes:
                    raise ValueError(f"read of {nbytes} bytes into a buffer of {dst.nbytes}")
                await self._copy(dst, pieces)
                read_io.buf = read_io.into
            elif not isinstance(obj, Chunks) and nbytes == len(obj):
                read_io.buf = obj
            elif nbytes < INLINE_MAX_BYTES:
                read_io.buf = b"".join(pieces)
            elif len(pieces) == 1:
                read_io.buf = pieces[0].toreadonly()
            else:
                out = np.empty(nbytes, np.uint8)
                await self._copy(memoryview(out), pieces)
                read_io.buf = out
            sp.set_attrs(nbytes=nbytes)
        telemetry.counter_add("storage.memory.read_bytes", nbytes)

    async def delete(self, path: str) -> None:
        if not self._put(path, None):
            raise FileNotFoundError(path)

    async def list_prefix(self, prefix: str) -> List[str]:
        return sorted(p for p in self.objects if p.startswith(prefix))

    async def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)


def _clamp(byte_range: Optional[Tuple[int, int]], size: int) -> Tuple[int, int]:
    """``byte_range`` cut to the object, as slicing ``bytes`` cuts it."""
    if byte_range is None:
        return 0, size
    begin = min(max(byte_range[0], 0), size)
    return begin, min(max(byte_range[1], begin), size)

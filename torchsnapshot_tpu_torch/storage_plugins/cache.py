"""Content-addressed read-through cache over any storage plugin.

A serving fleet restarts from one committed snapshot; without a cache each
replica reads every byte from the origin again. :class:`CachedStoragePlugin`
wraps the origin plugin with a byte-bounded local store
(``TSS_TORCH_READ_CACHE_DIR``, ``TSS_TORCH_READ_CACHE_BYTES``). Its
on-disk layout is the JAX package's, name for name, so one cache directory
serves both packages:

- ``by-digest/<aa>/<key>``: objects the snapshot's checksum sidecars
  cover with a content key (a v1 whole-object sha256, or a v2 tree root
  with its grain, ``hashing.record_cache_key``). The same bytes are cached
  once across snapshots, and a hit is verified against its record before
  it is served (``TSS_TORCH_READ_CACHE_VERIFY``, default on): a corrupt
  entry is dropped and the read goes to the origin.
- ``by-path/<aa>/<sha256(origin NUL path)>``: everything else (metadata,
  sidecars, frame tables). A write or delete through this plugin drops the
  path's entry; serve immutable snapshot roots, since a retake of the same
  path from another host is not seen.
- Sparse entries: an object whose record has a v2 chunk grid may be held in
  part, as its data file (full size, chunks at their offsets) plus a
  ``<entry>.chunks`` presence bitmap, whose atomic rename publishes the
  chunks. A range is served when every chunk it touches is present; a
  ranged origin fetch populates the chunks it fully contains; the last
  chunk removes the bitmap and the entry is whole.

Populate writes ``tmp/<uuid>.tmp`` and renames it into place, so a reader
sees a whole entry or none. Least recently used entries (hits touch their
mtime) are evicted past the byte budget after each populate; an entry
being populated or read is pinned. Any failure of the local store falls
back to the origin: the cache can slow a read down, never fail it. A
ranged miss of an object the digest index does not know passes through
untouched, so a lazy partial restore reads only its ranges.

Telemetry (the JAX package's names): ``cache.hits`` / ``cache.misses``
(and ``_bytes``), ``cache.bypass_reads``, ``cache.range_misses``,
``cache.range_populates``, ``cache.quarantined``, and a
``storage.cache_populate`` span per populate.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import logging
import os
import threading
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from .. import hashing, telemetry
from ..engine import qos
from ..io_types import ReadIO, StoragePlugin, StorageWriteStream, WriteIO
from ..utils import knobs

logger = logging.getLogger(__name__)

_TMP_DIR = "tmp"
_DIGEST_DIR = "by-digest"
_PATH_DIR = "by-path"


def find_read_cache(storage) -> Optional["CachedStoragePlugin"]:
    """The cache layer of a (possibly wrapped) plugin stack, found through
    ``inner`` links; None when there is none."""
    for _ in range(8):
        if storage is None:
            return None
        if isinstance(storage, CachedStoragePlugin):
            return storage
        storage = getattr(storage, "inner", None)
    return None


def _deliver(read_io: ReadIO, data: bytes) -> None:
    """Hand ``data`` to the reader: into its buffer when it gave one."""
    if read_io.into is not None:
        memoryview(read_io.into).cast("B")[:] = data
        read_io.buf = read_io.into
    else:
        read_io.buf = data


class CachedStoragePlugin(StoragePlugin):
    """Read-through cache over ``inner``; writes go through to ``inner``
    and drop the path's entry."""

    def __init__(
        self,
        inner: StoragePlugin,
        origin_id: str,
        cache_dir: Optional[str] = None,
        max_bytes: Optional[int] = None,
    ) -> None:
        self.inner = inner
        self.origin_id = origin_id
        self.cache_dir = cache_dir or knobs.get_read_cache_dir() or ""
        if not self.cache_dir:
            raise ValueError(
                "CachedStoragePlugin needs a cache directory (argument or "
                "TSS_TORCH_READ_CACHE_DIR)"
            )
        self._max_bytes = max_bytes if max_bytes is not None else knobs.get_read_cache_bytes()
        # path -> (size, content key | None, crc32 | None, chunk info | None)
        # from the sidecars (attach_digest_index). Without a key an entry
        # stays path-keyed, but a hit is still checked by size and crc.
        self._digests: Dict[str, Tuple] = {}
        self._executor: Optional[ThreadPoolExecutor] = None
        # Guards the size accounting and the pins (executor threads).
        self._lock = threading.Lock()
        self._total_bytes: Optional[int] = None  # known after a first scan
        # Concurrent misses of one entry share one origin fetch.
        self._inflight: Dict[str, asyncio.Future] = {}
        # Entries eviction must not touch: being populated or being read.
        self._pinned: Dict[str, int] = {}
        # Bytes served from the local store and fetched from the origin by
        # this instance (one per operation): the restore's attribution.
        self.stats: Dict[str, int] = {"hit_bytes": 0, "miss_bytes": 0}

    @property
    def supports_streaming(self) -> bool:  # type: ignore[override]
        return bool(getattr(self.inner, "supports_streaming", False))

    @property
    def scales_io_with_local_world(self) -> bool:  # type: ignore[override]
        return bool(getattr(self.inner, "scales_io_with_local_world", False))

    def attach_digest_index(self, index: Dict[str, Tuple]) -> None:
        """Merge ``{path: (size, key | None, crc32 | None[, chunk info])}``
        from the snapshot's sidecars: reads of those paths become
        content-addressed (with a key) or size-and-crc checked."""
        with self._lock:
            for p, v in index.items():
                self._digests[p] = tuple(v) + (None,) * (4 - len(v))

    # -- the local store (blocking; runs on the executor) --------------------
    def _get_executor(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=4, thread_name_prefix="tss-cache")
        return self._executor

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(self._get_executor(), fn, *args)

    def _digest_entry_path(self, key: str) -> str:
        return os.path.join(self.cache_dir, _DIGEST_DIR, key[:2], key)

    def _path_entry_path(self, path: str) -> str:
        key = hashlib.sha256(f"{self.origin_id}\0{path}".encode()).hexdigest()
        return os.path.join(self.cache_dir, _PATH_DIR, key[:2], key)

    def _entry_for(self, path: str) -> Tuple[str, Optional[Tuple]]:
        digest = self._digests.get(path)
        if digest is not None and digest[1]:
            return self._digest_entry_path(digest[1]), digest
        return self._path_entry_path(path), digest

    @staticmethod
    def _bitmap_path(entry: str) -> str:
        return entry + ".chunks"

    @contextlib.contextmanager
    def _pinned_entry(self, entry: str):
        with self._lock:
            self._pinned[entry] = self._pinned.get(entry, 0) + 1
        try:
            yield
        finally:
            with self._lock:
                n = self._pinned.get(entry, 0) - 1
                if n <= 0:
                    self._pinned.pop(entry, None)
                else:
                    self._pinned[entry] = n

    def _read_entry(
        self,
        entry: str,
        expect: Optional[Tuple],
        verify: bool,
        byte_range: Optional[Tuple[int, int]] = None,
    ) -> Optional[bytes]:
        """One whole entry, checked against its record when one is known
        (the size always; under ``verify`` the chunks a ranged hit serves,
        else the whole sha256, else the crc32). None on a miss, a sparse
        entry, or corruption (the corrupt entry is removed)."""
        with self._pinned_entry(entry):
            if os.path.exists(self._bitmap_path(entry)):
                return None
            try:
                with open(entry, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                return None
            except OSError:
                logger.warning("cache entry %s unreadable", entry, exc_info=True)
                return None
            if expect is not None:
                size, key, crc, chunks = expect[:4]
                ok = len(data) == size
                if ok and verify:
                    if chunks is not None:
                        begin, end = byte_range if byte_range else (None, None)
                        ok = hashing.verify_chunks_of(memoryview(data), chunks, begin, end) is None
                    elif key:
                        ok = hashlib.sha256(data).hexdigest() == key
                    elif crc is not None:
                        ok = zlib.crc32(data) == crc
                if not ok:
                    logger.warning(
                        "corrupt cache entry %s (expected %d bytes, digest %s); "
                        "reading the origin and populating again", entry, size, key or crc,
                    )
                    with contextlib.suppress(OSError):
                        os.remove(entry)
                    return None
            with contextlib.suppress(OSError):
                os.utime(entry)
            return data

    def _write_entry(self, entry: str, data: bytes) -> None:
        """Populate by atomic rename; pinned until its own eviction pass
        is done, so no concurrent pass evicts it before a reader sees it."""
        tmp_dir = os.path.join(self.cache_dir, _TMP_DIR)
        os.makedirs(tmp_dir, exist_ok=True)
        os.makedirs(os.path.dirname(entry), exist_ok=True)
        tmp = os.path.join(tmp_dir, f"{uuid.uuid4().hex}.tmp")
        with self._pinned_entry(entry):
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, entry)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.remove(tmp)
                raise
            # The entry is whole now: a sparse bitmap would demote it.
            with contextlib.suppress(OSError):
                os.remove(self._bitmap_path(entry))
            with self._lock:
                if self._total_bytes is not None:
                    self._total_bytes += len(data)
            self._maybe_evict()

    # -- sparse (chunk-granular) entries -------------------------------------
    @staticmethod
    def _chunk_span(
        expect: Tuple, begin: int, end: int, contained: bool
    ) -> Optional[Tuple[int, int, int]]:
        """``(first, last exclusive, grain)`` of the chunks touching
        [begin, end) (``contained=False``: what a served range needs) or
        fully inside it (``contained=True``: what a fetched range may
        populate); None without a usable chunk grid."""
        chunks = expect[3]
        if chunks is None:
            return None
        grain, size = chunks[0], expect[0]
        if not isinstance(grain, int) or grain <= 0 or not size:
            return None
        n = -(size // -grain)
        if contained:
            c0 = -(begin // -grain)
            c1 = c0
            for k in range(c0, n):
                if min((k + 1) * grain, size) > end:
                    break
                c1 = k + 1
        else:
            c0 = min(n, max(0, begin) // grain)
            c1 = min(n, -(end // -grain))
        if c1 <= c0:
            return None
        return c0, c1, grain

    def _read_sparse_range(
        self, entry: str, expect: Tuple, begin: int, end: int, verify: bool
    ) -> Optional[bytes]:
        """[begin, end) from a sparse entry whose bitmap holds every chunk
        the range touches (those chunks verified, then sliced); None
        otherwise. A corrupt span drops the entry."""
        span_info = self._chunk_span(expect, begin, end, contained=False)
        if span_info is None:
            return None
        c0, c1, grain = span_info
        with self._pinned_entry(entry):
            try:
                with open(self._bitmap_path(entry), "rb") as f:
                    bitmap = f.read()
            except OSError:
                return None
            if len(bitmap) < c1 or not all(bitmap[c0:c1]):
                return None
            span_b, span_e = c0 * grain, min(c1 * grain, expect[0])
            try:
                with open(entry, "rb") as f:
                    f.seek(span_b)
                    span = f.read(span_e - span_b)
            except OSError:
                return None
            if len(span) != span_e - span_b:
                return None
            if verify:
                _g, shas, crcs = expect[3]
                bad = hashing._chunk_mismatches(
                    memoryview(span),
                    grain,
                    shas[:c1] if shas is not None else None,
                    crcs[:c1] if crcs is not None else None,
                    c0,
                    0,
                )
                if bad:
                    logger.warning(
                        "corrupt sparse cache entry %s (chunks %s); dropping it", entry, bad
                    )
                    self._drop_entry(entry)
                    return None
            with contextlib.suppress(OSError):
                os.utime(entry)
                os.utime(self._bitmap_path(entry))
            return span[begin - span_b : end - span_b]

    def _write_entry_range(
        self, entry: str, expect: Tuple, begin: int, end: int, data: bytes
    ) -> None:
        """Land the chunks fully inside [begin, end) in a sparse entry:
        bytes into the pre-sized data file first, then the bitmap's atomic
        rename marks them present. The last chunk removes the bitmap."""
        span_info = self._chunk_span(expect, begin, end, contained=True)
        if span_info is None:
            return
        c0, c1, grain = span_info
        size = expect[0]
        n = -(size // -grain)
        bitmap_path = self._bitmap_path(entry)
        with self._pinned_entry(entry):
            with self._lock:
                if os.path.exists(entry) and not os.path.exists(bitmap_path):
                    return  # already whole
                if not os.path.exists(bitmap_path):
                    self._replace_bitmap(bitmap_path, bytes(n))
                created = False
                if not os.path.exists(entry):
                    os.makedirs(os.path.dirname(entry), exist_ok=True)
                    # Not atomic on purpose: chunks count as present only
                    # once the bitmap says so.
                    with open(entry, "wb") as f:  # noqa: TSA1001 - published by the bitmap's rename
                        f.truncate(size)
                    created = True
                span_b, span_e = c0 * grain, min(c1 * grain, size)
                with open(entry, "r+b") as f:  # noqa: TSA1001 - published by the bitmap's rename
                    f.seek(span_b)
                    f.write(data[span_b - begin : span_e - begin])
                with open(bitmap_path, "rb") as f:
                    bitmap = bytearray(f.read())
                if len(bitmap) != n:
                    bitmap = bytearray(n)
                for k in range(c0, c1):
                    bitmap[k] = 1
                if all(bitmap):
                    with contextlib.suppress(OSError):
                        os.remove(bitmap_path)
                else:
                    self._replace_bitmap(bitmap_path, bytes(bitmap))
                if created and self._total_bytes is not None:
                    self._total_bytes += size
            self._maybe_evict()

    def _replace_bitmap(self, bitmap_path: str, content: bytes) -> None:
        tmp_dir = os.path.join(self.cache_dir, _TMP_DIR)
        os.makedirs(tmp_dir, exist_ok=True)
        os.makedirs(os.path.dirname(bitmap_path), exist_ok=True)
        tmp = os.path.join(tmp_dir, f"{uuid.uuid4().hex}.tmp")
        try:
            with open(tmp, "wb") as f:
                f.write(content)
            if knobs.get_faults_spec():
                # The rename is a commit point below the fault wrapper; this
                # is its road into chaos schedules (`op=cache_bitmap`).
                from ..faults import maybe_inject_local

                maybe_inject_local("cache_bitmap", bitmap_path)
            os.replace(tmp, bitmap_path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise

    def _drop_entry(self, entry: str) -> None:
        for p in (entry, self._bitmap_path(entry)):
            with contextlib.suppress(OSError):
                os.remove(p)

    def _scan(self) -> List[Tuple[str, int, float]]:
        """Every entry as (path, size, mtime); bitmaps ride their data
        file and are never listed alone."""
        out: List[Tuple[str, int, float]] = []
        for sub in (_DIGEST_DIR, _PATH_DIR):
            for dirpath, _, names in os.walk(os.path.join(self.cache_dir, sub)):
                for name in names:
                    if name.endswith(".chunks"):
                        continue
                    p = os.path.join(dirpath, name)
                    try:
                        st = os.stat(p)
                    except OSError:
                        continue
                    out.append((p, st.st_size, st.st_mtime))
        return out

    def _maybe_evict(self) -> None:
        """Evict least recently used, unpinned entries until the store fits
        its budget (pinned ones may overshoot it for a while)."""
        with self._lock:
            total = self._total_bytes
        if total is not None and total <= self._max_bytes:
            return
        entries = self._scan()
        total = sum(sz for _, sz, _ in entries)
        for p, sz, _ in sorted(entries, key=lambda e: e[2]):
            if total <= self._max_bytes:
                break
            with self._lock:
                if p in self._pinned:
                    continue
            try:
                os.remove(p)
            except OSError:
                continue
            total -= sz
            with contextlib.suppress(OSError):
                os.remove(self._bitmap_path(p))
        with self._lock:
            self._total_bytes = total

    def _invalidate_path(self, path: str) -> None:
        self._drop_entry(self._path_entry_path(path))

    def quarantine_path(self, path: str) -> int:
        """Remove every entry that could serve ``path`` (its content entry
        and its path entry): called when a fetch of it failed verification.
        Blocking. Returns the entries removed."""
        with self._lock:
            digest = self._digests.get(path)
        targets = {self._path_entry_path(path)}
        if digest is not None and digest[1]:
            targets.add(self._digest_entry_path(digest[1]))
        removed = 0
        for entry in targets:
            with contextlib.suppress(OSError):
                os.remove(self._bitmap_path(entry))
            try:
                size = os.path.getsize(entry)
                os.remove(entry)
            except OSError:
                continue
            removed += 1
            with self._lock:
                if self._total_bytes is not None:
                    self._total_bytes -= size
        if removed:
            telemetry.counter_add("cache.quarantined", removed)
            logger.warning("quarantined %d cache entries of %s after a failed verification", removed, path)
        return removed

    def _note_hit(self, nbytes: int) -> None:
        self.stats["hit_bytes"] += nbytes
        telemetry.counter_add("cache.hits")
        telemetry.counter_add("cache.hit_bytes", nbytes)

    def _note_miss(self, nbytes: int) -> None:
        self.stats["miss_bytes"] += nbytes
        telemetry.counter_add("cache.misses")
        telemetry.counter_add("cache.miss_bytes", nbytes)

    async def _populate(self, path: str, fn, *args) -> None:
        """One populate (``fn`` on the cache's thread), as a span."""
        with telemetry.span("storage.cache_populate", cat="storage", path=path, nbytes=len(args[-1])):
            await self._run(fn, *args)

    # -- the swarm's surface -------------------------------------------------
    async def try_read_object(self, path: str) -> Optional[bytes]:
        """The whole object from the local store only (checked like a
        hit), or None; only for paths the digest index knows."""
        entry, expect = self._entry_for(path)
        if expect is None:
            return None
        data = await self._run(self._read_entry, entry, expect, knobs.is_read_cache_verify_enabled())
        if data is not None:
            self._note_hit(len(data))
        return data

    async def try_read_range(self, path: str, begin: int, end: int) -> Optional[bytes]:
        """[begin, end) of ``path`` from the local store only (a whole
        entry or a sparse one), or None."""
        entry, expect = self._entry_for(path)
        if expect is None:
            return None
        verify = knobs.is_read_cache_verify_enabled()
        data = await self._run(self._read_entry, entry, expect, verify, (begin, end))
        if data is not None:
            data = data[begin:end]
        else:
            data = await self._run(self._read_sparse_range, entry, expect, begin, end, verify)
        if data is not None:
            self._note_hit(len(data))
        return data

    async def populate_range(self, path: str, begin: int, end: int, data: bytes) -> None:
        """Land the chunks fully inside [begin, end) from bytes the caller
        holds and has verified; fail-open."""
        entry, expect = self._entry_for(path)
        if expect is None:
            return
        # A populate is deferrable follow-on work (the bytes are safe in the
        # caller's RAM): it yields the disk write to a higher class first.
        await qos.pause_point()
        try:
            await self._populate(path, self._write_entry_range, entry, expect, begin, end, bytes(data))
            telemetry.counter_add("cache.range_populates")
        except Exception:  # noqa: BLE001 - the cache never fails a restore
            logger.warning("failed to populate the read cache for a range of %s", path, exc_info=True)

    async def populate_object(self, path: str, data: bytes) -> None:
        """Populate ``path``'s entry from bytes the caller holds and has
        verified; fail-open."""
        entry, _ = self._entry_for(path)
        await qos.pause_point()
        try:
            await self._populate(path, self._write_entry, entry, bytes(data))
        except Exception:  # noqa: BLE001 - the cache never fails a restore
            logger.warning("failed to populate the read cache for %s", path, exc_info=True)

    # -- the read path -------------------------------------------------------
    async def read(self, read_io: ReadIO) -> None:
        path = read_io.path
        entry, expect = self._entry_for(path)
        verify = knobs.is_read_cache_verify_enabled()
        # A range covering the whole object (raw reads are ranges) is a
        # whole read for the cache.
        full_range = (
            read_io.byte_range is not None
            and expect is not None
            and tuple(read_io.byte_range) == (0, expect[0])
        )
        if read_io.byte_range is not None and not full_range:
            await self._read_range(read_io, entry, expect, verify)
            return
        data = await self._run(self._read_entry, entry, expect, verify)
        if data is not None:
            self._note_hit(len(data))
            _deliver(read_io, data)
            return
        pending = self._inflight.get(entry)
        if pending is not None:
            data = await asyncio.shield(pending)
            self._note_hit(len(data))
            _deliver(read_io, data)
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._inflight[entry] = fut
        try:
            await self.inner.read(read_io)
            data = bytes(memoryview(read_io.buf).cast("B"))
            fut.set_result(data)
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
                with contextlib.suppress(BaseException):
                    fut.exception()  # retrieved: no "never retrieved" warning
            raise
        finally:
            self._inflight.pop(entry, None)
        self._note_miss(len(data))
        try:
            await self._populate(path, self._write_entry, entry, data)
        except Exception:  # noqa: BLE001 - fail-open
            logger.warning("failed to populate the read cache for %s", path, exc_info=True)

    async def _read_range(
        self, read_io: ReadIO, entry: str, expect: Optional[Tuple], verify: bool
    ) -> None:
        begin, end = read_io.byte_range
        data = await self._run(self._read_entry, entry, expect, verify, (begin, end))
        if data is not None:
            data = data[begin:end]
        elif expect is not None:
            data = await self._run(self._read_sparse_range, entry, expect, begin, end, verify)
        if data is not None:
            self._note_hit(len(data))
            _deliver(read_io, data)
            return
        await self.inner.read(read_io)
        if expect is None:
            telemetry.counter_add("cache.bypass_reads")
            return  # the cache cannot address this range
        telemetry.counter_add("cache.range_misses")
        fetched = bytes(memoryview(read_io.buf).cast("B"))
        self.stats["miss_bytes"] += len(fetched)
        telemetry.counter_add("cache.miss_bytes", len(fetched))
        try:
            await self._populate(
                read_io.path, self._write_entry_range, entry, expect, begin, begin + len(fetched), fetched
            )
            telemetry.counter_add("cache.range_populates")
        except Exception:  # noqa: BLE001 - fail-open
            logger.warning("failed to populate the read cache for a range of %s", read_io.path, exc_info=True)

    # -- writes go through, dropping the path's entry -------------------------
    async def write(self, write_io: WriteIO) -> None:
        await self.inner.write(write_io)
        await self._run(self._invalidate_path, write_io.path)

    async def write_stream(self, path: str) -> StorageWriteStream:
        await self._run(self._invalidate_path, path)
        return await self.inner.write_stream(path)

    async def delete(self, path: str) -> None:
        await self._run(self._invalidate_path, path)
        await self.inner.delete(path)

    async def link_in(self, src_abs_path: str, path: str) -> bool:
        await self._run(self._invalidate_path, path)
        return await self.inner.link_in(src_abs_path, path)

    async def list_prefix(self, prefix: str) -> List[str]:
        return await self.inner.list_prefix(prefix)

    async def prune_empty(self) -> None:
        await self.inner.prune_empty()

    async def close(self) -> None:
        await self.inner.close()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None


def maybe_wrap_with_read_cache(plugin: StoragePlugin, origin_id: str) -> StoragePlugin:
    """``plugin`` wrapped in the cache when ``TSS_TORCH_READ_CACHE_DIR`` is
    set, else ``plugin``."""
    if not knobs.get_read_cache_dir():
        return plugin
    return CachedStoragePlugin(plugin, origin_id=origin_id)

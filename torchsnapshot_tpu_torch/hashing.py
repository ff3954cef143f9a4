"""Chunked hashing for the ``.checksums.<rank>`` sidecars.

A port of ``torchsnapshot_tpu/hashing.py``: the sidecar records must be
byte-identical between the two packages. Each grain-sized chunk of an
object's byte stream is hashed independently (crc32 + sha256) on the hash
pool; the chunk crc32s combine into the whole-object crc32 with
:func:`crc32_combine`, and the content digest is the tree **root** (sha256
over the ordered per-chunk sha256 digests).

Sidecar record formats (the ``.checksums.<rank>`` JSON values):

- legacy: a bare crc32 int;
- **v1**: ``[crc32, size, sha256-hex | None]`` — objects no larger than one
  hash chunk, and every object at grain ``0``;
- **v2**: ``{"v": 2, "crc": int, "size": int, "grain": int,
  "root": hex | None, "chunks": [hex, ...] | None, "crcs": [int, ...],
  "sha": hex | None}``.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import zlib
from typing import Any, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# crc32_combine — the zlib GF(2) matrix trick, in pure Python.
#
# crc32 is linear over GF(2): crc(A ++ B) is a function of crc(A), crc(B)
# and len(B) only. Appending one zero byte to A multiplies crc(A)'s state by
# a fixed 32x32 bit-matrix; appending len(B) zero bytes is that matrix
# raised to the 8*len(B)-th power, computed in O(log len(B)) squarings.
# ---------------------------------------------------------------------------

_CRC_POLY = 0xEDB88320


def _gf2_matrix_times(mat: Sequence[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(square: List[int], mat: Sequence[int]) -> None:
    for n in range(32):
        square[n] = _gf2_matrix_times(mat, mat[n])


@functools.lru_cache(maxsize=128)
def _zeros_operator(len2: int) -> Tuple[int, ...]:
    """The 32x32 GF(2) matrix advancing a crc register across ``len2`` zero
    bytes, via square-and-multiply over MATRICES. Cached per distinct
    length: an object's chunks all share the hash grain (plus one short
    tail), so after the first combine every further one is a single 32-op
    matrix-vector product instead of ~44 matrix squarings — measured to
    matter (a cold combine costs about as much pure-Python time as hashing
    the chunk it merges)."""
    even = [0] * 32  # operator for 2^(2k+1) zero bits
    odd = [0] * 32  # operator for 2^(2k) zero bits
    # One zero BIT.
    odd[0] = _CRC_POLY
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    # One zero byte (8 zero bits): square twice.
    _gf2_matrix_square(even, odd)
    _gf2_matrix_square(odd, even)
    mat: Optional[List[int]] = None  # cumulative operator (None = identity)
    while True:
        _gf2_matrix_square(even, odd)
        if len2 & 1:
            mat = (
                list(even)
                if mat is None
                else [_gf2_matrix_times(even, c) for c in mat]
            )
        len2 >>= 1
        if len2 == 0:
            break
        _gf2_matrix_square(odd, even)
        if len2 & 1:
            mat = (
                list(odd)
                if mat is None
                else [_gf2_matrix_times(odd, c) for c in mat]
            )
        len2 >>= 1
        if len2 == 0:
            break
    assert mat is not None  # len2 >= 1 always sets at least one bit
    return tuple(mat)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """``zlib.crc32(a + b)`` from ``crc32(a)``, ``crc32(b)``, ``len(b)``.

    Bit-identical to hashing the concatenation (unit-tested against
    ``zlib.crc32`` on random splits), so per-chunk crcs computed in any
    order on the hash pool still combine into the exact serial-fold value.
    """
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    return (
        _gf2_matrix_times(_zeros_operator(len2), crc1 & 0xFFFFFFFF) ^ crc2
    ) & 0xFFFFFFFF


def tree_root(chunk_shas: Sequence[str]) -> str:
    """Root digest: sha256 over the ordered concatenation of the raw
    per-chunk sha256 digests (bytes, not hex)."""
    h = hashlib.sha256()
    for c in chunk_shas:
        h.update(bytes.fromhex(c))
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Sidecar record accessors — the single owner of both formats.
# ---------------------------------------------------------------------------


def is_v2_record(rec: Any) -> bool:
    return isinstance(rec, dict) and rec.get("v") == 2


def chunk_extents(size: int, grain: int) -> List[Tuple[int, int]]:
    """The fixed chunk grid of an object: [k*grain, min((k+1)*grain, size))."""
    if grain <= 0:
        return [(0, size)] if size else []
    return [(b, min(b + grain, size)) for b in range(0, size, grain)]


def record_chunk_info(
    rec: Any,
) -> Optional[Tuple[int, Optional[List[str]], Optional[List[int]]]]:
    """``(grain, chunk_shas | None, chunk_crcs | None)`` for v2 records with
    a usable chunk grid; None for v1/legacy records (not chunk-verifiable)."""
    if not is_v2_record(rec):
        return None
    grain = rec.get("grain")
    size = rec.get("size")
    if not isinstance(grain, int) or grain <= 0 or not isinstance(size, int):
        return None
    n = len(chunk_extents(size, grain))
    shas = rec.get("chunks")
    if not (isinstance(shas, list) and len(shas) == n):
        shas = None
    crcs = rec.get("crcs")
    if not (isinstance(crcs, list) and len(crcs) == n):
        crcs = None
    if shas is None and crcs is None:
        return None
    return grain, shas, crcs


def record_size(rec: Any) -> Optional[int]:
    if isinstance(rec, list) and len(rec) == 3 and isinstance(rec[1], int):
        return rec[1]
    if is_v2_record(rec) and isinstance(rec.get("size"), int):
        return rec["size"]
    return None


def record_whole_sha(rec: Any) -> Optional[str]:
    """The whole-object sha256 when one was recorded (v1 records with dedup
    digests on; v2 records only through the compatibility digest)."""
    if isinstance(rec, list) and len(rec) == 3:
        return rec[2]
    if is_v2_record(rec):
        return rec.get("sha")
    return None


def record_content_keys(rec: Any) -> Tuple[str, ...]:
    """The record's collision-resistant content identities, most specific
    first: ``tree:<grain>:<root>`` for a v2 record, ``sha:<hex>`` for a
    whole-object sha256. Two objects dedup when their sizes match and
    their key sets intersect; a crc-only record has none."""
    keys: List[str] = []
    if is_v2_record(rec):
        root = rec.get("root")
        grain = rec.get("grain")
        if root and isinstance(grain, int):
            keys.append(f"tree:{grain}:{root}")
    sha = record_whole_sha(rec)
    if sha:
        keys.append(f"sha:{sha}")
    return tuple(keys)


def record_cache_key(rec: Any) -> Optional[str]:
    """Content address of an object: the v2 root suffixed with its grain,
    or the v1 whole sha256."""
    if is_v2_record(rec):
        root = rec.get("root")
        grain = rec.get("grain")
        if root and isinstance(grain, int):
            return f"{root}-t{grain}"
        return None
    return record_whole_sha(rec) or None


def record_crc(rec: Any) -> Optional[int]:
    """Whole-object crc32 (v2 records store the combined value, which is
    bit-identical to the serial fold)."""
    if isinstance(rec, int):
        return rec
    if isinstance(rec, list) and len(rec) == 3 and isinstance(rec[0], int):
        return rec[0]
    if is_v2_record(rec) and isinstance(rec.get("crc"), int):
        return rec["crc"]
    return None


# ---------------------------------------------------------------------------
# Verification (full-object, per-chunk, ranged).
# ---------------------------------------------------------------------------


def _chunk_mismatches(
    mv: memoryview,
    grain: int,
    shas: Optional[List[str]],
    crcs: Optional[List[int]],
    first: int,
    base: int,
) -> List[int]:
    """Chunk indices whose bytes in ``mv`` don't match the recorded chunk
    digests. ``mv`` holds chunks ``first..`` of the object, with chunk
    ``first`` starting at ``base`` within ``mv``; every checked chunk must
    be fully present in ``mv`` (callers guarantee it)."""
    bad: List[int] = []
    n = len(shas) if shas is not None else len(crcs or [])
    off = base
    idx = first
    while idx < n and off < mv.nbytes:
        end = min(off + grain, mv.nbytes)
        part = mv[off:end]
        if shas is not None:
            if hashlib.sha256(part).hexdigest() != shas[idx]:
                bad.append(idx)
        elif crcs is not None:
            if zlib.crc32(part) != crcs[idx]:
                bad.append(idx)
        off = end
        idx += 1
    return bad


def find_bad_chunks(mv: memoryview, rec: Any) -> Optional[List[int]]:
    """Per-chunk audit of a FULL object's bytes against a v2 record: the
    list of corrupt chunk indices (empty == clean), or None when the record
    carries no chunk grid (v1/legacy — not chunk-attributable)."""
    info = record_chunk_info(rec)
    if info is None:
        return None
    grain, shas, crcs = info
    return _chunk_mismatches(memoryview(mv).cast("B"), grain, shas, crcs, 0, 0)


def verify_buffer(mv: memoryview, rec: Any) -> Optional[str]:
    """Full-object check against any record format; returns a mismatch
    description or None. Runs on an executor thread — every hash here
    releases the GIL for large buffers."""
    mv = memoryview(mv).cast("B")
    size = record_size(rec)
    if size is not None and mv.nbytes != size:
        return f"size {mv.nbytes} != recorded {size}"
    info = record_chunk_info(rec)
    if info is not None:
        grain, shas, crcs = info
        bad = _chunk_mismatches(mv, grain, shas, crcs, 0, 0)
        if bad:
            kind = "sha256" if shas is not None else "crc32"
            return f"chunk {kind} mismatch at chunk(s) {bad} (grain {grain})"
        return None
    sha = record_whole_sha(rec)
    if sha:
        got = hashlib.sha256(mv).hexdigest()
        if got != sha:
            return f"sha256 {got} != recorded {sha}"
        return None
    crc = record_crc(rec)
    if isinstance(crc, int):
        got_crc = zlib.crc32(mv)
        if got_crc != crc:
            return f"crc32 {got_crc} != recorded {crc}"
    return None


def _contained_chunks(
    rec: Any, begin: int, end: int
) -> Optional[Tuple[int, int, int]]:
    """``(first_chunk, last_chunk_exclusive, grain)`` for the chunks FULLY
    contained in byte range [begin, end) of the object; None when the
    record has no chunk grid or no chunk fits entirely in the range."""
    info = record_chunk_info(rec)
    if info is None:
        return None
    grain, _shas, _crcs = info
    size = record_size(rec)
    if size is None:
        return None
    first = (begin + grain - 1) // grain
    # A chunk is contained if its full extent [k*grain, min((k+1)*grain,
    # size)) lies inside [begin, end) — the object's LAST chunk may be
    # short, so containment is against its real extent.
    extents = chunk_extents(size, grain)
    last = first
    for k in range(first, len(extents)):
        if extents[k][1] <= end:
            last = k + 1
        else:
            break
    if last <= first:
        return None
    return first, last, grain


def verify_chunks_of(
    mv: memoryview,
    info: Tuple[int, Optional[List[str]], Optional[List[int]]],
    begin: Optional[int] = None,
    end: Optional[int] = None,
) -> Optional[str]:
    """Verify chunks of a FULL object's bytes against a chunk grid
    (``record_chunk_info`` tuple); with ``begin``/``end``, only the chunks
    *intersecting* [begin, end) — the read cache's ranged-hit check, which
    holds the whole entry and therefore verifies even partially-covered
    edge chunks completely. Returns a mismatch description or None."""
    grain, shas, crcs = info
    mv = memoryview(mv).cast("B")
    total = len(shas) if shas is not None else len(crcs or [])
    if begin is None:
        first, last = 0, total
    else:
        first = min(total, max(0, begin) // grain)
        last = (
            min(total, (end + grain - 1) // grain)
            if end is not None
            else total
        )
    if last <= first:
        return None
    bad = _chunk_mismatches(
        mv[first * grain :],
        grain,
        shas[:last] if shas is not None else None,
        crcs[:last] if crcs is not None else None,
        first,
        0,
    )
    if bad:
        kind = "sha256" if shas is not None else "crc32"
        return f"chunk {kind} mismatch at chunk(s) {bad} (grain {grain})"
    return None


def range_verifiable(rec: Any, begin: int, end: int) -> bool:
    """Whether a ranged read of [begin, end) covers at least one full chunk
    of the record's grid — i.e. chunk-granular verification can check it."""
    return _contained_chunks(rec, begin, end) is not None


def verify_range(mv: memoryview, rec: Any, begin: int, end: int) -> Optional[str]:
    """Verify a RANGED read's bytes (``mv`` holds exactly [begin, end) of
    the object) at chunk granularity: every chunk fully contained in the
    range is checked against its recorded digest; partial edge chunks are
    skipped (their digests cover bytes the range didn't fetch). Returns a
    mismatch description or None — including when nothing was verifiable.
    """
    contained = _contained_chunks(rec, begin, end)
    if contained is None:
        return None
    first, last, grain = contained
    info = record_chunk_info(rec)
    assert info is not None
    _grain, shas, crcs = info
    mv = memoryview(mv).cast("B")
    sub_shas = shas[:last] if shas is not None else None
    sub_crcs = crcs[:last] if crcs is not None else None
    bad = _chunk_mismatches(
        mv, grain, sub_shas, sub_crcs, first, first * grain - begin
    )
    if bad:
        kind = "sha256" if shas is not None else "crc32"
        return (
            f"chunk {kind} mismatch at chunk(s) {bad} (grain {grain}, "
            f"range [{begin}, {end}))"
        )
    return None


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# The hashing engines.
# ---------------------------------------------------------------------------


def serial_digest(mv: memoryview, want_sha: bool) -> list:
    """The v1 serial fold: ``[crc32, size, sha256-hex | None]`` of one
    buffer in a single pass (objects <= one hash chunk, and grain 0)."""
    mv = memoryview(mv).cast("B")
    sha = None
    if want_sha:
        h = hashlib.sha256()
        h.update(mv)
        sha = h.hexdigest()
    return [zlib.crc32(mv), mv.nbytes, sha]


def _hash_chunk_parts(
    parts: List[memoryview], want_sha: bool
) -> Tuple[int, int, Optional[str]]:
    """One grain-chunk's (crc32, nbytes, sha256-hex) — the executor thunk.
    ``parts`` are ordered views that together cover exactly the chunk."""
    crc = 0
    n = 0
    sha = hashlib.sha256() if want_sha else None
    for p in parts:
        crc = zlib.crc32(p, crc)
        n += p.nbytes
        if sha is not None:
            sha.update(p)
    return crc, n, (sha.hexdigest() if sha is not None else None)


def _combine_results(
    results: Sequence[Tuple[int, int, Optional[str]]],
    grain: int,
    want_sha: bool,
):
    """Fold per-chunk (crc, n, sha) results into a sidecar record: v1 list
    for single-chunk objects, v2 dict otherwise."""
    if not results:
        return serial_digest(memoryview(b""), want_sha)
    if len(results) == 1:
        crc, n, sha = results[0]
        return [crc, n, sha]
    crc, total = results[0][0], results[0][1]
    for c, n, _sha in results[1:]:
        crc = crc32_combine(crc, c, n)
        total += n
    shas = [r[2] for r in results]
    have_shas = all(s is not None for s in shas)
    return {
        "v": 2,
        "crc": crc,
        "size": total,
        "grain": grain,
        "root": tree_root(shas) if have_shas else None,
        "chunks": list(shas) if have_shas else None,
        "crcs": [r[0] for r in results],
        "sha": None,
    }


class ChunkHasher:
    """Order-preserving chunked hasher: ``feed()`` takes the object's bytes
    in order on the event loop; each completed grain-chunk is hashed as an
    independent job on ``executor``; ``finalize()`` gathers the per-chunk
    digests in order and combines them into a sidecar record.

    At most ``max_inflight`` chunk jobs are dispatched and unfinished at
    once (``feed`` awaits past that), which bounds the staged views the
    hash backlog keeps alive to ``max_inflight x grain`` bytes."""

    def __init__(
        self,
        grain: int,
        want_sha: bool,
        loop: asyncio.AbstractEventLoop,
        executor,
        max_inflight: int = 8,
    ) -> None:
        if grain <= 0:
            raise ValueError("ChunkHasher needs a positive grain")
        self._grain = grain
        self._want_sha = want_sha
        self._loop = loop
        self._executor = executor
        self._parts: List[memoryview] = []
        self._filled = 0
        self._futures: List[asyncio.Future] = []
        self._sem = asyncio.Semaphore(max(1, max_inflight))

    async def feed(self, buf) -> None:
        mv = memoryview(buf).cast("B")
        off = 0
        while off < mv.nbytes:
            take = min(self._grain - self._filled, mv.nbytes - off)
            self._parts.append(mv[off : off + take])
            self._filled += take
            off += take
            if self._filled == self._grain:
                await self._flush()

    async def _flush(self) -> None:
        parts, self._parts, self._filled = self._parts, [], 0
        await self._sem.acquire()
        fut = self._loop.run_in_executor(
            self._executor, _hash_chunk_parts, parts, self._want_sha
        )
        fut.add_done_callback(lambda _f: self._sem.release())
        self._futures.append(fut)

    async def finalize(self):
        if self._parts:
            await self._flush()
        results = await asyncio.gather(*self._futures)
        self._futures = []
        return _combine_results(results, self._grain, self._want_sha)

    def abort(self) -> None:
        """Failure path: drop undispatched work and silence outstanding
        futures."""
        self._parts = []
        self._filled = 0
        for fut in self._futures:
            if not fut.cancel():
                fut.add_done_callback(
                    lambda f: f.exception() if not f.cancelled() else None
                )
        self._futures = []


class SerialStreamHasher:
    """Grain 0: the exact v1 serial fold, chunk by chunk in stream order,
    producing ``[crc, size, sha]``."""

    def __init__(
        self, want_sha: bool, loop: asyncio.AbstractEventLoop, executor
    ) -> None:
        self._loop = loop
        self._executor = executor
        self._sha = hashlib.sha256() if want_sha else None
        self._crc = 0
        self._total = 0

    async def feed(self, buf) -> None:
        mv = memoryview(buf).cast("B")

        def fold() -> int:
            if self._sha is not None:
                self._sha.update(mv)
            return zlib.crc32(mv, self._crc)

        self._crc = await self._loop.run_in_executor(self._executor, fold)
        self._total += mv.nbytes

    async def finalize(self):
        return [
            self._crc,
            self._total,
            self._sha.hexdigest() if self._sha is not None else None,
        ]

    def abort(self) -> None:
        pass  # every fold was awaited inline


def make_stream_hasher(
    grain: int, want_sha: bool, loop: asyncio.AbstractEventLoop, executor
):
    """The stream-side hasher of one storage object: chunk-parallel at a
    positive grain, the serial v1 fold at grain 0."""
    if grain > 0:
        return ChunkHasher(grain, want_sha, loop, executor)
    return SerialStreamHasher(want_sha, loop, executor)


async def hash_buffer(
    mv: memoryview,
    grain: int,
    want_sha: bool,
    loop: asyncio.AbstractEventLoop,
    executor,
    want_whole_sha: bool = False,
):
    """Digest one whole buffer: chunk-parallel on ``executor`` above one
    grain, the single-job serial fold otherwise. Gives the same record as
    feeding the same bytes through :func:`make_stream_hasher`.
    ``want_whole_sha`` also records the whole-object sha256 of a v2 record
    (one job beside the chunk jobs), for an incremental take whose base
    recorded v1 identities."""
    mv = memoryview(mv).cast("B")
    if grain <= 0 or mv.nbytes <= grain:
        return await loop.run_in_executor(executor, serial_digest, mv, want_sha)
    whole = None
    if want_whole_sha:
        whole = loop.run_in_executor(executor, lambda: hashlib.sha256(mv).hexdigest())
    hasher = ChunkHasher(grain, want_sha, loop, executor)
    try:
        await hasher.feed(mv)
        rec = await hasher.finalize()
    except BaseException:
        hasher.abort()
        if whole is not None:
            whole.cancel()
        raise
    if whole is not None:
        rec["sha"] = await whole
    return rec


def digest_of_bytes(data, grain: int, want_sha: bool = True):
    """The record :func:`hash_buffer` gives ``data`` at ``grain``,
    computed synchronously."""
    mv = memoryview(data).cast("B")
    if grain <= 0 or mv.nbytes <= grain:
        return serial_digest(mv, want_sha)
    results = [_hash_chunk_parts([mv[b:e]], want_sha) for b, e in chunk_extents(mv.nbytes, grain)]
    return _combine_results(results, grain, want_sha)

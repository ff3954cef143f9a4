"""The port's in-memory storage plugin (``storage_plugins/memory.py``).

Round trips through ``write`` and ``write_stream`` at sizes around the
inline threshold, ranged reads across chunk boundaries with and without
``into``, ownership of the caller's buffers, a commit that copies nothing,
and copies that run on the plugin's pool with the interpreter lock let go.
This file imports neither JAX nor the JAX package.
"""

import asyncio
import threading

import numpy as np
import pytest

from torchsnapshot_tpu_torch import telemetry
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugins import memory
from torchsnapshot_tpu_torch.telemetry import hostprobe

T = memory.INLINE_MAX_BYTES
CHUNK = 2 * T + 3  # a stream's append size, odd on purpose
SIZES = {
    "empty": 0,
    "one_byte": 1,
    "under_threshold": T - 1,
    "at_threshold": T,
    "over_threshold": T + 1,
    "one_chunk": CHUNK,
    "chunks_odd_tail": 3 * CHUNK + 12345,
}
UNLOCKED = "storage.memory.unlocked_copy_bytes"


def _data(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _run(coro):
    return asyncio.run(coro)


async def _put(plugin, path: str, data: bytes, how: str, chunk: int = CHUNK) -> None:
    if how == "write":
        await plugin.write(WriteIO(path=path, buf=memoryview(data)))
        return
    stream = await plugin.write_stream(path)
    for b in range(0, len(data), chunk):
        await stream.append(memoryview(data)[b : b + chunk])
    await stream.commit()


async def _get(plugin, path: str, byte_range=None, into=None):
    read_io = ReadIO(path=path, byte_range=byte_range, into=into)
    await plugin.read(read_io)
    return read_io.buf


class _Session:
    """An active telemetry session; ``counter(name)`` reads its counters."""

    def __enter__(self):
        self.tm = telemetry.Telemetry(probe_host=False)
        self._prev = telemetry.activate(self.tm)
        return self

    def __exit__(self, *exc):
        telemetry.deactivate(self.tm, self._prev)

    def counter(self, name: str) -> float:
        return self.tm.metrics.as_dict().get(name, 0)


def _copied_off_the_lock(how: str, size: int) -> int:
    """Bytes a put of ``size`` copies on the pool: a write's whole buffer,
    a stream's chunks, each only at or over the threshold."""
    pieces = [size] if how == "write" else [min(CHUNK, size - b) for b in range(0, size, CHUNK)]
    return sum(n for n in pieces if n >= T)


@pytest.mark.parametrize("how", ["write", "stream"])
@pytest.mark.parametrize("size", list(SIZES.values()), ids=list(SIZES))
def test_round_trip_is_byte_exact(how, size):
    plugin = memory.MemoryStoragePlugin()
    data = _data(size, seed=size)
    with _Session() as s:
        _run(_put(plugin, "obj", data, how))
        assert s.counter(UNLOCKED) == _copied_off_the_lock(how, size)
        assert s.counter("storage.memory.write_bytes") == size
    stored = plugin.objects["obj"]
    assert stored == data and data == stored and not stored != data
    assert bytes(stored) == data and len(stored) == size
    assert bytes(_run(_get(plugin, "obj"))) == data
    into = bytearray(size)
    assert _run(_get(plugin, "obj", (0, size), memoryview(into))) is not None
    assert bytes(into) == data
    _run(plugin.close())


@pytest.mark.parametrize("size", [0, 1, T + 1, 3 * CHUNK + 12345], ids=["empty", "one_byte", "over", "chunks"])
def test_abort_leaves_nothing(size):
    plugin = memory.MemoryStoragePlugin()
    data = _data(size)

    async def go():
        stream = await plugin.write_stream("obj")
        for b in range(0, size, CHUNK):
            await stream.append(memoryview(data)[b : b + CHUNK])
        await stream.abort()

    _run(go())
    assert "obj" not in plugin.objects
    assert _run(plugin.list_prefix("")) == []
    _run(plugin.close())


def test_small_objects_stay_bytes():
    """Sidecars and metadata stay ``bytes``: ``json.loads`` takes them."""
    plugin = memory.MemoryStoragePlugin()
    _run(_put(plugin, ".checksums.0", b'{"a": [1, 2, null]}', "write"))
    _run(_put(plugin, "s", b"abc" * 10, "stream", chunk=7))
    assert type(plugin.objects[".checksums.0"]) is bytes
    assert isinstance(plugin.objects["s"], memory.Chunks) and plugin.objects["s"] == b"abc" * 10
    _run(_put(plugin, "one", b"xyz", "stream"))
    assert type(plugin.objects["one"]) is bytes and plugin.objects["one"] == b"xyz"


# Ranges over a stored object of three CHUNK-sized chunks and an odd tail.
RANGES = {
    "whole": (0, 3 * CHUNK + 12345),
    "inside_first": (17, 17 + T + 5),
    "small_inside": (5, 105),
    "across_one_boundary": (CHUNK - 5, CHUNK + 5),
    "across_one_boundary_large": (CHUNK - T, CHUNK + T),
    "across_two_boundaries": (1, 2 * CHUNK + 7),
    "exactly_one_chunk": (CHUNK, 2 * CHUNK),
    "tail": (3 * CHUNK, 3 * CHUNK + 12345),
    "empty": (CHUNK, CHUNK),
}


@pytest.mark.parametrize("with_into", [False, True], ids=["no_into", "into"])
@pytest.mark.parametrize("how", ["write", "stream"])
@pytest.mark.parametrize("rng", list(RANGES.values()), ids=list(RANGES))
def test_ranged_read(rng, how, with_into):
    plugin = memory.MemoryStoragePlugin()
    data = _data(3 * CHUNK + 12345, seed=3)
    _run(_put(plugin, "obj", data, how))
    begin, end = rng
    into = bytearray(end - begin) if with_into else None
    buf = _run(_get(plugin, "obj", rng, memoryview(into) if into is not None else None))
    assert bytes(buf) == data[begin:end]
    if with_into:
        assert bytes(into) == data[begin:end]
    _run(plugin.close())


def test_read_without_into_copies_one_chunk_never():
    plugin = memory.MemoryStoragePlugin()
    data = _data(3 * CHUNK + 12345, seed=4)
    _run(_put(plugin, "w", data, "write"))
    _run(_put(plugin, "s", data, "stream"))
    with _Session() as s:
        # One buffer: a read-only view of the stored array.
        buf = _run(_get(plugin, "w"))
        assert buf.readonly and buf.obj is plugin.objects["w"].parts[0]
        buf = _run(_get(plugin, "s", (CHUNK + 1, 2 * CHUNK - 1)))
        assert buf.readonly and buf.obj is plugin.objects["s"].parts[1]
        assert s.counter(UNLOCKED) == 0
        # Several chunks: one contiguous buffer made by one off-lock copy.
        buf = _run(_get(plugin, "s"))
        assert bytes(buf) == data and s.counter(UNLOCKED) == len(data)
    _run(plugin.close())


def test_read_of_a_stored_bytes_object_and_errors():
    plugin = memory.MemoryStoragePlugin()
    plugin.objects["x"] = bytes(range(100))
    assert _run(_get(plugin, "x")) is plugin.objects["x"]
    assert bytes(_run(_get(plugin, "x", (10, 20)))) == bytes(range(10, 20))
    with pytest.raises(FileNotFoundError):
        _run(_get(plugin, "missing"))
    with pytest.raises(ValueError):
        _run(_get(plugin, "x", (0, 10), memoryview(bytearray(9))))


def test_delete_and_list_prefix():
    plugin = memory.MemoryStoragePlugin()
    for path, n in (("a/b", 10), ("a/c", T + 3), ("b/d", 1), ("a/e/f", CHUNK + 1)):
        _run(_put(plugin, path, _data(n), "stream" if n > T else "write"))
    assert _run(plugin.list_prefix("a/")) == ["a/b", "a/c", "a/e/f"]
    assert _run(plugin.list_prefix("")) == ["a/b", "a/c", "a/e/f", "b/d"]
    _run(plugin.delete("a/c"))
    assert _run(plugin.list_prefix("a/")) == ["a/b", "a/e/f"]
    with pytest.raises(FileNotFoundError):
        _run(plugin.delete("a/c"))
    with pytest.raises(FileNotFoundError):
        _run(_get(plugin, "a/c"))
    _run(plugin.close())


@pytest.mark.parametrize("other", [b"", b"x", None, 3, "str"], ids=["empty", "short", "none", "int", "str"])
def test_stored_chunks_compare_like_bytes(other):
    data = _data(2 * CHUNK + 9)
    plugin = memory.MemoryStoragePlugin()
    _run(_put(plugin, "obj", data, "stream"))
    stored = plugin.objects["obj"]
    assert stored != other and not stored == other
    flipped = bytearray(data)
    flipped[CHUNK + 1] ^= 1
    assert stored != bytes(flipped) and stored == bytearray(data) and stored == memoryview(data)
    assert bytearray(stored) == data and np.frombuffer(stored, np.uint8).nbytes == len(data)
    _run(plugin.close())


@pytest.mark.parametrize("how", ["write", "stream"])
@pytest.mark.parametrize("size", [100, T, 3 * CHUNK + 12345], ids=["small", "threshold", "chunks"])
def test_caller_may_overwrite_its_buffer_after_the_await(how, size):
    plugin = memory.MemoryStoragePlugin()
    data = _data(size, seed=5)
    src = bytearray(data)

    async def go():
        if how == "write":
            await plugin.write(WriteIO(path="obj", buf=memoryview(src)))
            src[:] = b"\xff" * size
            return
        stream = await plugin.write_stream("obj")
        for b in range(0, size, CHUNK):
            await stream.append(memoryview(src)[b : b + CHUNK])
            # Staging recycles its chunk as soon as the append returns.
            src[b : b + CHUNK] = b"\xff" * len(src[b : b + CHUNK])
        await stream.commit()

    _run(go())
    assert plugin.objects["obj"] == data
    _run(plugin.close())


def test_commit_copies_nothing(monkeypatch):
    fills = []
    real_fill = memory._fill

    def counting_fill(dst, pieces):
        fills.append(dst.nbytes)
        real_fill(dst, pieces)

    monkeypatch.setattr(memory, "_fill", counting_fill)
    plugin = memory.MemoryStoragePlugin()
    data = _data(3 * CHUNK + 12345, seed=6)

    async def go(s):
        stream = await plugin.write_stream("obj")
        for b in range(0, len(data), CHUNK):
            await stream.append(memoryview(data)[b : b + CHUNK])
        filled = list(stream._parts)
        before = (s.counter(UNLOCKED), len(fills))
        await stream.commit()
        return filled, before

    with _Session() as s:
        filled, before = _run(go(s))
        # Three chunks through the pool; the 12345-byte tail is an inline copy.
        assert before == (s.counter(UNLOCKED), len(fills)) == (3 * CHUNK, 3)
    stored = plugin.objects["obj"]
    assert len(stored.parts) == 4 and all(a is b for a, b in zip(stored.parts, filled))
    assert stored == data
    _run(plugin.close())


def test_pool_is_made_at_first_use_and_shut_down_by_close():
    before = set(threading.enumerate())

    def pool_threads():
        return [t for t in set(threading.enumerate()) - before if t.name.startswith("tss-memory")]

    plugin = memory.MemoryStoragePlugin()
    _run(_put(plugin, "small", b"x" * 10, "write"))
    assert plugin._pool is None
    _run(_put(plugin, "big", _data(T), "write"))
    assert plugin._pool is not None and pool_threads()
    _run(plugin.close())
    assert plugin._pool is None and not pool_threads()
    # A store is shared by name: it takes writes again after a close.
    _run(_put(plugin, "big2", _data(T, seed=1), "write"))
    assert plugin.objects["big2"] == _data(T, seed=1)
    _run(plugin.close())


def _longest_late_wake(fn) -> float:
    tm = telemetry.Telemetry(probe_host=False)
    probe = hostprobe.HostProbe(tm).start()
    try:
        fn()
    finally:
        probe.stop()
    return max((sp.dur for sp in tm.spans(name=hostprobe.SPAN)), default=0.0)


def test_copies_let_go_of_the_lock_on_the_plugins_pool(monkeypatch):
    """The probe beside the plugin's write and stream of 256 MiB wakes late
    by under a quarter of what it does beside one ``bytes`` of the same."""
    threads = set()
    real_fill = memory._fill

    def recording_fill(dst, pieces):
        threads.add(threading.current_thread().name)
        real_fill(dst, pieces)

    monkeypatch.setattr(memory, "_fill", recording_fill)
    n = 256 << 20
    src = np.full(n, 7, np.uint8)
    src[::4096] = np.arange(len(src[::4096]), dtype=np.uint64).astype(np.uint8)
    chunk = 64 << 20

    stores = []

    def plugin_copies():
        plugin = memory.MemoryStoragePlugin()
        _run(_put(plugin, "w", memoryview(src), "write"))
        _run(_put(plugin, "s", memoryview(src), "stream", chunk=chunk))
        _run(plugin.close())
        stores.append(plugin)

    def plain_copy():
        assert len(bytes(memoryview(src))) == n

    # Relative, and the best of three rounds, so that a loaded host that
    # starves the probe's thread now and then does not decide it.
    rounds = []
    for _ in range(3):
        ours, plain = _longest_late_wake(plugin_copies), _longest_late_wake(plain_copy)
        rounds.append((ours, plain))
        if ours < plain / 4:
            break
    assert any(ours < plain / 4 for ours, plain in rounds), rounds
    assert all(p.objects["w"] == src and p.objects["s"] == src for p in stores)
    assert threads and all(name.startswith("tss-memory") for name in threads), threads


# ---------------------------------------------------------------------------
# Recycling: a dropped object's arrays fill the next copies of their size
# ---------------------------------------------------------------------------

RECYCLED_BYTES, FRESH = "storage.memory.recycled_bytes", "storage.memory.fresh_bytes"


@pytest.fixture
def pool(monkeypatch):
    """A pool of this test's own, in place of the process's."""
    own = memory.BufferPool()
    monkeypatch.setattr(memory, "RECYCLED", own)
    yield own
    own.release()


def _parts(plugin, path):
    return list(plugin.objects[path].parts)


@pytest.mark.parametrize("how", ["write", "stream"])
def test_a_put_after_a_same_size_delete_reuses_its_buffers(pool, how):
    plugin = memory.MemoryStoragePlugin()
    first, second = _data(3 * CHUNK + 12345, seed=7), _data(3 * CHUNK + 12345, seed=8)
    # A stream's 12345-byte tail is an inline ``bytes``: new, never pooled.
    big = _copied_off_the_lock(how, len(first))
    with _Session() as s:
        _run(_put(plugin, "a", first, how))
        assert (s.counter(RECYCLED_BYTES), s.counter(FRESH)) == (0, len(first))
    old = [id(p) for p in _parts(plugin, "a") if isinstance(p, np.ndarray)]
    _run(plugin.delete("a"))
    assert pool.nbytes == big
    with _Session() as s:
        _run(_put(plugin, "b", second, how))
        assert (s.counter(RECYCLED_BYTES), s.counter(FRESH)) == (big, len(second) - big)
        span = s.tm.spans(name="storage.write" if how == "write" else "storage.write_stream")[-1]
        assert span.attrs["recycled"] == big
    assert sorted(id(p) for p in _parts(plugin, "b") if isinstance(p, np.ndarray)) == sorted(old)
    assert pool.nbytes == 0
    # Every byte is the new object's.
    assert plugin.objects["b"] == second and bytes(_run(_get(plugin, "b"))) == second
    _run(plugin.close())


def test_an_overwrite_recycles_what_it_replaces(pool):
    plugin = memory.MemoryStoragePlugin()
    _run(_put(plugin, "a", _data(T + 1, seed=1), "write"))
    old = id(plugin.objects["a"].parts[0])
    _run(_put(plugin, "a", _data(2 * T, seed=2), "write"))
    assert pool.nbytes == T + 1
    with _Session() as s:
        _run(_put(plugin, "b", _data(T + 1, seed=3), "write"))
        assert s.counter(RECYCLED_BYTES) == T + 1
    assert id(_parts(plugin, "b")[0]) == old and plugin.objects["b"] == _data(T + 1, seed=3)
    _run(plugin.close())


def _whole_read(plugin, path):
    """A read without ``into``: a view of the stored array."""
    return _run(_get(plugin, path))


def _pieces_view(plugin, path):
    """Views of the parts, as ``Chunks.pieces`` gives them, the object
    itself let go."""
    return plugin.objects[path].pieces(1, len(plugin.objects[path]) - 1)


def _held_object(plugin, path):
    """The stored object itself, kept by a caller."""
    return plugin.objects[path]


@pytest.mark.parametrize("hold", [_whole_read, _pieces_view, _held_object], ids=["read", "pieces", "object"])
def test_a_buffer_someone_still_references_is_not_recycled(pool, hold):
    plugin = memory.MemoryStoragePlugin()
    data = _data(CHUNK, seed=9)
    _run(_put(plugin, "a", data, "write"))
    held = hold(plugin, "a")
    _run(plugin.delete("a"))
    assert pool.nbytes == 0
    with _Session() as s:
        for i in range(3):
            _run(_put(plugin, f"b{i}", _data(CHUNK, seed=10 + i), "write"))
        assert (s.counter(RECYCLED_BYTES), s.counter(FRESH)) == (0, 3 * CHUNK)
    # The holder still reads the deleted object's bytes.
    seen = b"".join(bytes(v) for v in held) if isinstance(held, list) else bytes(held)
    assert seen == (data[1:-1] if isinstance(held, list) else data)
    _run(plugin.close())


def test_inline_objects_are_never_pooled(pool):
    """An inline ``bytes`` counts as a new buffer, and never returns."""
    plugin = memory.MemoryStoragePlugin()
    for _ in range(2):
        with _Session() as s:
            _run(_put(plugin, "s", _data(T - 1), "write"))
            _run(_put(plugin, "c", _data(3 * CHUNK + 12345), "stream"))
            fresh = s.counter(FRESH)
        _run(plugin.delete("s"))
        _run(plugin.delete("c"))
        # The stream's 12345-byte tail was an inline ``bytes``.
        assert pool.nbytes == 3 * CHUNK
    # The second round's chunks were the first's.
    assert fresh == T - 1 + 12345
    _run(plugin.close())


def test_the_pool_is_shared_across_roots_and_outlives_close(pool):
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    a, b = url_to_storage_plugin("memory://recycle/1"), url_to_storage_plugin("memory://recycle/2")
    assert a is not b
    try:
        _run(_put(a, "x", _data(3 * CHUNK, seed=1), "stream"))
        _run(a.delete("x"))
        _run(a.close())
        with _Session() as s:
            _run(_put(b, "x", _data(3 * CHUNK, seed=2), "stream"))
            assert (s.counter(RECYCLED_BYTES), s.counter(FRESH)) == (3 * CHUNK, 0)
        assert b.objects["x"] == _data(3 * CHUNK, seed=2)
        _run(b.close())
    finally:
        memory.SHARED_ROOTS.pop("recycle/1", None)
        memory.SHARED_ROOTS.pop("recycle/2", None)


def test_the_pool_never_holds_more_than_one_store_held(pool):
    """Bound by the most one store held; an array given beyond it frees the
    oldest kept, so sizes no longer written age out."""
    small, large = memory.MemoryStoragePlugin(), memory.MemoryStoragePlugin()
    for i in range(4):
        _run(_put(small, f"o{i}", _data(T + 1, seed=i), "write"))
    assert pool.bound == 4 * (T + 1)
    for i in range(4):
        _run(small.delete(f"o{i}"))
    assert pool.nbytes == pool.bound == 4 * (T + 1)
    # Another size: it draws nothing, and what it drops frees the oldest.
    for i in range(2):
        _run(_put(large, f"o{i}", _data(2 * T, seed=i), "write"))
    assert pool.bound == 4 * (T + 1)
    for i in range(2):
        _run(large.delete(f"o{i}"))
        assert pool.nbytes <= pool.bound
    assert pool.nbytes == 4 * T
    # An array larger than the bound is never kept.
    _run(_put(large, "huge", _data(5 * T), "write"))
    assert pool.bound == 5 * T
    _run(large.delete("huge"))
    assert pool.nbytes == 5 * T
    with _Session() as s:
        _run(_put(large, "again", _data(5 * T), "write"))
        _run(_put(small, "gone", _data(T + 1), "write"))
        assert (s.counter(RECYCLED_BYTES), s.counter(FRESH)) == (5 * T, T + 1)
    pool.bound = 2 * T
    _run(large.delete("again"))
    assert pool.nbytes == 0
    _run(small.close())
    _run(large.close())


def test_releasing_empties_the_pool(pool):
    plugin = memory.MemoryStoragePlugin()
    _run(_put(plugin, "a", _data(2 * CHUNK), "stream"))
    _run(plugin.delete("a"))
    assert memory.recycled_bytes() == 2 * CHUNK
    assert memory.release_recycled_buffers() == 2 * CHUNK
    assert memory.recycled_bytes() == 0
    with _Session() as s:
        _run(_put(plugin, "b", _data(2 * CHUNK), "stream"))
        assert (s.counter(RECYCLED_BYTES), s.counter(FRESH)) == (0, 2 * CHUNK)
    _run(plugin.close())


def test_stores_on_many_threads_never_share_a_buffer(pool):
    """Twelve threads, each with a store and an event loop, put and delete
    objects of one size at a short switch interval: every object keeps its
    own bytes, no two live objects share an array, and the pool stays in
    its bound."""
    import sys

    n_threads, rounds = 12, 20
    stores = [memory.MemoryStoragePlugin() for _ in range(n_threads)]
    errors = []

    def work(k):
        plugin = stores[k]

        async def go():
            for r in range(rounds):
                data = bytes([(k * rounds + r) % 251]) * T
                await _put(plugin, f"o{r % 3}", data, "write")
                await asyncio.sleep(0)
                if plugin.objects[f"o{r % 3}"] != data:
                    errors.append((k, r))
                if r % 2:
                    await plugin.delete(f"o{r % 3}")
                assert pool.nbytes <= pool.bound
            await plugin.close()

        try:
            asyncio.run(go())
        except BaseException as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    live = [id(p) for st in stores for obj in st.objects.values() for p in obj.parts]
    assert live and len(live) == len(set(live))


def test_the_staging_budget_counts_recycled_buffers_as_available(pool, monkeypatch):
    """The pool's pages are filled by the next snapshot's copies in place of
    new ones, so a take into the store, whose budget reads ``MemAvailable``,
    adds them back; another operation (a restore) finds no page there."""
    from torchsnapshot_tpu_torch import scheduler

    from torchsnapshot_tpu_torch.utils import knobs

    monkeypatch.setattr(scheduler, "_mem_available_bytes", lambda: 10 << 30)
    monkeypatch.setattr(knobs, "_local_world_size", 1)
    monkeypatch.delenv("TSS_TORCH_PER_RANK_MEMORY_BUDGET_BYTES", raising=False)
    plugin = memory.MemoryStoragePlugin()
    before = scheduler.get_process_memory_budget_bytes(writes_to=plugin)
    _run(_put(plugin, "a", _data(2 * CHUNK), "stream"))
    _run(plugin.delete("a"))
    assert pool.nbytes == 2 * CHUNK
    assert scheduler.get_process_memory_budget_bytes(writes_to=plugin) - before == pytest.approx(2 * CHUNK * 0.6, abs=1)
    assert scheduler.get_process_memory_budget_bytes() == before
    _run(plugin.close())


def test_a_restore_gives_the_recycled_buffers_back(pool):
    """A restore's pages come on top of a take's peak: it empties the pool
    before it allocates, and restores byte for byte."""
    import torch

    import torchsnapshot_tpu_torch as tts

    w = torch.arange(3 * T // 4, dtype=torch.float32)
    app = {"m": tts.StateDict(w=w)}
    tts.Snapshot.take("memory://recycle/r1", app)
    tts.Snapshot.take("memory://recycle/r2", app)
    store = memory.SHARED_ROOTS["recycle/r1"]
    try:
        for path in _run(store.list_prefix("")):
            _run(store.delete(path))
        assert pool.nbytes == w.numel() * 4
        out = tts.StateDict(w=torch.zeros_like(w))
        tts.Snapshot("memory://recycle/r2").restore({"m": out}, device="cpu")
        assert pool.nbytes == 0 and torch.equal(out["w"], w)
    finally:
        memory.SHARED_ROOTS.pop("recycle/r1", None)
        memory.SHARED_ROOTS.pop("recycle/r2", None)

"""The write and read pipelines of both packages on the same requests, the
counterparts of ``tests/test_scheduler.py``: the budget bounds the staged
bytes, a request larger than the budget is still admitted,
``PendingIOWork`` defers the writes until ``complete()``, ranged reads,
a write failure propagates, the budget knob, and the streamed path
(bounded budget high-water mark and exact bytes, a mid-stream staging
failure and an append failure each leave no object and a balanced budget,
chunks attributed to both streams, the streaming knob off); end to end,
a take that streams through the fs plugin. Each case runs both packages'
pipelines through their own ``execute_write_reqs`` (the port's async entry
point) on their own ``memory://`` plugins.

The read entry points differ in signature: the JAX package's takes the
rank and its pools, the port's a consumer executor."""

import asyncio
import contextlib
import json
import types
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import hashing as jhashing, io_types as jio_types, scheduler as jscheduler
from torchsnapshot_tpu.storage_plugins import memory as jmemory
from torchsnapshot_tpu.utils import knobs as jknobs
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import hashing as thashing, io_types as tio_types, scheduler as tscheduler
from torchsnapshot_tpu_torch.storage_plugins import memory as tmemory
from torchsnapshot_tpu_torch.utils import knobs as tknobs

PKGS = ["jax", "port"]
CHUNK = 1024
INFLIGHT = 2


def _pkg(name):
    if name == "jax":
        return types.SimpleNamespace(
            io=jio_types, sched=jscheduler, mem=jmemory.MemoryStoragePlugin, knobs=jknobs, hashing=jhashing,
            budget=lambda pipeline: pipeline.budget,
            read=lambda reqs, storage: jscheduler.execute_read_reqs(reqs, storage, memory_budget_bytes=10**6, rank=0),
        )

    async def read(reqs, storage):
        with ThreadPoolExecutor(2) as ex:
            return await tscheduler.execute_read_reqs(reqs, storage, 10**6, ex)

    return types.SimpleNamespace(
        io=tio_types, sched=tscheduler, mem=tmemory.MemoryStoragePlugin, knobs=tknobs, hashing=thashing,
        budget=lambda pipeline: pipeline._engine.budget, read=read,
    )


@pytest.fixture(autouse=True)
def _debug_ledger():
    with jknobs.override_debug_ledger(True), tknobs.override_debug_ledger(True):
        yield


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _tracking_stager(p, live):
    class TrackingStager(p.io.BufferStager):
        def __init__(self, nbytes):
            self.nbytes = nbytes

        async def stage_buffer(self, executor=None):
            live["now"] += self.nbytes
            live["peak"] = max(live["peak"], live["now"])
            await asyncio.sleep(0.01)
            return bytearray(self.nbytes)

        def get_staging_cost_bytes(self):
            return self.nbytes

    return TrackingStager


def _releasing_storage(p, live):
    class ReleasingStorage(p.mem):
        async def write(self, write_io):
            await asyncio.sleep(0.01)
            await super().write(write_io)
            live["now"] -= memoryview(write_io.buf).nbytes

    return ReleasingStorage()


def _write(p, reqs, storage, budget):
    async def go():
        pending = await p.sched.execute_write_reqs(reqs, storage, memory_budget_bytes=budget, rank=0)
        await pending.complete()
        return pending

    return _run(go())


def _data_objects(storage):
    return sorted(k for k in storage.objects if not k.startswith(".checksums"))


@pytest.mark.parametrize("pkg", PKGS)
def test_budget_bounds_staged_bytes(pkg):
    p, live = _pkg(pkg), {"now": 0, "peak": 0}
    stager = _tracking_stager(p, live)
    storage = _releasing_storage(p, live)
    pending = _write(p, [p.io.WriteReq(f"p{i}", stager(100)) for i in range(50)], storage, 300)
    assert len(_data_objects(storage)) == 50 and ".checksums.0" in storage.objects
    assert live["peak"] <= 300 + 100
    assert pending.budget_balanced


@pytest.mark.parametrize("pkg", PKGS)
def test_a_request_larger_than_the_budget_is_admitted(pkg):
    p, live = _pkg(pkg), {"now": 0, "peak": 0}
    storage = _releasing_storage(p, live)
    _write(p, [p.io.WriteReq("huge", _tracking_stager(p, live)(10_000))], storage, 10)
    assert _data_objects(storage) == ["huge"]


@pytest.mark.parametrize("pkg", PKGS)
def test_pending_io_work_defers_the_writes(pkg):
    p, live = _pkg(pkg), {"now": 0, "peak": 0}

    class SlowStorage(p.mem):
        async def write(self, write_io):
            await asyncio.sleep(0.05)
            await super().write(write_io)

    storage = SlowStorage()
    reqs = [p.io.WriteReq(f"p{i}", _tracking_stager(p, live)(10)) for i in range(20)]

    async def go():
        pending = await p.sched.execute_write_reqs(reqs, storage, memory_budget_bytes=10**6, rank=0)
        unwritten = len(storage.objects) < 20
        await pending.complete()
        return unwritten, pending.progress.counters()

    unwritten, counters = _run(go())
    assert unwritten and len(_data_objects(storage)) == 20
    assert counters["bytes_written"] == 200


@pytest.mark.parametrize("pkg", PKGS)
def test_read_pipeline_with_ranges(pkg):
    p = _pkg(pkg)
    box = []

    class Counting(p.io.BufferConsumer):
        def __init__(self, expected):
            self.expected = expected

        async def consume_buffer(self, buf, executor=None):
            assert bytes(buf) == self.expected
            box.append(1)

        def get_consuming_cost_bytes(self):
            return len(self.expected)

    storage = p.mem()
    storage.objects["obj"] = bytes(range(100))
    reqs = [
        p.io.ReadReq("obj", Counting(bytes(range(100)))),
        p.io.ReadReq("obj", Counting(bytes(range(10, 20))), byte_range=(10, 20)),
    ]
    stats = _run(p.read(reqs, storage))
    assert len(box) == 2 and stats["requests"] == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_write_failure_propagates(pkg):
    p, live = _pkg(pkg), {"now": 0, "peak": 0}

    class Failing(p.mem):
        async def write(self, write_io):
            raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        _write(p, [p.io.WriteReq(f"p{i}", _tracking_stager(p, live)(10)) for i in range(4)], Failing(), 10**6)


@pytest.mark.parametrize("pkg", PKGS)
def test_memory_budget_knob(pkg):
    p = _pkg(pkg)
    with p.knobs.override_memory_budget_bytes(12345):
        assert p.sched.get_process_memory_budget_bytes(None) == 12345


# ------------------------------------------------------------- streaming


def _streaming_stager(p, n_chunks, delay=0.0, fail_at=None):
    class StreamingStager(p.io.BufferStager):
        def get_staging_cost_bytes(self):
            return n_chunks * CHUNK

        def can_stream(self):
            return True

        async def stage_buffer(self, executor=None):
            return b"".join(bytes([i % 251]) * CHUNK for i in range(n_chunks))

        async def stage_chunks(self, executor=None):
            for i in range(n_chunks):
                if fail_at is not None and i == fail_at:
                    raise RuntimeError("mid-stream staging failure")
                if delay:
                    await asyncio.sleep(delay)
                yield bytes([i % 251]) * CHUNK

    return StreamingStager()


def _slow_append_storage(p, delay):
    class SlowAppend(p.mem):
        async def write_stream(self, path):
            inner = await super().write_stream(path)

            class _Slow:
                async def append(self, buf):
                    await asyncio.sleep(delay)
                    await inner.append(buf)

                async def commit(self):
                    await inner.commit()

                async def abort(self):
                    await inner.abort()

            return _Slow()

    return SlowAppend()


@contextlib.contextmanager
def _stream_knobs(p):
    with p.knobs.override_stream_writes(True), p.knobs.override_stream_chunk_bytes(CHUNK), p.knobs.override_stream_inflight(INFLIGHT):
        yield


def _expected(n_chunks):
    return b"".join(bytes([i % 251]) * CHUNK for i in range(n_chunks))


@pytest.mark.parametrize("pkg", PKGS)
def test_streamed_request_budget_bounded_and_bytes_exact(pkg):
    p = _pkg(pkg)
    n = 50
    storage = _slow_append_storage(p, 0.001)
    with _stream_knobs(p):
        pending = _write(p, [p.io.WriteReq("big", _streaming_stager(p, n, delay=0.001))], storage, 10**9)
    budget = p.budget(pending._pipeline)
    assert budget.high_water_bytes <= INFLIGHT * CHUNK + 3 * CHUNK
    assert budget.available == budget.total and pending.budget_balanced
    assert storage.objects["big"] == _expected(n)
    rec = json.loads(storage.objects[".checksums.0"])["big"]
    assert p.hashing.record_crc(rec) == zlib.crc32(_expected(n))
    assert p.hashing.record_size(rec) == n * CHUNK


def test_the_same_stream_records_the_same_digest():
    """Both packages' sidecar records of one streamed object are equal."""
    recs = {}
    for name in PKGS:
        p = _pkg(name)
        storage = p.mem()
        with _stream_knobs(p):
            _write(p, [p.io.WriteReq("big", _streaming_stager(p, 12))], storage, 10**9)
        recs[name] = json.loads(storage.objects[".checksums.0"])["big"]
    assert recs["port"] == recs["jax"]


@pytest.mark.parametrize("pkg", PKGS)
def test_midstream_staging_failure_leaves_nothing(pkg):
    p = _pkg(pkg)
    storage = p.mem()
    # Built under the knobs: the port plans its graph at construction.
    with _stream_knobs(p):
        pipeline = p.sched._WritePipeline([p.io.WriteReq("doomed", _streaming_stager(p, 10, fail_at=4))], storage, 10**9, 0)

    async def go():
        with _stream_knobs(p):
            await pipeline.run_until_staged()

    with pytest.raises(RuntimeError, match="mid-stream staging failure"):
        _run(go())
    budget = p.budget(pipeline)
    assert "doomed" not in storage.objects and budget.available == budget.total
    assert "doomed" not in pipeline.checksums


@pytest.mark.parametrize("pkg", PKGS)
def test_append_failure_cleans_up_without_deadlock(pkg):
    p = _pkg(pkg)

    class FailingAppend(p.mem):
        async def write_stream(self, path):
            inner = await super().write_stream(path)

            class _Failing:
                async def append(self, buf):
                    raise OSError("append exploded")

                async def commit(self):
                    await inner.commit()

                async def abort(self):
                    await inner.abort()

            return _Failing()

    storage = FailingAppend()
    with _stream_knobs(p):
        pipeline = p.sched._WritePipeline([p.io.WriteReq("x", _streaming_stager(p, 20, delay=0.001))], storage, 10**9, 0)

    async def go():
        with _stream_knobs(p):
            await asyncio.wait_for(pipeline.run_until_staged(), timeout=30)

    with pytest.raises(OSError, match="append exploded"):
        _run(go())
    budget = p.budget(pipeline)
    assert "x" not in storage.objects and budget.available == budget.total


@pytest.mark.parametrize("pkg", PKGS)
def test_streamed_chunks_attributed_to_both_streams(pkg):
    p = _pkg(pkg)
    storage = _slow_append_storage(p, 0.01)
    with _stream_knobs(p):
        pending = _write(p, [p.io.WriteReq("big", _streaming_stager(p, 12, delay=0.01))], storage, 10**9)
    stats = pending.pipeline_stats
    assert stats["stage_busy_s"] > 0 and stats["io_busy_s"] > 0
    assert stats["overlap_s"] > 0.5 * min(stats["stage_busy_s"], stats["io_busy_s"])


@pytest.mark.parametrize("pkg", PKGS)
def test_streaming_off_uses_the_whole_buffer(pkg):
    p = _pkg(pkg)
    storage = p.mem()
    with p.knobs.override_stream_writes(False), p.knobs.override_stream_chunk_bytes(CHUNK):
        _write(p, [p.io.WriteReq("big", _streaming_stager(p, 8))], storage, 10**9)
    assert storage.objects["big"] == _expected(8)


def test_a_take_streams_through_fs_and_restores_in_both_packages(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((256, 64)).astype(np.float32), "b": rng.standard_normal((8,)).astype(np.float32)}
    path = str(tmp_path / "snap")
    with tknobs.override_stream_chunk_bytes(8192), tknobs.override_stream_inflight(2), tknobs.override_stream_writes(True):
        tts.Snapshot.take(path, {"m": tts.StateDict(**{k: torch.from_numpy(v.copy()) for k, v in tree.items()})})
    out = tts.StateDict(w=torch.zeros(256, 64), b=torch.zeros(8))
    tts.Snapshot(path).restore({"m": out}, device="cpu")
    jout = jts.StateDict(w=np.zeros((256, 64), np.float32), b=np.zeros(8, np.float32))
    jts.Snapshot(path).restore({"m": jout})
    for k, v in tree.items():
        assert out[k].numpy().tobytes() == np.asarray(jout[k]).tobytes() == v.tobytes()
    assert tts.Snapshot(path).verify() == jts.Snapshot(path).verify() == {}


def _device_slab(pkg, arrays):
    """One device-packed slab of ``arrays`` through the package's own
    preparer and batcher (host tensors in the port: K1's plain pack)."""
    if pkg == "jax":
        import jax.numpy as jnp

        from torchsnapshot_tpu import batcher
        from torchsnapshot_tpu.io_preparers.array import ArrayIOPreparer

        prepared = [ArrayIOPreparer.prepare_write(k, jnp.asarray(a)) for k, a in arrays.items()]
        _, reqs = batcher.batch_write_requests([e for e, _ in prepared], [r for _, rs in prepared for r in rs])
    else:
        from torchsnapshot_tpu_torch import batcher
        from torchsnapshot_tpu_torch.io_preparers.array import ArrayIOPreparer

        prepared = [ArrayIOPreparer.prepare_write(k, torch.from_numpy(a.copy())) for k, a in arrays.items()]
        reqs = batcher.batch_write_requests([e for e, _ in prepared], [r for _, rs in prepared for r in rs])
    (slab,) = reqs
    assert type(slab.buffer_stager).__name__ == "DeviceBatchedBufferStager"
    assert slab.buffer_stager.stream_holds_full_buffer
    return slab


@pytest.mark.parametrize("pkg", PKGS)
def test_streamed_device_slab_is_admitted_at_its_full_size(pkg):
    """A device-packed slab streams slices of one whole host buffer, so the
    budget charges the whole slab for the stream's life, not the stream's
    depth in chunks (here 8 x 1 KiB chunks in a 64 KiB slab)."""
    p = _pkg(pkg)
    rng = np.random.default_rng(11)
    arrays = {f"a{i:02d}": rng.standard_normal(1024).astype(np.float32) for i in range(16)}
    slab_bytes = 16 * 4096
    budget_bytes = 4 * slab_bytes
    storage = p.mem()
    with _stream_knobs(p), p.knobs.override_slab_size_threshold_bytes(1 << 20):
        slab = _device_slab(pkg, arrays)
        pending = _write(p, [slab], storage, budget_bytes)
    budget = p.budget(pending._pipeline)
    assert slab_bytes <= budget.high_water_bytes <= budget_bytes
    assert budget.available == budget.total and pending.budget_balanced
    assert storage.objects[slab.path] == b"".join(arrays[k].tobytes() for k in sorted(arrays))
    rec = json.loads(storage.objects[".checksums.0"])[slab.path]
    assert p.hashing.record_size(rec) == slab_bytes


class _Member:
    """A slab member's stager, as ``BatchedBufferStager.can_stream`` reads it."""

    def __init__(self, is_async_snapshot, device):
        self.is_async_snapshot = is_async_snapshot
        self.tensor = torch.zeros(4, device=device)


@pytest.mark.parametrize(
    "members, streams",
    [
        ([(False, False), (False, False)], True),  # a sync take
        ([(True, True), (True, True)], True),  # an async take's forked or captured members
        ([(True, True), (True, False)], False),  # one member the take must copy first
        ([(True, False)], False),  # one member: the plain object
    ],
)
# "meta" stands in for a device tensor: the rule reads no data.
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_slab_streams_only_when_no_member_must_be_copied_in_the_stall(members, streams, device):
    """An async take's non-deferred slab member, on any device, keeps its
    slab off the stream: a host tensor would be read after ``async_take``
    returns, and a device one would hold the slab's write in the stall.
    The JAX package's rule, with its immutable arrays read as the port's
    forked or captured tensors."""
    from torchsnapshot_tpu_torch.batcher import BatchedBufferStager

    slab = [
        (tio_types.WriteReq(f"m{i}", _Member(is_async, device), defer_staging=deferred), 16 * i, 16 * (i + 1))
        for i, (is_async, deferred) in enumerate(members)
    ]
    assert BatchedBufferStager(slab, "batched/x").can_stream() is streams

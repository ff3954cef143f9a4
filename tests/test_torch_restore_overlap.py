"""Overlapped restore and the read merge gap, against the JAX package's.

With ``TSS_TORCH_RESTORE_OVERLAP`` on, each entry's finalizer (the H2D of
its filled host buffer) runs on the restore's event loop, the caller's
thread, as the entry's last read is consumed; off, every finalizer runs
after the last read (phase-split). The host buffer of a CUDA target is
allocated when its entry's first read arrives and released by the
finalizer. On this CPU host the finalizer path is driven with a CPU
stand-in for ``d2h.HostToDevice`` (its copy is a host copy), the way the
JAX package's tests drive theirs on the CPU backend; the CUDA path runs in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu.utils import knobs as jknobs
from torchsnapshot_tpu_torch import d2h, snapshot as tsnap
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.io_preparers import array as tarray
from torchsnapshot_tpu_torch.io_types import ReadIO
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.utils import knobs as tknobs


class _SlowReads(FSStoragePlugin):
    """Delays every data read and records when each one ends."""

    delay_s = 0.15
    done: list = []

    async def read(self, read_io: ReadIO) -> None:
        data = not read_io.path.startswith(".")
        if data:
            await asyncio.sleep(type(self).delay_s)
        await super().read(read_io)
        if data:
            type(self).done.append(time.monotonic())


class _HostCopies:
    """``d2h.HostToDevice`` with host copies: records each finalize's time
    and thread, and how many entry buffers were alive at that moment."""

    events: list = []

    def stream(self, device):
        return None

    def copy(self, host, live, device):
        type(self).events.append((time.monotonic(), threading.current_thread(), _Alive.n))
        if isinstance(live, torch.Tensor) and live.shape == host.shape and live.dtype == host.dtype:
            live.copy_(host)
            return live
        return host.clone()

    def finish(self):
        pass


class _Alive(tarray.LazyHostTarget):
    """Counts the entry buffers allocated and not yet released."""

    n = 0
    peak = 0

    def get(self):
        fresh = self._arr is None
        out = super().get()
        if fresh:
            type(self).n += 1
            type(self).peak = max(type(self).peak, type(self).n)
        return out

    def release(self):
        if self._arr is not None:
            type(self).n -= 1
        super().release()


@pytest.fixture
def host_finalizers(monkeypatch):
    """Routes CPU targets through the finalizer path a CUDA target takes."""
    _HostCopies.events = []
    _Alive.n = _Alive.peak = 0
    _SlowReads.done = []
    monkeypatch.setattr(d2h, "HostToDevice", _HostCopies)
    monkeypatch.setattr(tsnap, "LazyHostTarget", _Alive)
    monkeypatch.setattr(tsnap, "_stages_through_host", lambda dest: True)
    return _HostCopies


def _take(path, n=4, elems=1024):
    state = {f"w{i}": np.arange(elems, dtype=np.float32) + i for i in range(n)}
    tts.Snapshot.take(path, {"s": tts.StateDict(**from_numpy_tree(state, device="cpu"))})
    return state


def _restore_slow(monkeypatch, path, state, overlap, io=1, delay=0.15):
    import torchsnapshot_tpu_torch.snapshot as snap_mod

    _SlowReads.delay_s = delay
    monkeypatch.setattr(snap_mod, "url_to_storage_plugin", lambda url: _SlowReads(url))
    tgt = tts.StateDict(**{k: torch.zeros(len(v)) for k, v in state.items()})
    with tknobs.override_restore_overlap(overlap), tknobs.override_max_concurrent_io(io):
        tts.Snapshot(path).restore({"s": tgt}, device="cpu")
    for k, v in state.items():
        assert np.array_equal(tgt[k].numpy(), v)


def test_finalizers_overlap_reads_on_the_callers_thread(tmp_path, monkeypatch, host_finalizers):
    path = str(tmp_path / "s")
    state = _take(path)
    _restore_slow(monkeypatch, path, state, overlap=True)
    events = host_finalizers.events
    assert len(events) == len(state)  # no entry left unfinalized
    assert all(t is threading.current_thread() for _, t, _ in events)
    # Four serialized reads of 0.15 s: the first entry lands ~0.45 s
    # before the last read ends.
    assert min(ts for ts, _, _ in events) < max(_SlowReads.done) - 0.1


def test_overlap_off_is_phase_split(tmp_path, monkeypatch, host_finalizers):
    path = str(tmp_path / "s")
    state = _take(path, n=3)
    _restore_slow(monkeypatch, path, state, overlap=False, delay=0.05)
    events = host_finalizers.events
    assert len(events) == len(state)
    assert min(ts for ts, _, _ in events) >= max(_SlowReads.done)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "phase_split"])
def test_host_buffers_are_allocated_lazily_and_released_early(tmp_path, monkeypatch, host_finalizers, overlap):
    """One read at a time: with overlap, at most the entry being finalized
    holds a buffer (plus one read ahead); phase-split, all of them."""
    path = str(tmp_path / "s")
    state = _take(path, n=8)
    _restore_slow(monkeypatch, path, state, overlap=overlap, delay=0.0)
    if overlap:
        assert _Alive.peak <= 2
    else:
        assert _Alive.peak == len(state)
    assert _Alive.n == 0


def test_chunked_entry_finalizes_after_its_last_chunk(tmp_path, monkeypatch, host_finalizers):
    """An entry read in several ranged pieces (its chunks) finalizes once,
    after its last piece."""
    path = str(tmp_path / "s")
    with tknobs.override_max_chunk_size_bytes(1024):
        state = _take(path, n=2, elems=2048)
    _restore_slow(monkeypatch, path, state, overlap=True, delay=0.02)
    assert len(host_finalizers.events) == 2


# ---------------------------------------------------------------------------
# The same snapshot through both packages, overlap on and off
# ---------------------------------------------------------------------------


def _jax_sharded_take(path):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(3)
    tree = {
        "w": rng.standard_normal((64, 48)).astype(np.float32),
        "v": rng.standard_normal((40,)).astype(np.float32),
    }
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    jstate = {
        "w": jax.device_put(tree["w"], NamedSharding(mesh, P("x", "y"))),
        "v": jax.device_put(tree["v"], NamedSharding(mesh, P("x"))),
    }
    jts.Snapshot.take(path, {"s": jts.StateDict(**jstate)})
    return tree


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "phase_split"])
@pytest.mark.parametrize("layout", ["whole", "resharded"])
def test_same_snapshot_restores_bit_exact_through_both(tmp_path, monkeypatch, host_finalizers, overlap, layout):
    path = str(tmp_path / "s")
    if layout == "whole":
        rng = np.random.default_rng(4)
        tree = {f"w{i}": rng.standard_normal((33, 7 + i)).astype(np.float32) for i in range(4)}
        jts.Snapshot.take(path, {"s": jts.StateDict(**{k: v.copy() for k, v in tree.items()})})
    else:
        tree = _jax_sharded_take(path)
    with tknobs.override_restore_overlap(overlap), jknobs.override_restore_overlap(overlap):
        port = tts.StateDict(**{k: torch.zeros(v.shape) for k, v in tree.items()})
        tts.Snapshot(path).restore({"s": port}, device="cpu")
        jtgt = jts.StateDict(**{k: np.zeros_like(v) for k, v in tree.items()})
        jts.Snapshot(path).restore({"s": jtgt})
    for k, v in tree.items():
        assert port[k].numpy().tobytes() == v.tobytes() == np.asarray(jtgt[k]).tobytes()
    # A whole entry finalizes through the host stand-in; a saved-sharded
    # one scatters (K3's plain version) as each read is consumed.
    assert len(host_finalizers.events) == (len(tree) if layout == "whole" else 0)


def _dtensor_worker(rank, world_size, root, overlap):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    mesh = DeviceMesh("cpu", list(range(world_size)))
    full = np.arange(48 * 40, dtype=np.float32).reshape(48, 40)
    src = dtensor_from_numpy(full, mesh, [Shard(0)])
    tts.Snapshot.take(root, {"s": tts.StateDict(w=src)})
    with tknobs.override_restore_overlap(overlap):
        tgt = dtensor_from_numpy(np.zeros_like(full), mesh, [Shard(1)])
        tts.Snapshot(root).restore({"s": tts.StateDict(w=tgt)}, device="cpu")
    cols = 40 // world_size
    assert np.array_equal(tgt.to_local().numpy(), full[:, rank * cols : (rank + 1) * cols])


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "phase_split"])
def test_dtensor_reshard_restores_bit_exact(tmp_path, overlap):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_dtensor_worker, 2, args=(str(tmp_path / "s"), overlap), process_group=True)
    # The JAX package restores the same snapshot, resharded.
    full = np.arange(48 * 40, dtype=np.float32).reshape(48, 40)
    jtgt = jts.StateDict(w=np.zeros_like(full))
    with jknobs.override_restore_overlap(overlap):
        jts.Snapshot(str(tmp_path / "s")).restore({"s": jtgt})
    assert np.array_equal(np.asarray(jtgt["w"]), full)


# ---------------------------------------------------------------------------
# The auto gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cpus", [1, 8])
def test_auto_gate_matches_the_jax_package(monkeypatch, cpus):
    monkeypatch.setattr(jknobs, "_usable_cpu_count", lambda: cpus)
    monkeypatch.setattr(tknobs, "_usable_cpu_count", lambda: cpus)
    monkeypatch.delenv("TSS_TORCH_RESTORE_OVERLAP", raising=False)
    monkeypatch.delenv("TORCHSNAPSHOT_TPU_RESTORE_OVERLAP", raising=False)
    # (has device targets, the JAX package's platforms, the port's device types)
    cases = [
        (False, None, None),
        (True, {"cpu"}, {"cpu"}),
        (True, {"tpu"}, {"cuda"}),
        (True, {"tpu", "cpu"}, {"cuda", "cpu"}),
    ]
    for has, jp, tp in cases:
        want = jknobs.is_restore_overlap_enabled(has_jax_targets=has, target_platforms=jp)
        got = tknobs.is_restore_overlap_enabled(has_device_targets=has, target_platforms=tp)
        assert got == want, (cpus, has, tp)
        # The callable form is evaluated only where it decides.
        assert tknobs.is_restore_overlap_enabled(has, lambda tp=tp: tp) == want
    assert tknobs.is_restore_overlap_enabled(True, {"cuda"}) is True
    assert tknobs.is_restore_overlap_enabled(True, {"cpu"}) is (cpus > 1)


def test_restore_gate_reads_the_targets_devices():
    live = {"a": torch.zeros(2), "b": 3, "c": np.zeros(2)}
    assert tsnap._target_device_types(live, {"a": None, "b": None, "c": None, "d": None}) == {"cpu"}
    assert tsnap._target_device_types({}, {"a": None}) == set()


# ---------------------------------------------------------------------------
# The read merge gap
# ---------------------------------------------------------------------------


class _Collect:
    """A consumer of both packages' interfaces that records what it got."""

    def __init__(self, out, key):
        self.out, self.key = out, key

    async def consume_buffer(self, buf, executor=None):
        self.out[self.key] = bytes(memoryview(buf))

    def get_consuming_cost_bytes(self):
        return 1


# (path, begin, end): members of two slabs, gaps of 0, 32, 64, 100, 4000
# and 5000 bytes, one overlap.
_RANGES = [
    ("a", 0, 100), ("a", 100, 200), ("a", 232, 300), ("a", 364, 400), ("a", 500, 600),
    ("a", 4600, 4700), ("a", 9700, 9800), ("a", 9750, 9900),
    ("b", 10, 20), ("b", 84, 90), ("b", 5000, 5008),
]


def _merged(pkg, gap, out):
    if pkg == "jax":
        from torchsnapshot_tpu.batcher import batch_read_requests
        from torchsnapshot_tpu.io_types import ReadReq
    else:
        from torchsnapshot_tpu_torch.batcher import batch_read_requests
        from torchsnapshot_tpu_torch.io_types import ReadReq
    reqs = [ReadReq(path=p, buffer_consumer=_Collect(out, (p, b, e)), byte_range=(b, e)) for p, b, e in _RANGES]
    return batch_read_requests(reqs, merge_gap_bytes=gap)


@pytest.mark.parametrize("gap", [0, 64, 4096])
def test_merge_gap_merges_the_same_ranges(gap):
    shape = {}
    for pkg in ("jax", "port"):
        merged = _merged(pkg, gap, {})
        shape[pkg] = sorted((r.path, tuple(r.byte_range)) for r in merged)
    assert shape["port"] == shape["jax"]
    assert len(shape["port"]) < len(_RANGES)
    if gap == 0:
        assert ("a", (0, 200)) in shape["port"] and ("a", (232, 300)) in shape["port"]
    if gap == 64:
        assert ("a", (0, 400)) in shape["port"]


@pytest.mark.parametrize("gap", [0, 64, 4096])
def test_merge_gap_delivers_each_consumer_its_own_bytes(gap):
    blobs = {p: bytes(np.random.default_rng(ord(p)).integers(0, 256, 10_000, dtype=np.uint8)) for p in "ab"}
    out = {}
    merged = _merged("port", gap, out)

    async def run():
        for r in merged:
            b, e = r.byte_range
            await r.buffer_consumer.consume_buffer(memoryview(blobs[r.path][b:e]))

    asyncio.run(run())
    assert out == {(p, b, e): blobs[p][b:e] for p, b, e in _RANGES}


def test_merge_gap_knob_drives_a_restore(tmp_path, monkeypatch):
    """A slab restored with its members' ranges gapped (a partial restore)
    reads bit-exact through merged reads."""
    monkeypatch.setenv("TSS_TORCH_ENABLE_BATCHING", "1")
    path = str(tmp_path / "s")
    tree = {f"t{i}": np.full(50 + i, float(i), np.float32) for i in range(6)}
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    keep = {k: v for k, v in tree.items() if int(k[1:]) % 2 == 0}
    for gap in ("0", "4096"):
        monkeypatch.setenv("TSS_TORCH_READ_MERGE_GAP_BYTES", gap)
        tgt = tts.StateDict(**{k: torch.zeros(len(v)) for k, v in tree.items()})
        tts.Snapshot(path).restore({"m": tgt}, device="cpu", include=[f"m/{k}" for k in keep])
        for k, v in tree.items():
            want = v if k in keep else np.zeros_like(v)
            assert np.array_equal(tgt[k].numpy(), want)
        reqs = tsnap.LAST_RESTORE_STATS["requests"]
        assert reqs == (1.0 if gap == "4096" else float(len(keep)))

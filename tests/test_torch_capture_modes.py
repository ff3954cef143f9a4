"""The port's capture and transfer controls against the JAX package's.

- The HBM cap: for the same leaf sizes and caps, the same leaves end up
  host-captured (the JAX package's fork on CPU arrays under
  ``TORCHSNAPSHOT_TPU_ASYNC_FORK_HBM_LIMIT_BYTES``; the port's plain
  decision function with a CPU fork).
- Eager D2H: both packages hint the same deferred requests of a two-rank
  replicated take, each rank only its own; a streamed request hints its
  first chunk only.
- The zero-copy capture's version check, checksums off, device batching
  off and the slab threshold, on the CPU.
- Every ``TORCHSNAPSHOT_TPU_*`` knob against its ``TSS_TORCH_*``
  counterpart: the same parsing of the same strings and the same default,
  or an entry of the deliberate differences ``ROADMAP.md`` lists.

The port's CUDA paths run in ``tests/test_torch_cuda.py``; here a CPU
tensor stands in for a captured CUDA tensor where a test says so.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import io_preparer as jio
from torchsnapshot_tpu.utils import knobs as jknobs
from torchsnapshot_tpu_torch import io_preparer as tio
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.io_preparers.array import ArrayBufferStager, chunk_row_ranges
from torchsnapshot_tpu_torch.io_types import CaptureViolationError
from torchsnapshot_tpu_torch.utils import knobs as tknobs

# ---------------------------------------------------------------------------
# The HBM cap
# ---------------------------------------------------------------------------

# Leaf sizes in float32 elements: a transformer's mix of small norms and
# large matrices.
_LEAF_ELEMS = [64, 4096, 16, 2048, 1024, 8, 4096, 512, 256, 32]
_TOTAL = 4 * sum(_LEAF_ELEMS)


def _jax_captured(limit):
    import jax

    from torchsnapshot_tpu.io_preparer import HostCapturedArray

    dev = jax.devices()[0]
    arrs = [jax.device_put(np.full(n, float(i), np.float32), dev) for i, n in enumerate(_LEAF_ELEMS)]
    with jknobs.override_async_fork_hbm_limit_bytes(limit):
        out = jio._defensive_device_copies(arrs)
    for a, o in zip(arrs, out):
        got = o.assembled_local() if isinstance(o, HostCapturedArray) else np.asarray(o)
        assert np.array_equal(np.asarray(a), got)
    return [i for i, o in enumerate(out) if isinstance(o, HostCapturedArray)]


def _port_captured(limit):
    group = [torch.full((n,), float(i)) for i, n in enumerate(_LEAF_ELEMS)]
    captured = []
    out = tio._fork_or_capture(
        group, lambda g: [t.clone() for t in g], lambda g: [t.clone() for t in g], captured, limit=limit
    )
    assert all(torch.equal(a, b) for a, b in zip(out, group))
    ids = {id(t) for t in captured}
    return [i for i, t in enumerate(group) if id(t) in ids]


@pytest.mark.parametrize(
    "limit", [0, _TOTAL // 3, _TOTAL // 2, _TOTAL], ids=["zero", "third", "half", "all"]
)
def test_hbm_cap_captures_the_same_leaves(limit):
    want = _jax_captured(limit)
    assert _port_captured(limit) == want
    if limit == 0:
        assert want == list(range(len(_LEAF_ELEMS)))
    if limit == _TOTAL:
        assert want == []
    if limit == _TOTAL // 2:
        assert 0 < len(want) < len(_LEAF_ELEMS)


class _FakeStream:
    def wait_stream(self, other):
        pass

    def wait_event(self, ev):
        pass


class _FakeEvent:
    def record(self, stream=None):
        pass


def test_hbm_cap_knob_reaches_the_cuda_capture(monkeypatch):
    """``_defensive_device_copies`` (the CUDA path) hands the knob to the
    same decision function; its streams and events are stand-ins here."""
    seen = {}

    def decide(group, fork, capture, captured, depth=0, limit=None, forked_bytes=None):
        seen["limit"] = limit
        return [t.clone() for t in group]

    monkeypatch.setattr(tio, "_fork_or_capture", decide)
    monkeypatch.setattr(tio.d2h, "side_stream", lambda device, role: _FakeStream())
    monkeypatch.setattr(tio.torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(tio.torch.cuda, "Event", _FakeEvent)
    with tknobs.override_async_fork_hbm_limit_bytes(1234):
        tio._defensive_device_copies([torch.zeros(4)])
    assert seen["limit"] == 1234


# ---------------------------------------------------------------------------
# Eager D2H: which requests are hinted
# ---------------------------------------------------------------------------

_HINT_TREE = {f"w{i}": np.full((16 + 4 * i, 8), float(i), np.float32) for i in range(7)}


def _record(calls, out_dir, rank):
    with open(os.path.join(out_dir, f"hints.{rank}.json"), "w") as f:
        json.dump(sorted(calls), f)


def _jax_hint_worker(rank, world_size, out_dir):
    import jax
    import jax.numpy as jnp

    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.io_preparers import array as jarray

    calls = []
    jarray.ArrayBufferStager.start_d2h_hint = lambda self, *a, **k: calls.append(self.entry.location)
    dev = jax.devices()[0]
    state = {"m": jts.StateDict(**{k: jax.device_put(jnp.asarray(v), dev) for k, v in _HINT_TREE.items()})}
    jts.Snapshot.async_take(os.path.join(out_dir, "snap"), state, replicated=["**"]).wait()
    _record(calls, out_dir, rank)


def _port_hint_worker(rank, world_size, out_dir):
    from torchsnapshot_tpu_torch import io_preparer
    from torchsnapshot_tpu_torch.io_preparers import array as tarray

    # A CPU tensor stands in for a CUDA one captured zero-copy: it is
    # deferred (captured) as a CUDA leaf would be.
    os.environ["TSS_TORCH_ASYNC_CAPTURE"] = "donate"
    io_preparer.cuda_source = lambda v: v if isinstance(v, torch.Tensor) else None
    io_preparer.d2h.ready_event = lambda device: None
    calls = []
    tarray.ArrayBufferStager.start_d2h_hint = lambda self, *a, **k: calls.append(self.entry.location)
    state = {"m": tts.StateDict(**from_numpy_tree(_HINT_TREE, device="cpu"))}
    tts.Snapshot.async_take(os.path.join(out_dir, "snap"), state, replicated=["**"]).wait()
    _record(calls, out_dir, rank)


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "off"])
def test_eager_d2h_hints_the_same_requests_per_rank(tmp_path, eager):
    from torchsnapshot_tpu.test_utils import run_with_processes as jrun
    from torchsnapshot_tpu_torch.test_utils import run_with_processes as trun

    flag = "1" if eager else "0"
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    with jknobs.override_async_eager_d2h(eager), tknobs.override_async_eager_d2h(eager):
        assert os.environ["TSS_TORCH_ASYNC_EAGER_D2H"] == flag
        jrun(_jax_hint_worker, 2, args=(str(jdir),))
        trun(_port_hint_worker, 2, args=(str(tdir),))
    got = {}
    for name, d in (("jax", jdir), ("port", tdir)):
        got[name] = [json.loads((d / f"hints.{r}.json").read_text()) for r in range(2)]
    assert got["port"] == got["jax"]
    if eager:
        # Each rank hints only what it writes: disjoint, covering every leaf.
        r0, r1 = (set(h) for h in got["port"])
        assert r0 and r1 and not (r0 & r1)
        assert r0 | r1 == {f"replicated/m/{k}" for k in _HINT_TREE}
    else:
        assert got["port"] == [[], []]


class _Lanes:
    def __init__(self):
        self.submitted = []

    def submit_to_host(self, src, wait=None, path="", check=None):
        self.submitted.append((path, tuple(src.shape)))
        return _Done(src)


class _Done:
    def __init__(self, value):
        self.value = value

    def cancel(self):
        return False


def test_streamed_request_hints_its_first_chunk_only():
    """Both packages: a request that will stream hints its first stream
    chunk, one that will not hints the whole tensor."""
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.io_preparers.array import ArrayIOPreparer as JPrep

    shape = (64, 256)  # 64 KiB rows of float32: 4 chunks of 16 rows
    chunk = 16 * 256 * 4
    rows = chunk_row_ranges(shape, 4, chunk)
    assert len(rows) == 4
    with jknobs.override_stream_chunk_bytes(chunk), tknobs.override_stream_chunk_bytes(chunk):
        with jknobs.override_stream_writes(True):
            _, jreqs = JPrep.prepare_write("0/w", jax.device_put(jnp.zeros(shape, jnp.float32)), False, True)
            jreqs[0].buffer_stager.start_d2h_hint()
            j_first = jreqs[0].buffer_stager._first_slice.shape
        # A meta tensor: a device tensor with no storage, hinted but never read.
        for stream, want in ((True, (rows[0][1] - rows[0][0], 256)), (False, shape)):
            stager = ArrayBufferStager(torch.empty(shape, device="meta"), _entry(shape), True)
            lanes = _Lanes()
            stager.start_d2h_hint(lanes, stream=stream)
            stager.start_d2h_hint(lanes, stream=stream)  # once per take
            assert lanes.submitted == [("0/w", want)]
        assert tuple(j_first) == (rows[0][1] - rows[0][0], 256)


def _entry(shape):
    from torchsnapshot_tpu_torch.manifest import ArrayEntry

    return ArrayEntry(location="0/w", serializer="raw", dtype="float32", shape=list(shape), replicated=False)


def test_cpu_tensor_is_never_hinted():
    stager = ArrayBufferStager(torch.zeros(8), _entry((8,)), True)
    lanes = _Lanes()
    stager.start_d2h_hint(lanes)
    assert lanes.submitted == []


# ---------------------------------------------------------------------------
# The zero-copy capture's promise
# ---------------------------------------------------------------------------


def test_version_check_catches_an_in_place_change():
    t = torch.zeros(16)
    stager = ArrayBufferStager(t, _entry((16,)), True)
    stager.expect_version = t._version  # pin_version records CUDA tensors only
    stager.check_version()
    t[3] = 1.0
    with pytest.raises(CaptureViolationError, match="changed in place"):
        stager.check_version()
    # Views share the counter: a write through a view counts.
    stager.expect_version = t._version
    t[2:4].add_(1.0)
    with pytest.raises(CaptureViolationError):
        stager.check_version()


def test_broken_promise_fails_the_async_take(tmp_path, monkeypatch):
    """A CPU tensor captured as a CUDA one would be under ``donate``: an
    in-place change before its bytes are copied fails ``wait()`` and
    commits nothing."""
    monkeypatch.setenv("TSS_TORCH_ASYNC_CAPTURE", "donate")
    monkeypatch.setattr(tio, "cuda_source", lambda v: v if isinstance(v, torch.Tensor) else None)
    monkeypatch.setattr(tio.d2h, "ready_event", lambda device: None)
    monkeypatch.setattr(ArrayBufferStager, "pin_version", lambda self: setattr(self, "expect_version", self.tensor._version))
    gate = __import__("threading").Event()
    real = ArrayBufferStager.stage_buffer

    async def held(self, executor=None):
        gate.wait(10)
        out = await real(self, executor)
        self.check_version()  # where a CUDA copy's lane checks it
        return out

    monkeypatch.setattr(ArrayBufferStager, "stage_buffer", held)
    w = torch.arange(64, dtype=torch.float32)
    path = str(tmp_path / "s")
    pending = tts.Snapshot.async_take(path, {"m": tts.StateDict(w=w)})
    w.add_(1.0)  # the promise broken
    gate.set()
    with pytest.raises(tts.snapshot.CheckpointAbortedError) as ei:
        pending.wait()
    assert isinstance(ei.value.__cause__, CaptureViolationError)
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


@pytest.mark.parametrize("batching", ["0", "1"], ids=["plain", "batched"])
def test_kept_promise_commits_bit_exact(tmp_path, monkeypatch, batching):
    """Every stager kind takes the eager hint: slabs of members packed on
    their device hint nothing, host-concatenated slabs hint each member."""
    monkeypatch.setenv("TSS_TORCH_ASYNC_CAPTURE", "donate")
    monkeypatch.setenv("TSS_TORCH_ENABLE_BATCHING", batching)
    monkeypatch.setattr(tio, "cuda_source", lambda v: v if isinstance(v, torch.Tensor) else None)
    monkeypatch.setattr(tio.d2h, "ready_event", lambda device: None)
    state = {"w": torch.arange(64, dtype=torch.float32), "c": torch.arange(8).to(torch.complex64), "c2": torch.arange(6).to(torch.complex64),
             "b": torch.ones(16, dtype=torch.bfloat16), "i": torch.arange(5)}
    path = str(tmp_path / "s")
    tts.Snapshot.async_take(path, {"m": tts.StateDict(state)}).wait()
    tgt = tts.StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    tts.Snapshot(path).restore({"m": tgt}, device="cpu")
    for k, v in state.items():
        assert torch.equal(tgt[k], v), k


@pytest.mark.parametrize("mode", ["donate", "no_device_copy", "fork"])
def test_zero_copy_modes(monkeypatch, mode):
    for pkg in (jknobs, tknobs):
        monkeypatch.delenv(pkg._ENV_ASYNC_CAPTURE, raising=False)
        monkeypatch.delenv(pkg._ENV_ASYNC_DEVICE_COPY, raising=False)
    if mode == "donate":
        monkeypatch.setenv("TSS_TORCH_ASYNC_CAPTURE", "donate")
    elif mode == "no_device_copy":
        monkeypatch.setenv("TSS_TORCH_ASYNC_DEVICE_COPY", "0")
    # One setting decides: the device copy off resolves to donate.
    assert tknobs.get_async_capture_mode() == ("fork" if mode == "fork" else "donate")


# ---------------------------------------------------------------------------
# Checksums off, device batching off, the slab threshold
# ---------------------------------------------------------------------------


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((96, 32)).astype(np.float32),
        "b": rng.standard_normal(32).astype(np.float32),
        "ids": np.arange(10, dtype=np.int64),
    }


@pytest.mark.parametrize("batching", ["0", "1"])
def test_checksums_off_writes_no_sidecar_in_both_packages(tmp_path, monkeypatch, batching):
    import torchsnapshot_tpu as jts

    for prefix in ("TSS_TORCH_", "TORCHSNAPSHOT_TPU_"):
        monkeypatch.setenv(prefix + "CHECKSUMS", "0")
        monkeypatch.setenv(prefix + "ENABLE_BATCHING", batching)
    tree = _tree()
    jts.Snapshot.take(str(tmp_path / "j"), {"m": jts.StateDict(**{k: v.copy() for k, v in tree.items()})})
    tts.Snapshot.take(str(tmp_path / "t"), {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    for d in ("j", "t"):
        assert not [f for f in os.listdir(tmp_path / d) if f.startswith(".checksums")]
    tgt = tts.StateDict(**from_numpy_tree({k: np.zeros_like(v) for k, v in tree.items()}, device="cpu"))
    tts.Snapshot(str(tmp_path / "j")).restore({"m": tgt}, device="cpu")
    for k, v in tree.items():
        assert np.array_equal(tgt[k].numpy(), v)


def test_checksums_off_leaves_no_stale_sidecar(tmp_path, monkeypatch):
    path = str(tmp_path / "s")
    tree = _tree()
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    assert os.path.exists(os.path.join(path, ".checksums.0"))
    monkeypatch.setenv("TSS_TORCH_CHECKSUMS", "0")
    tree1 = _tree(1)
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree1, device="cpu"))})
    assert not os.path.exists(os.path.join(path, ".checksums.0"))
    # Stale digests would fail this read under verification.
    monkeypatch.setenv("TSS_TORCH_VERIFY_READS", "all")
    tgt = tts.StateDict(**from_numpy_tree({k: np.zeros_like(v) for k, v in tree1.items()}, device="cpu"))
    tts.Snapshot(path).restore({"m": tgt}, device="cpu")
    for k, v in tree1.items():
        assert np.array_equal(tgt[k].numpy(), v)


def test_slab_threshold_knob_sizes_the_slabs(tmp_path, monkeypatch):
    """The same threshold in both packages gives the same slab layout."""
    import torchsnapshot_tpu as jts

    for prefix in ("TSS_TORCH_", "TORCHSNAPSHOT_TPU_"):
        monkeypatch.setenv(prefix + "ENABLE_BATCHING", "1")
        monkeypatch.setenv(prefix + "SLAB_SIZE_THRESHOLD_BYTES", "1024")
    tree = {f"t{i}": np.full(64 + 16 * i, float(i), np.float32) for i in range(8)}
    jts.Snapshot.take(str(tmp_path / "j"), {"m": jts.StateDict(**{k: v.copy() for k, v in tree.items()})})
    tts.Snapshot.take(str(tmp_path / "t"), {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})

    def layout(d):
        man = json.loads((tmp_path / d / ".snapshot_metadata").read_text())["manifest"]
        objects = {}
        for p, e in man.items():
            loc = e.get("location")
            if loc is not None:
                objects.setdefault(loc, []).append((p, tuple(e.get("byte_range") or ())))
        # Slab names are fresh uuids per take.
        return sorted(("slab" if loc.startswith("batched/") else loc, sorted(v)) for loc, v in objects.items())

    assert layout("t") == layout("j")
    assert sum(1 for k, _ in layout("t") if k == "slab") >= 2


def test_device_batching_off_uses_the_host_slab(monkeypatch):
    from torchsnapshot_tpu_torch import batcher

    monkeypatch.setenv("TSS_TORCH_ENABLE_BATCHING", "1")
    members = [(_Req(torch.zeros(4)), 0, 16), (_Req(torch.zeros(4)), 16, 32)]
    assert batcher._device_packable(members)
    monkeypatch.setenv("TSS_TORCH_DEVICE_BATCHING", "0")
    assert not batcher._device_packable(members)


class _Req:
    def __init__(self, t):
        self.buffer_stager = ArrayBufferStager(t, _entry(tuple(t.shape)))


# ---------------------------------------------------------------------------
# Every knob against its counterpart
# ---------------------------------------------------------------------------

_BOOL = ["0", "1", "false", "False", "off", "on", "true", ""]
_INT = ["0", "1", "4096", "123456789", "x"]
_FLOAT = ["0.5", "2", "30", "0", ""]


def _same(fn):
    return (fn, fn)


# knob suffix -> (strings tried, (getter of the JAX knobs module, getter of the port's))
KNOBS = {
    "MAX_CHUNK_SIZE_BYTES": (_INT, _same(lambda k: k.get_max_chunk_size_bytes())),
    "MAX_SHARD_SIZE_BYTES": (_INT, _same(lambda k: k.get_max_shard_size_bytes())),
    "SLAB_SIZE_THRESHOLD_BYTES": (_INT, _same(lambda k: k.get_slab_size_threshold_bytes())),
    "ENABLE_BATCHING": (_BOOL, _same(lambda k: k.is_batching_enabled())),
    "PER_RANK_MEMORY_BUDGET_BYTES": (_INT, _same(lambda k: k.get_memory_budget_override_bytes())),
    "BARRIER_TIMEOUT_S": (["1", "2.5", "x"], _same(lambda k: k.get_barrier_timeout_s())),
    "DISABLE_NATIVE_IO": (_BOOL, _same(lambda k: k.is_native_io_enabled())),
    "DIRECT_IO_THRESHOLD_BYTES": (_INT, _same(lambda k: k.get_direct_io_threshold_bytes())),
    "DIRECT_IO_CONCURRENCY": (_INT, _same(lambda k: k.get_direct_io_concurrency())),
    "DIRECT_IO_CHUNK_BYTES": (_INT, _same(lambda k: k.get_direct_io_chunk_bytes())),
    "ASYNC_DEVICE_COPY": (_BOOL, _same(lambda k: k.is_async_device_copy_enabled())),
    "ASYNC_EAGER_D2H": (_BOOL, _same(lambda k: k.is_async_eager_d2h_enabled())),
    "DEVICE_BATCHING": (_BOOL, _same(lambda k: k.is_device_batching_enabled())),
    "ASYNC_FORK_HBM_LIMIT_BYTES": (_INT, _same(lambda k: k.get_async_fork_hbm_limit_bytes())),
    "ASYNC_CAPTURE": (["fork", "donate", "DONATE", "other", ""], _same(lambda k: k.get_async_capture_mode())),
    "COMPRESSION": (["none", "zlib", "ZLIB", "off", "0", "", "lz4"], _same(lambda k: k.get_compression())),
    "COMPRESSION_LEVEL": (["0", "1", "9", "10", "x"], _same(lambda k: k.get_compression_level(_codec="zlib"))),
    "COMPRESSION_FRAME_BYTES": (_INT, _same(lambda k: k.get_compression_frame_bytes())),
    "S3_CHUNK_BYTES": (_INT, _same(lambda k: k.get_s3_chunk_bytes())),
    "GCS_CHUNK_BYTES": (_INT, _same(lambda k: k.get_gcs_chunk_bytes())),
    "CHECKSUMS": (_BOOL, _same(lambda k: k.is_checksums_enabled())),
    "TRACE": (["/t/x.json", ""], _same(lambda k: k.get_trace_path())),
    "TELEMETRY_ARTIFACTS": (_BOOL, _same(lambda k: k.is_telemetry_artifacts_enabled())),
    "STALL_WARN_S": (_FLOAT, _same(lambda k: k.get_stall_warn_s())),
    "RECORDER": (_BOOL, _same(lambda k: k.is_recorder_enabled())),
    "RECORDER_CAPACITY": (_INT, _same(lambda k: k.get_recorder_capacity())),
    "RECORDER_INTERVAL_S": (_FLOAT + ["x"], _same(lambda k: k.get_recorder_interval_s())),
    "RECORDER_DUMP": (["/t/rec.json", ""], _same(lambda k: k.get_recorder_dump_path())),
    "STEP_TELEMETRY": (_BOOL, _same(lambda k: k.is_step_telemetry_enabled())),
    "FLEET_TELEMETRY": (_BOOL + ["auto", " ON "], _same(lambda k: k.get_fleet_telemetry_mode())),
    "FLEET_BEACON_S": (_FLOAT + ["x"], _same(lambda k: k.get_fleet_beacon_s())),
    "DEDUP_DIGESTS": (_BOOL + ["auto", "AUTO"], _same(lambda k: (k.get_dedup_digests_env(), k.is_dedup_digests_enabled(), k.is_dedup_digests_enabled(True)))),
    "PLAN_CACHE": (_BOOL, _same(lambda k: k.is_plan_cache_enabled())),
    "PLAN_CACHE_SIZE": (_INT, _same(lambda k: k.get_plan_cache_size())),
    "PREPARED_CACHE": (_BOOL, _same(lambda k: k.is_prepared_cache_enabled())),
    "PREPARED_CACHE_SIZE": (_INT, _same(lambda k: k.get_prepared_cache_size())),
    "RESTORE_OVERLAP": (_BOOL + ["auto"], _same(lambda k: k.is_restore_overlap_enabled())),
    "STREAM_WRITES": (_BOOL + ["auto", "AUTO"], _same(lambda k: (k.get_stream_writes_mode(), k.get_stream_writes_env()))),
    "STREAM_CHUNK_BYTES": (_INT, _same(lambda k: (k.get_stream_chunk_bytes(), k.get_hash_chunk_bytes()))),
    "STREAM_INFLIGHT": (_INT, _same(lambda k: k.get_stream_inflight())),
    "D2H_LANES": (_INT, _same(lambda k: k.get_d2h_lanes())),
    "D2H_WINDOW_BYTES": (_INT, _same(lambda k: k.get_d2h_window_bytes())),
    "HASH_CHUNK_BYTES": (_INT, _same(lambda k: k.get_hash_chunk_bytes())),
    "HASH_WORKERS": (_INT, _same(lambda k: k.get_hash_workers())),
    "QOS": (_BOOL, _same(lambda k: k.is_qos_enabled())),
    "QOS_POLL_S": (_FLOAT, _same(lambda k: k.get_qos_poll_s())),
    "QOS_MAX_PAUSE_S": (_FLOAT, _same(lambda k: k.get_qos_max_pause_s())),
    "STAGING_THREADS": (_INT, _same(lambda k: (k.get_staging_threads(), k.get_hash_workers()))),
    "MAX_CONCURRENT_IO": (_INT, _same(lambda k: (k.get_max_concurrent_io(), k.get_max_concurrent_io(True)))),
    "CONSUMING_THREADS": (_INT, _same(lambda k: k.get_consuming_threads())),
    "DEBUG_LEDGER": (_BOOL, _same(lambda k: k.is_debug_ledger_enabled())),
    "DEBUG_COLLECTIVES": (_BOOL, _same(lambda k: k.is_debug_collectives_enabled())),
    "DEBUG_EFFECTS": (_BOOL, _same(lambda k: k.is_debug_effects_enabled())),
    "READ_CACHE_DIR": (["/t/cache", ""], _same(lambda k: k.get_read_cache_dir())),
    "READ_CACHE_BYTES": (_INT, _same(lambda k: k.get_read_cache_bytes())),
    "READ_CACHE_VERIFY": (_BOOL, _same(lambda k: k.is_read_cache_verify_enabled())),
    "VERIFY_READS": (_BOOL + ["auto", "all", "ALL"], _same(lambda k: (k.get_verify_reads_mode(), k.is_origin_read_verify_enabled()))),
    "BCAST_RESTORE": (_BOOL + ["auto"], _same(lambda k: (k.is_broadcast_restore_enabled(1), k.is_broadcast_restore_enabled(2)))),
    "BCAST_MAX_BYTES": (_INT, _same(lambda k: k.get_broadcast_max_bytes())),
    "BCAST_READER_DEADLINE_S": (_FLOAT + ["x"], _same(lambda k: k.get_bcast_reader_deadline_s())),
    "SWARM_RESTORE": (_BOOL + ["auto"], _same(lambda k: (k.is_swarm_restore_enabled(1), k.is_swarm_restore_enabled(2)))),
    "SWARM_CHUNK_DEADLINE_S": (_FLOAT + ["x"], _same(lambda k: k.get_swarm_chunk_deadline_s())),
    "READ_MERGE_GAP_BYTES": (_INT, _same(lambda k: k.get_read_merge_gap_bytes())),
    "FAULTS": (["op=write,kind=fail", ""], _same(lambda k: k.get_faults_spec())),
    "CLI_TRACEBACK": (_BOOL, _same(lambda k: k.is_cli_traceback_enabled())),
}

# Knobs the port leaves out on purpose (ROADMAP.md repeats this list).
NOT_PORTED = {
    "STORE_ADDR": "the port's coordinator rides torch.distributed's c10d store",
    "RANK": "the port's coordinator rides torch.distributed's c10d store",
    "WORLD_SIZE": "the port's coordinator rides torch.distributed's c10d store",
    "LAUNCHER_DRAIN_S": "belongs to the JAX package's test launcher",
    "CATALOG": "a take without job= is the catalog off",
    "MAX_CHAIN_LEN": "take(max_chain_len=) per call",
    "SWARM_FANOUT": "swarm.FANOUT is a constant",
    "BCAST_REELECT_MAX": "bcast.REELECT_MAX is a constant",
}

# Ported knobs whose default differs (ROADMAP.md records each): the value
# with the variable unset, and the strings that name the default, are not
# compared; every other string still is.
DEFAULT_DIFFERS = {
    "D2H_WINDOW_BYTES": ("512 MiB, where the JAX package's is 128 MB", ()),
    "ASYNC_EAGER_D2H": ("off, where the JAX package's is on", ()),
    "BCAST_RESTORE": ("auto is off on every storage", ("", "auto")),
    "SWARM_RESTORE": ("auto is off on every storage", ("", "auto")),
}


def _jax_knob_names():
    src = open(jknobs.__file__).read()
    return set(re.findall(r'"TORCHSNAPSHOT_TPU_([A-Z0-9_]+)"', src))


def test_every_jax_knob_is_paired_or_listed():
    names = _jax_knob_names()
    assert len(names) == 73
    assert names == set(KNOBS) | set(NOT_PORTED)
    assert not set(KNOBS) & set(NOT_PORTED)
    src = open(tknobs.__file__).read()
    for name in KNOBS:
        assert f'_P + "{name}"' in src, name
    for name in NOT_PORTED:
        assert f'_P + "{name}"' not in src, name


def _call(fn, mod):
    try:
        return ("ok", fn(mod))
    except Exception as e:  # noqa: BLE001 - the kind of failure is compared
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_knob_parses_as_the_jax_package(monkeypatch, name):
    values, (jfn, tfn) = KNOBS[name]
    jname, tname = "TORCHSNAPSHOT_TPU_" + name, "TSS_TORCH_" + name
    # Each case sees only its own knob.
    for key in list(os.environ):
        if key.startswith("TORCHSNAPSHOT_TPU_") or key.startswith("TSS_TORCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setattr(jknobs, "_local_world_size", 1)
    monkeypatch.setattr(tknobs, "_local_world_size", 1)
    if name not in DEFAULT_DIFFERS:
        assert _call(tfn, tknobs) == _call(jfn, jknobs), "default"
    for value in values:
        if value in DEFAULT_DIFFERS.get(name, ("", ()))[1]:
            continue
        monkeypatch.setenv(jname, value)
        monkeypatch.setenv(tname, value)
        assert _call(tfn, tknobs) == _call(jfn, jknobs), value


# Switches that read a string otherwise than the port did before it took
# the JAX package's parsing: (name, string, what the switch reads now).
_REPARSED = [
    ("PLAN_CACHE", "off", True),
    ("PLAN_CACHE", "", True),
    ("RECORDER", "off", True),
    ("ENABLE_BATCHING", "off", True),
    ("DEBUG_EFFECTS", "off", True),
    ("DISABLE_NATIVE_IO", "off", False),
]
_READERS = {
    "PLAN_CACHE": lambda k: k.is_plan_cache_enabled(),
    "RECORDER": lambda k: k.is_recorder_enabled(),
    "ENABLE_BATCHING": lambda k: k.is_batching_enabled(),
    "DEBUG_EFFECTS": lambda k: k.is_debug_effects_enabled(),
    "DISABLE_NATIVE_IO": lambda k: k.is_native_io_enabled(),
}


@pytest.mark.parametrize("name,value,now", _REPARSED)
def test_reparsed_switch_warns_once(monkeypatch, caplog, name, value, now):
    monkeypatch.setattr(tknobs, "_warned_reparsed", set())
    monkeypatch.setenv("TSS_TORCH_" + name, value)
    with caplog.at_level("WARNING", logger=tknobs.__name__):
        assert _READERS[name](tknobs) is now
        assert _READERS[name](tknobs) is now
    warned = [r for r in caplog.records if "TSS_TORCH_" + name in r.getMessage()]
    assert len(warned) == 1
    monkeypatch.setenv("TSS_TORCH_" + name, "0")
    caplog.clear()
    with caplog.at_level("WARNING", logger=tknobs.__name__):
        monkeypatch.setattr(tknobs, "_warned_reparsed", set())
        _READERS[name](tknobs)
    assert not caplog.records


# ---------------------------------------------------------------------------
# The override context managers
# ---------------------------------------------------------------------------

# The 34 overrides of ported knobs that the port lacked before (the JAX
# package's other 4 belong to NOT_PORTED knobs), each with an argument.
OVERRIDES = {
    "override_async_capture": "donate",
    "override_async_device_copy": False,
    "override_bcast_reader_deadline_s": 0.25,
    "override_broadcast_max_bytes": 4096,
    "override_broadcast_restore": True,
    "override_checksums": False,
    "override_compression_level": 7,
    "override_consuming_threads": 3,
    "override_d2h_lanes": 2,
    "override_d2h_window_bytes": 1 << 20,
    "override_dedup_digests": True,
    "override_device_batching": False,
    "override_direct_io_threshold_bytes": 8192,
    "override_hash_workers": 5,
    "override_memory_budget_bytes": 1 << 30,
    "override_native_io_enabled": False,
    "override_plan_cache": False,
    "override_plan_cache_size": 2,
    "override_prepared_cache": False,
    "override_prepared_cache_size": 3,
    "override_read_cache_bytes": 1 << 24,
    "override_read_cache_dir": "/t/cache",
    "override_read_cache_verify": True,
    "override_read_merge_gap_bytes": 512,
    "override_recorder_capacity": 64,
    "override_recorder_dump_path": "/t/rec.json",
    "override_recorder_interval_s": 0.5,
    "override_slab_size_threshold_bytes": 1 << 16,
    "override_staging_threads": 6,
    "override_stream_inflight": 4,
    "override_stream_writes": True,
    "override_swarm_chunk_deadline_s": 1.5,
    "override_swarm_restore": True,
    "override_verify_reads": "all",
}


def test_every_jax_override_is_ported_or_not_ported():
    jax_names = {n for n in dir(jknobs) if n.startswith("override_")}
    port_names = {n for n in dir(tknobs) if n.startswith("override_")}
    assert len(jax_names) == 67 and len(OVERRIDES) == 34
    assert set(OVERRIDES) <= port_names <= jax_names
    assert jax_names - port_names == {
        "override_bcast_reelect_max", "override_catalog", "override_max_chain_len", "override_swarm_fanout"
    }


def _set_by(override, prefix, arg):
    """The knobs under ``prefix`` that ``override(arg)`` sets, and the
    environment after it exits."""
    before = dict(os.environ)
    with override(arg):
        inside = {k[len(prefix):]: v for k, v in os.environ.items() if k.startswith(prefix) and before.get(k) != v}
    return inside, dict(os.environ) == before


@pytest.mark.parametrize("name", sorted(OVERRIDES))
@pytest.mark.parametrize("prior", [None, "prior"], ids=["unset", "set"])
def test_override_sets_the_knob_as_the_jax_package(monkeypatch, name, prior):
    arg = OVERRIDES[name]
    for key in list(os.environ):
        if key.startswith(("TORCHSNAPSHOT_TPU_", "TSS_TORCH_")):
            monkeypatch.delenv(key)
    jset, _ = _set_by(getattr(jknobs, name), "TORCHSNAPSHOT_TPU_", arg)
    (knob,) = jset
    for prefix in ("TORCHSNAPSHOT_TPU_", "TSS_TORCH_"):
        if prior is None:
            monkeypatch.delenv(prefix + knob, raising=False)
        else:
            monkeypatch.setenv(prefix + knob, prior)
    jset, jrestored = _set_by(getattr(jknobs, name), "TORCHSNAPSHOT_TPU_", arg)
    tset, trestored = _set_by(getattr(tknobs, name), "TSS_TORCH_", arg)
    assert tset == jset and len(tset) == 1, (tset, jset)
    assert trestored and jrestored
    assert os.environ.get("TSS_TORCH_" + knob) == prior

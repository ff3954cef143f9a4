"""Units of the port held against the JAX package's on the same inputs:
the names the parity audit (``test_torch_parity_audit.py``) found missing
and that are now ported (``catalog.chain_len_of_base``,
``flatten.decode_component``, ``serialization.is_raw_serializable`` /
``array_as_bytes_view`` / ``array_from_bytes``,
``io_preparers.array.entry_cost_bytes``,
``ObjectBufferConsumer.set_consume_callback``),
a slab streamed member by member as the JAX package streams it, the step
health detectors (the counterparts of ``tests/test_health.py``) and the
RSS sampler (``tests/test_rss_profiler.py``)."""

import asyncio
import json
import logging
import os
import random
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import catalog as jcat, flatten as jflatten, serialization as jser
from torchsnapshot_tpu.io_preparers import array as jarray
from torchsnapshot_tpu.telemetry import health as jhealth
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import catalog as tcat, flatten as tflatten, serialization as tser
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.io_preparers import array as tarray
from torchsnapshot_tpu_torch.telemetry import health as thealth
from torchsnapshot_tpu_torch.utils import knobs as tknobs
from torchsnapshot_tpu_torch.utils.rss_profiler import measure_rss_deltas


@pytest.mark.parametrize("key", ["plain", "a/b", "100%", "%2F", "x/%/y", "", "ünï/cödé"])
def test_decode_component_inverts_the_encoding_as_in_the_jax_package(key):
    enc = tflatten.encode_component(key)
    assert enc == jflatten.encode_component(key)
    assert tflatten.decode_component(enc) == jflatten.decode_component(enc) == key


@pytest.mark.parametrize(
    "dtype", [np.float32, np.int8, np.bool_, np.complex64, np.float64, ml_dtypes.bfloat16, np.dtype("datetime64[D]"), np.object_]
)
def test_raw_serializable_as_in_the_jax_package(dtype):
    assert tser.is_raw_serializable(dtype) == jser.is_raw_serializable(dtype)


def test_raw_serializable_torch_dtypes():
    assert tser.is_raw_serializable(torch.bfloat16) and tser.is_raw_serializable(torch.float8_e4m3fn)
    assert not tser.is_raw_serializable(torch.quint8)


@pytest.mark.parametrize("shape", [(3, 4), (0,), (), (2, 3, 5)])
def test_byte_views_as_in_the_jax_package(shape):
    a = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    for src in (a, np.asfortranarray(a), a.astype(">f4")):
        assert bytes(tser.array_as_bytes_view(src)) == bytes(jser.array_as_bytes_view(src))
    t = torch.from_numpy(a.copy())
    t_view = t.t() if t.dim() == 2 else t
    assert bytes(tser.array_as_bytes_view(t_view)) == bytes(jser.array_as_bytes_view(np.ascontiguousarray(t_view.numpy())))
    raw = bytes(jser.array_as_bytes_view(a))
    got = tser.array_from_bytes(bytearray(raw), "float32", shape)
    want = jser.array_from_bytes(bytearray(raw), "float32", shape)
    assert got.shape == torch.Size(shape) and got.numpy().tobytes() == want.tobytes()
    assert tser.array_from_bytes(raw, "float32", shape).numpy().tobytes() == raw  # read-only: copied once
    with pytest.raises(ValueError, match="bytes; expected"):
        tser.array_from_bytes(raw + b"x", "float32", shape)


def test_extension_dtype_numpy_leaves_are_written_as_the_jax_package_writes_them(tmp_path):
    """numpy arrays of ml_dtypes' bfloat16, float8, int4 and float4 are
    written raw with the JAX package's dtype strings and bytes, and
    restore through it."""
    names = ("bfloat16", "float8_e4m3fn", "int4", "float4_e2m1fn")
    tree = {n: np.arange(8, dtype=np.float32).astype(getattr(ml_dtypes, n)) for n in names}
    tree["int4_2d"] = np.arange(6).reshape(2, 3).astype(ml_dtypes.int4)
    jts.Snapshot.take(str(tmp_path / "j"), {"m": jts.StateDict(tree)})
    tts.Snapshot.take(str(tmp_path / "t"), {"m": tts.StateDict(tree)})

    def manifest(d):
        return json.load(open(os.path.join(tmp_path, d, ".snapshot_metadata")))["manifest"]

    assert manifest("t") == manifest("j")
    for k in tree:
        assert manifest("t")[f"0/m/{k}"]["serializer"] == "raw"
        assert open(os.path.join(tmp_path, "t/0/m", k), "rb").read() == open(os.path.join(tmp_path, "j/0/m", k), "rb").read()
    out = jts.StateDict({k: np.zeros_like(v) for k, v in tree.items()})
    jts.Snapshot(str(tmp_path / "t")).restore({"m": out})
    assert all(np.asarray(out[k]).tobytes() == v.tobytes() for k, v in tree.items())


@pytest.mark.parametrize("serializer", ["raw", "raw_zlib", "pickle"])
def test_entry_cost_bytes_as_in_the_jax_package(serializer):
    from torchsnapshot_tpu.manifest import ArrayEntry as JEntry
    from torchsnapshot_tpu_torch.manifest import ArrayEntry as TEntry

    dtype = "datetime64[D]" if serializer == "pickle" else "float32"
    kw = dict(location="0/x", serializer=serializer, dtype=dtype, shape=[3, 5], replicated=False)
    assert tarray.entry_cost_bytes(TEntry(**kw)) == jarray.entry_cost_bytes(JEntry(**kw))
    bad = dict(kw, dtype="no-such-dtype")
    assert tarray.entry_cost_bytes(TEntry(**bad)) == jarray.entry_cost_bytes(JEntry(**bad)) == 1024 * 1024


def test_chain_len_of_base_as_in_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    bucket = str(tmp_path / "bucket")
    tree = {"w": np.arange(64, dtype=np.float32)}
    for step in range(3):
        tts.Snapshot.take(f"{bucket}/step_{step}", {"m": tts.StateDict(from_numpy_tree(tree, device="cpu"))}, job="j", step=step)
    tcat._CHAIN_CACHE.clear()
    for base in (f"{bucket}/step_0", f"{bucket}/step_2", f"{bucket}/absent", str(tmp_path / "elsewhere" / "s")):
        assert tcat.chain_len_of_base(bucket, base) == jcat.chain_len_of_base(bucket, base)
    assert tcat.chain_len_of_base(bucket, f"{bucket}/step_2") == 3


def test_object_consumer_callback_can_be_replaced():
    import pickle

    from torchsnapshot_tpu_torch.io_preparers.object import ObjectBufferConsumer

    got = []
    consumer = ObjectBufferConsumer(lambda v: got.append(("first", v)))
    consumer.set_consume_callback(lambda v: got.append(("second", v)))
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(consumer.consume_buffer(pickle.dumps({"k": 1})))
    finally:
        loop.close()
    assert got == [("second", {"k": 1})]


# ---------------------------------------------------------------------------
# A slab streams member by member, as in the JAX package
# ---------------------------------------------------------------------------


def test_a_streamed_slab_writes_the_jax_package_bytes(tmp_path, monkeypatch):
    """With streamed writes forced on, a slab of four 4 KiB members (twice
    the 1 KiB stream chunk and more) streams in both packages; the slab's
    bytes, the sidecar record and the manifest equal the JAX package's."""
    from torchsnapshot_tpu.storage_plugins import fs as jfs
    from torchsnapshot_tpu_torch.storage_plugins import fs as tfs

    appends = {"jax": 0, "port": 0}
    for name, mod in (("jax", jfs), ("port", tfs)):
        inner = mod._FSWriteStream.append

        async def counting(self, buf, inner=inner, name=name):
            appends[name] += 1
            await inner(self, buf)

        monkeypatch.setattr(mod._FSWriteStream, "append", counting)
    for prefix in ("TORCHSNAPSHOT_TPU_", "TSS_TORCH_"):
        for k, v in {"ENABLE_BATCHING": "1", "STREAM_WRITES": "on", "STREAM_CHUNK_BYTES": "1024", "HASH_CHUNK_BYTES": "4096", "DEDUP_DIGESTS": "1"}.items():
            monkeypatch.setenv(prefix + k, v)
    tree = {f"w{i}": np.random.default_rng(i).standard_normal(1024).astype(np.float32) for i in range(4)}
    jts.Snapshot.take(str(tmp_path / "j"), {"m": jts.StateDict(tree)})
    tts.Snapshot.take(str(tmp_path / "t"), {"m": tts.StateDict(from_numpy_tree(tree, device="cpu"))})
    assert appends["jax"] > 0 and appends["port"] > 0

    def slab(root):
        man = json.load(open(os.path.join(root, ".snapshot_metadata")))["manifest"]
        (loc,) = {e["location"] for e in man.values() if e.get("location", "").startswith("batched/")}
        side = json.load(open(os.path.join(root, ".checksums.0")))
        return open(os.path.join(root, loc), "rb").read(), side[loc]

    assert slab(str(tmp_path / "t")) == slab(str(tmp_path / "j"))
    out = tts.StateDict({k: torch.zeros(1024) for k in tree})
    tts.Snapshot(str(tmp_path / "t")).restore({"m": out}, device="cpu")
    assert all(out[k].numpy().tobytes() == v.tobytes() for k, v in tree.items())


def test_an_async_take_with_host_members_keeps_its_slab_whole(tmp_path, monkeypatch):
    """An async take's CPU members are captured before it returns, so
    their slab is never streamed (it would read them afterwards)."""
    from torchsnapshot_tpu_torch.storage_plugins import fs as tfs

    appends = [0]
    inner = tfs._FSWriteStream.append

    async def counting(self, buf):
        appends[0] += 1
        await inner(self, buf)

    monkeypatch.setattr(tfs._FSWriteStream, "append", counting)
    tree = {f"w{i}": torch.full((1024,), float(i)) for i in range(4)}
    with tknobs.override_batching_enabled(True), tknobs.override_stream_writes(True), tknobs.override_stream_chunk_bytes(1024):
        pending = tts.Snapshot.async_take(str(tmp_path / "a"), {"m": tts.StateDict(tree)})
        for t in tree.values():
            t.add_(1.0)
        pending.wait()
    assert appends[0] == 0
    out = tts.StateDict({k: torch.zeros(1024) for k in tree})
    tts.Snapshot(str(tmp_path / "a")).restore({"m": out}, device="cpu")
    assert all(torch.equal(out[k], torch.full((1024,), float(i))) for i, k in enumerate(sorted(tree)))


# ---------------------------------------------------------------------------
# Step health detectors (tests/test_health.py)
# ---------------------------------------------------------------------------


def _rec(step, stall=0.05, drain=0.1, gbps=1.0, bytes_w=10**9, skew=0.0, straggler=None, chunks=1):
    return {
        "schema_version": 1, "job": "j", "step": step, "name": f"s{step}", "stall_s": stall, "drain_wall_s": drain,
        "drain_gbps": gbps, "bytes": {"written": bytes_w, "deduped": 0}, "counters": {"stream_chunks": chunks, "preemptions": 0},
        "skew": {"end_skew_s": skew, "straggler_rank": straggler},
    }


def _series(seed):
    """Steady steps with seeded spikes, cliffs, inversions and stragglers."""
    rng = random.Random(seed)
    out = []
    for i in range(rng.randrange(3, 30)):
        r = _rec(i, stall=0.05 + rng.random() * 0.02, drain=0.1 + rng.random() * 0.02, gbps=1.0 + rng.random() * 0.1)
        roll = rng.random()
        if roll < 0.1:
            r["stall_s"] = rng.choice([0.2, 2.0, 9.0])
        elif roll < 0.2:
            r["drain_wall_s"] = rng.choice([0.3, 5.0])
            r["drain_gbps"] = rng.choice([0.05, 0.5])
            r["counters"]["stream_chunks"] = rng.choice([0, 4])
        elif roll < 0.5:
            r["skew"] = {"end_skew_s": rng.choice([0.01, 2.0, 6.0]), "straggler_rank": rng.choice([None, 1, 1, 2])}
        out.append(r)
    rng.shuffle(out)
    return out


@pytest.mark.parametrize("seed", range(24))
def test_step_health_detectors_as_in_the_jax_package(seed, caplog):
    series = _series(seed)
    events = thealth.detect_anomalies(series)
    assert events == jhealth.detect_anomalies(series)
    assert thealth.render_timeline(series) == jhealth.render_timeline(series)
    with caplog.at_level(logging.WARNING):
        thealth.log_anomalies(events)
        jhealth.log_anomalies(events)
    port = [r.getMessage() for r in caplog.records if r.name.startswith("torchsnapshot_tpu_torch")]
    jax = [r.getMessage() for r in caplog.records if not r.name.startswith("torchsnapshot_tpu_torch")]
    assert port == jax and len(port) == len({e["kind"] for e in events})


@pytest.mark.parametrize("bucket", ["growing", "plateau"])
def test_bucket_growth_as_in_the_jax_package(bucket):
    series = [_rec(i) for i in range(12)]
    sizes = [10**9 * (i + 1) for i in range(12)] if bucket == "growing" else [10**9 + (i % 2) * 10**7 for i in range(12)]
    for kw in ({"bucket_bytes": sizes}, {"bucket_bytes": sizes, "window_bound": 10**9}):
        assert thealth.detect_anomalies(series, **kw) == jhealth.detect_anomalies(series, **kw)
    fired = thealth.detect_anomalies(series, bucket_bytes=sizes, window_bound=10**9)
    assert [e["kind"] for e in fired] == (["bucket_growth"] if bucket == "growing" else [])


# ---------------------------------------------------------------------------
# The RSS sampler (tests/test_rss_profiler.py)
# ---------------------------------------------------------------------------


def test_rss_sampler_measures_an_allocation():
    code = (
        "import time, numpy as np\n"
        "from torchsnapshot_tpu_torch.utils.rss_profiler import measure_rss_deltas\n"
        "deltas = []\n"
        "with measure_rss_deltas(rss_deltas=deltas, interval_ms=10.0):\n"
        "    arr = np.ones(64 * 1024 * 1024 // 8, dtype=np.float64)\n"
        "    arr += 1.0\n"
        "    time.sleep(0.1)\n"
        "assert deltas and max(deltas) > 32 * 1024 * 1024, deltas\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


def test_rss_sampler_appends_a_closing_sample():
    deltas = []
    with measure_rss_deltas(rss_deltas=deltas, interval_ms=10_000.0):
        pass
    assert len(deltas) >= 1


def test_rss_deltas_are_relative_to_the_entry_baseline():
    ballast = np.ones(32 * 1024 * 1024 // 8, dtype=np.float64)
    ballast += 1.0
    deltas = []
    with measure_rss_deltas(rss_deltas=deltas, interval_ms=10.0):
        time.sleep(0.05)
    assert max(deltas) < 16 * 1024 * 1024
    del ballast

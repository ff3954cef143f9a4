"""The port's GCS plugin (``gs://``), held against the JAX package's.

Counterparts of ``tests/test_gcs_storage_plugin.py`` and
``tests/test_gcs_multirank.py``. The plugin-level cases run both packages'
plugins through the same fake ``google.cloud.storage`` SDK (the JAX tests'
``_install_fake_gcs``) or the local emulator (``tests/gcs_emulator.py``,
which the real ``google-cloud-storage`` SDK reaches through
``STORAGE_EMULATOR_HOST``), and must give the same bytes, retries and
errors. Then both packages write the same tree to the emulator: the same
object names and bytes, and each restores the other's snapshot bit-exactly.
``gs://`` is driven only here, on the CPU: the GPU host has neither the SDK
nor a network.
"""

import asyncio
import os
import sys
import types

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import io_types as jio
from torchsnapshot_tpu.storage_plugins import cloud_retry as jretry
from torchsnapshot_tpu.storage_plugins import gcs as jgcs
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import io_types as tio
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.storage_plugins import cloud_retry as tretry
from torchsnapshot_tpu_torch.storage_plugins import gcs as tgcs
from torchsnapshot_tpu_torch.utils import knobs as tknobs

from test_gcs_storage_plugin import _FakeResumableSession, _FakeStreamingSession, _install_fake_gcs

PKGS = ("jax", "torch")
MODS = {
    "jax": types.SimpleNamespace(gcs=jgcs, io=jio, retry=jretry, knobs=jknobs),
    "torch": types.SimpleNamespace(gcs=tgcs, io=tio, retry=tretry, knobs=tknobs),
}


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _got(pkg, rio):
    """The bytes a read delivered (a BytesIO in the JAX package, a buffer
    in the port)."""
    return rio.buf.getvalue() if pkg == "jax" else bytes(rio.buf)


@pytest.fixture
def fake_gcs(monkeypatch):
    blobs: dict = {}
    fail_reads: dict = {}
    _install_fake_gcs(monkeypatch, blobs, fail_reads)
    monkeypatch.setattr(jretry, "BASE_BACKOFF_S", 0.001)
    monkeypatch.setattr(tretry, "BASE_BACKOFF_S", 0.001)
    return blobs, fail_reads


def _copies():
    cls = type(sys.modules["google.cloud.storage"].Client().bucket("bucket"))
    cls.copies.clear()
    return cls.copies


# ---------------------------------------------------------------------------
# The plugin on the fake SDK
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_write_read_roundtrip(fake_gcs, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]
    plugin = m.gcs.GCSStoragePlugin(root="bucket/pre/fix")
    payload = bytes(range(256)) * 8

    async def go():
        await plugin.write(m.io.WriteIO(path="a/blob", buf=memoryview(payload)))
        rio = m.io.ReadIO(path="a/blob")
        await plugin.read(rio)
        await plugin.close()
        return _got(pkg, rio)

    assert _run(go()) == payload
    assert set(blobs) == {"pre/fix/a/blob"}


@pytest.mark.parametrize("pkg", PKGS)
def test_ranged_read_inclusive_end_translation(fake_gcs, pkg):
    m = MODS[pkg]
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    payload = bytes(range(256))

    async def go():
        await plugin.write(m.io.WriteIO(path="blob", buf=payload))
        out = []
        for lo, hi in [(0, 16), (100, 200), (255, 256)]:
            rio = m.io.ReadIO(path="blob", byte_range=(lo, hi))
            await plugin.read(rio)
            out.append((lo, hi, _got(pkg, rio)))
        await plugin.close()
        return out

    for lo, hi, got in _run(go()):
        assert got == payload[lo:hi], (lo, hi)


def test_ranged_read_into_the_callers_buffer(fake_gcs):
    """The port's ``into=`` reads land in the caller's buffer."""
    plugin = tgcs.GCSStoragePlugin(root="bucket")
    payload = bytes(range(256))
    into = memoryview(bytearray(50))

    async def go():
        await plugin.write(tio.WriteIO(path="blob", buf=payload))
        rio = tio.ReadIO(path="blob", byte_range=(10, 60), into=into)
        await plugin.read(rio)
        await plugin.close()
        return rio

    rio = _run(go())
    assert rio.buf is into and bytes(into) == payload[10:60]


@pytest.mark.parametrize("fails", [2, 9])
@pytest.mark.parametrize("pkg", PKGS)
def test_transient_errors_retried(fake_gcs, pkg, fails):
    """Transient failures retry while the collective-progress window is
    open: more of them than any fixed attempt cap still recover."""
    blobs, fail_reads = fake_gcs
    m = MODS[pkg]
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    blobs["blob"] = b"payload"
    fail_reads["blob"] = fails

    async def go():
        rio = m.io.ReadIO(path="blob")
        await plugin.read(rio)
        await plugin.close()
        return _got(pkg, rio)

    assert _run(go()) == b"payload" and fail_reads["blob"] == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_collective_progress_deadline_expires(fake_gcs, pkg):
    blobs, fail_reads = fake_gcs
    m = MODS[pkg]
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    plugin._progress.window_s = 0.0
    plugin._progress._last -= 1.0
    blobs["blob"] = b"payload"
    fail_reads["blob"] = 1
    with pytest.raises(ConnectionError):
        _run(plugin.read(m.io.ReadIO(path="blob")))
    _run(plugin.close())


@pytest.mark.parametrize("pkg", PKGS)
def test_nontransient_error_propagates(fake_gcs, monkeypatch, pkg):
    m = MODS[pkg]
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    blob = plugin._bucket.blob("x")
    monkeypatch.setattr(
        type(blob), "download_as_bytes",
        lambda self, start=None, end=None: (_ for _ in ()).throw(PermissionError("403 forbidden")),
    )
    with pytest.raises(PermissionError):
        _run(plugin.read(m.io.ReadIO(path="denied")))
    _run(plugin.close())


@pytest.mark.parametrize("pkg", PKGS)
def test_delete_and_absence(fake_gcs, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]
    plugin = m.gcs.GCSStoragePlugin(root="bucket")

    async def go():
        await plugin.write(m.io.WriteIO(path="doomed", buf=b"x"))
        await plugin.delete("doomed")
        with pytest.raises(FileNotFoundError):
            await plugin.read(m.io.ReadIO(path="missing"))
        with pytest.raises(FileNotFoundError):
            await plugin.delete("missing")
        await plugin.close()

    _run(go())
    assert blobs == {}


def test_telemetry_artifact_round_trip(fake_gcs):
    from torchsnapshot_tpu_torch.storage_plugin import write_telemetry_artifact
    from torchsnapshot_tpu_torch.telemetry import aggregate, artifact

    blobs, _ = fake_gcs
    plugin = tgcs.GCSStoragePlugin(root="bucket/snap")
    loop = asyncio.new_event_loop()
    try:
        art = artifact.build_artifact(op="take", rank=0, world_size=2)
        assert write_telemetry_artifact(plugin, loop, artifact.artifact_path(0), artifact.dumps_artifact(art))
        assert "snap/.telemetry/rank_0.json" in blobs
        artifacts, problems = aggregate.read_artifacts(plugin, loop, world_size=2)
    finally:
        plugin.sync_close(loop)
        loop.close()
    assert set(artifacts) == {0} and problems == {1: "missing"}
    assert artifacts[0]["op"] == "take"


@pytest.mark.parametrize("pkg", PKGS)
def test_missing_sdk_raises_clear_error(monkeypatch, pkg):
    import builtins

    real_import = builtins.__import__

    def no_gcs(name, *args, **kwargs):
        if name.startswith("google"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    for mod in [m for m in sys.modules if m.startswith("google")]:
        monkeypatch.delitem(sys.modules, mod, raising=False)
    monkeypatch.setattr(builtins, "__import__", no_gcs)
    with pytest.raises(RuntimeError, match="google-cloud-storage"):
        MODS[pkg].gcs.GCSStoragePlugin(root="bucket")


def test_url_dispatch_builds_the_port_plugin(fake_gcs):
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    plugin = url_to_storage_plugin("gs://bucket/some/prefix")
    assert isinstance(plugin, tgcs.GCSStoragePlugin) and plugin.prefix == "some/prefix"
    _run(plugin.close())


def test_incremental_take_uses_server_side_copies(fake_gcs, monkeypatch):
    """``take(base=gs://...)``: unchanged objects are copied bucket-side,
    the same ones in both packages."""
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    frozen = {f"b{i}": np.arange(500, dtype=np.float32) + i for i in range(3)}
    copied = {}
    for pkg in PKGS:
        copies = _copies()

        def app(step):
            tree = dict(frozen, head=np.full((10,), step, np.float32))
            if pkg == "jax":
                return {"m": jts.StateDict(tree)}
            return {"m": tts.StateDict(from_numpy_tree(tree, device="cpu"))}

        S = jts.Snapshot if pkg == "jax" else tts.Snapshot
        S.take(f"gs://bucket/{pkg}/s0", app(0))
        S.take(f"gs://bucket/{pkg}/s1", app(1), base=f"gs://bucket/{pkg}/s0")
        copied[pkg] = sorted(dst.split("/", 1)[1] for _, dst in copies)
        if pkg == "torch":
            out = tts.StateDict(**{k: torch.zeros(500) for k in frozen}, head=torch.zeros(10))
            tts.Snapshot(f"gs://bucket/{pkg}/s1").restore({"m": out}, device="cpu")
            assert np.array_equal(out["head"].numpy(), np.full((10,), 1, np.float32))
            assert np.array_equal(out["b2"].numpy(), frozen["b2"])
    assert copied["jax"] == copied["torch"]
    assert {f"s1/0/m/b{i}" for i in range(3)} <= set(copied["torch"]) and "s1/0/m/head" not in copied["torch"]


# ---------------------------------------------------------------------------
# Resumable uploads on a fake session
# ---------------------------------------------------------------------------


def _fake_sessions(monkeypatch, m, blobs, faults, stats, cls=_FakeResumableSession):
    def factory(client, bucket_name, blob_name, mv, chunk_bytes, transport_factory=None):
        return cls(blobs, blob_name, mv, chunk_bytes, faults, stats)

    monkeypatch.setattr(m.gcs, "_make_resumable_session", factory)


@pytest.mark.parametrize("pkg", PKGS)
def test_resumable_upload_recovers_cursor_mid_chunk(fake_gcs, monkeypatch, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]
    payload = bytes(range(256)) * 40
    chunk = 1024
    faults = {1: ConnectionError("reset mid-chunk"), 4: TimeoutError("stalled"), 7: ConnectionError("again")}
    stats = {"sent": 0, "recovers": 0}
    _fake_sessions(monkeypatch, m, blobs, faults, stats)
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    with m.knobs.override_gcs_chunk_bytes(chunk):
        _run(plugin.write(m.io.WriteIO(path="big", buf=payload)))
    _run(plugin.close())
    assert blobs["big"] == payload and stats["recovers"] == 3
    assert 0 < stats["sent"] - len(payload) <= 3 * chunk


@pytest.mark.parametrize("pkg", PKGS)
def test_resumable_backoff_clamped_to_progress_window(fake_gcs, monkeypatch, pkg):
    import time

    m = MODS[pkg]
    monkeypatch.setattr(m.retry, "BASE_BACKOFF_S", 30.0)
    monkeypatch.setattr(m.retry, "MAX_BACKOFF_S", 90.0)
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    plugin._progress.window_s = 0.2

    class Stuck:
        finished = False
        bytes_uploaded = 0

        def transmit_next_chunk(self):
            raise ConnectionError("transient mid-upload fault")

        def recover(self):  # pragma: no cover - the expiry after the sleep wins
            raise AssertionError("recover past the deadline")

    async def go():
        await plugin._drive_resumable(asyncio.get_running_loop(), Stuck(), "big")

    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        _run(go())
    assert time.monotonic() - t0 < 5.0
    _run(plugin.close())


@pytest.mark.parametrize("pkg", PKGS)
def test_small_objects_keep_one_shot_upload(fake_gcs, monkeypatch, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]

    def exploding(*a, **k):
        raise AssertionError("resumable session created for a small object")

    monkeypatch.setattr(m.gcs, "_make_resumable_session", exploding)
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    _run(plugin.write(m.io.WriteIO(path="small", buf=b"tiny")))
    _run(plugin.close())
    assert blobs["small"] == b"tiny"


@pytest.mark.parametrize("pkg", PKGS)
def test_resumable_upload_nontransient_fault_propagates(fake_gcs, monkeypatch, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]
    stats = {"sent": 0, "recovers": 0}
    _fake_sessions(monkeypatch, m, blobs, {0: PermissionError("403")}, stats)
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    with m.knobs.override_gcs_chunk_bytes(256):
        with pytest.raises(PermissionError):
            _run(plugin.write(m.io.WriteIO(path="denied", buf=bytes(512))))
    _run(plugin.close())
    assert "denied" not in blobs and stats["recovers"] == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_resumable_upload_stalled_chunk_aborts(fake_gcs, monkeypatch, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]
    stats = {"sent": 0, "recovers": 0}

    class Always(_FakeResumableSession):
        def transmit_next_chunk(self):
            self._invalid = True
            raise ConnectionError("black-holed chunk")

    _fake_sessions(monkeypatch, m, blobs, {}, stats, cls=Always)
    monkeypatch.setattr(m.gcs, "_MAX_STALLED_CHUNK_RETRIES", 3)
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    with m.knobs.override_gcs_chunk_bytes(1024):
        with pytest.raises(ConnectionError):
            _run(plugin.write(m.io.WriteIO(path="stuck", buf=bytes(4096))))
    _run(plugin.close())
    assert "stuck" not in blobs and stats["recovers"] == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_resumable_upload_lost_final_ack_treated_as_committed(fake_gcs, monkeypatch, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]
    payload = bytes(range(256)) * 8
    stats = {"sent": 0, "recovers": 0}

    class Completed200(Exception):
        def __init__(self):
            self.response = types.SimpleNamespace(status_code=200)

    class LostAck(_FakeResumableSession):
        def transmit_next_chunk(self):
            end = min(self._cursor + self._chunk, self._mv.nbytes)
            self._stats["sent"] += end - self._cursor
            if end >= self._mv.nbytes:
                self._server_persisted = self._mv.nbytes
                self._blobs[self._name] = bytes(self._mv)
                self._invalid = True
                raise ConnectionError("final ack lost")
            self._cursor = end
            self._server_persisted = end

        def recover(self):
            self._stats["recovers"] += 1
            raise Completed200()

    _fake_sessions(monkeypatch, m, blobs, {}, stats, cls=LostAck)
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    with m.knobs.override_gcs_chunk_bytes(1024):
        _run(plugin.write(m.io.WriteIO(path="acked", buf=payload)))
    _run(plugin.close())
    assert blobs["acked"] == payload and stats["recovers"] == 1


# ---------------------------------------------------------------------------
# Streamed writes
# ---------------------------------------------------------------------------


def _streaming_fake(monkeypatch, m, blobs, fail_transmits=None):
    sessions = []

    def factory(client, bucket_name, blob_name, feed, chunk_bytes, transport_factory=None):
        s = _FakeStreamingSession(blobs, blob_name, feed, max(256 * 1024, chunk_bytes), fail_transmits=fail_transmits)
        sessions.append(s)
        return s

    monkeypatch.setattr(m.gcs, "_make_streaming_session", factory)
    return sessions


@pytest.mark.parametrize("pkg", PKGS)
def test_streamed_write_lands_as_one_object(fake_gcs, monkeypatch, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]
    sessions = _streaming_fake(monkeypatch, m, blobs)
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    quantum = 256 * 1024
    pieces = [bytes([i]) * (quantum // 2 + 7) for i in range(6)]

    async def go():
        stream = await plugin.write_stream("streamed")
        for p in pieces:
            await stream.append(p)
            assert "streamed" not in blobs
        await stream.commit()
        await plugin.close()

    with m.knobs.override_gcs_chunk_bytes(quantum):
        _run(go())
    assert blobs["streamed"] == b"".join(pieces)
    assert len(sessions) == 1 and sessions[0].closed


@pytest.mark.parametrize("pkg", PKGS)
def test_streamed_write_recovers_transient_transmit_fault(fake_gcs, monkeypatch, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]
    _streaming_fake(monkeypatch, m, blobs, fail_transmits=[2])
    plugin = m.gcs.GCSStoragePlugin(root="bucket")
    payload = bytes(range(256)) * (4 * 1024)

    async def go():
        stream = await plugin.write_stream("faulty")
        await stream.append(payload)
        await stream.commit()
        await plugin.close()

    with m.knobs.override_gcs_chunk_bytes(256 * 1024):
        _run(go())
    assert blobs["faulty"] == payload


@pytest.mark.parametrize("pkg", PKGS)
def test_streamed_small_stream_degenerates_to_put(fake_gcs, monkeypatch, pkg):
    blobs, _ = fake_gcs
    m = MODS[pkg]
    sessions = _streaming_fake(monkeypatch, m, blobs)
    plugin = m.gcs.GCSStoragePlugin(root="bucket")

    async def go():
        stream = await plugin.write_stream("small")
        await stream.append(b"tiny")
        await stream.commit()
        await plugin.close()

    with m.knobs.override_gcs_chunk_bytes(256 * 1024):
        _run(go())
    assert blobs["small"] == b"tiny" and not sessions


# ---------------------------------------------------------------------------
# The real SDK against the local emulator
# ---------------------------------------------------------------------------


@pytest.fixture
def gcs_emulator(monkeypatch):
    pytest.importorskip("google.cloud.storage")
    from gcs_emulator import FakeGCSServer

    with FakeGCSServer() as srv:
        monkeypatch.setenv("STORAGE_EMULATOR_HOST", srv.endpoint)
        monkeypatch.setenv("GOOGLE_CLOUD_PROJECT", "test-project")
        monkeypatch.setattr(jretry, "BASE_BACKOFF_S", 0.001)
        monkeypatch.setattr(tretry, "BASE_BACKOFF_S", 0.001)
        yield srv


def test_emulator_small_object_multipart_roundtrip(gcs_emulator):
    plugin = tgcs.GCSStoragePlugin("bkt/pre")
    loop = asyncio.new_event_loop()
    try:
        data = b"payload-" * 1000
        loop.run_until_complete(plugin.write(tio.WriteIO(path="a/b", buf=data)))
        rio = tio.ReadIO(path="a/b")
        loop.run_until_complete(plugin.read(rio))
        assert bytes(rio.buf) == data
        rio2 = tio.ReadIO(path="a/b", byte_range=(8, 24))
        loop.run_until_complete(plugin.read(rio2))
        assert bytes(rio2.buf) == data[8:24]
        loop.run_until_complete(plugin.delete("a/b"))
        with pytest.raises(FileNotFoundError):
            loop.run_until_complete(plugin.read(tio.ReadIO(path="a/b")))
        assert any("uploadType=multipart" in line for line in gcs_emulator.state.request_log)
    finally:
        loop.run_until_complete(plugin.close())
        loop.close()


def test_emulator_resumable_upload_survives_chunk_fault(gcs_emulator):
    plugin = tgcs.GCSStoragePlugin("bkt/pre")
    loop = asyncio.new_event_loop()
    try:
        data = bytes(range(256)) * 8192
        with tknobs.override_gcs_chunk_bytes(256 * 1024):
            gcs_emulator.fail_next("PUT /upload", n=1, status=503)
            loop.run_until_complete(plugin.write(tio.WriteIO(path="big", buf=data)))
        rio = tio.ReadIO(path="big")
        loop.run_until_complete(plugin.read(rio))
        assert bytes(rio.buf) == data
        log = gcs_emulator.state.request_log
        assert any("uploadType=resumable" in line for line in log)
        assert sum(1 for line in log if "PUT /upload" in line) >= 9
    finally:
        loop.run_until_complete(plugin.close())
        loop.close()


def test_emulator_session_recover_speaks_real_wire_protocol(gcs_emulator):
    plugin = tgcs.GCSStoragePlugin("bkt/pre")
    data = bytes(range(256)) * 4096
    session = tgcs._GoogleResumableSession(
        plugin._client, "bkt", "recov", memoryview(data), 256 * 1024,
        transport_factory=lambda: tgcs._make_authorized_session(plugin._client),
    )
    session.transmit_next_chunk()
    assert session.bytes_uploaded == 256 * 1024
    session._upload._invalid = True
    session.recover()
    assert session.bytes_uploaded == 256 * 1024
    assert any(line.startswith("PROBE") for line in gcs_emulator.state.request_log)
    while not session.finished:
        session.transmit_next_chunk()
    raw = tgcs.GCSStoragePlugin("bkt")
    rio = tio.ReadIO(path="recov")
    _run(raw.read(rio))
    _run(raw.close())
    _run(plugin.close())
    assert bytes(rio.buf) == data


def test_emulator_transient_download_faults_retried(gcs_emulator):
    plugin = tgcs.GCSStoragePlugin("bkt/pre")
    loop = asyncio.new_event_loop()
    try:
        data = b"x" * 4096
        loop.run_until_complete(plugin.write(tio.WriteIO(path="obj", buf=data)))
        gcs_emulator.fail_next("GET /download", n=2, status=503)
        rio = tio.ReadIO(path="obj")
        loop.run_until_complete(plugin.read(rio))
        assert bytes(rio.buf) == data
    finally:
        loop.run_until_complete(plugin.close())
        loop.close()


def test_emulator_link_in_rewrite_token_loop(gcs_emulator):
    plugin = tgcs.GCSStoragePlugin("bkt/pre")
    loop = asyncio.new_event_loop()
    try:
        data = b"frozen-weights" * 100
        loop.run_until_complete(plugin.write(tio.WriteIO(path="base_obj", buf=data)))
        gcs_emulator.force_rewrite_token_rounds(1)
        assert loop.run_until_complete(plugin.link_in("gs://bkt/pre/base_obj", "copied_obj"))
        rio = tio.ReadIO(path="copied_obj")
        loop.run_until_complete(plugin.read(rio))
        assert bytes(rio.buf) == data
        rewrites = [line for line in gcs_emulator.state.request_log if "rewriteTo" in line]
        assert len(rewrites) >= 2 and any("rewriteToken=" in line for line in rewrites)
    finally:
        loop.run_until_complete(plugin.close())
        loop.close()


def test_emulator_snapshot_end_to_end(gcs_emulator):
    arr = torch.arange(4096, dtype=torch.float32)
    path = "gs://bkt/snapshots/s1"
    tts.Snapshot.take(path, {"s": tts.StateDict(arr=arr, step=3)})
    out = {"s": tts.StateDict(arr=torch.zeros(4096), step=0)}
    snap = tts.Snapshot(path)
    snap.restore(out, device="cpu")
    assert torch.equal(out["s"]["arr"], arr) and out["s"]["step"] == 3
    got = snap.read_object("0/s/arr", memory_budget_bytes=4096, device="cpu")
    assert torch.equal(got, arr)
    assert snap.verify() == {}


def _tree(seed):
    rng = np.random.default_rng(seed)
    tree = {f"small{i}": rng.standard_normal(33 + i).astype(np.float32) for i in range(5)}
    tree["big"] = rng.standard_normal((512, 300)).astype(np.float32)  # 600 KB: resumable
    tree["ints"] = np.arange(1000, dtype=np.int64)
    tree["half"] = rng.standard_normal(777).astype(np.float16)
    tree["step"] = seed
    return tree


def _objects(srv, prefix):
    """``{name: bytes}`` of one snapshot on the emulator; slab uuids and
    the telemetry artifacts (wall times, hosts) left out."""
    out = {}
    for (bucket, name), data in srv.state.objects.items():
        if bucket != "bkt" or not name.startswith(prefix + "/") or "/.telemetry/" in name:
            continue
        out[name[len(prefix) + 1:]] = data
    return out


@pytest.mark.parametrize("batching", [False, True], ids=["plain", "batched"])
def test_both_packages_write_the_same_objects_and_cross_restore(gcs_emulator, monkeypatch, batching):
    """The same numpy tree through both packages to ``gs://``: the same
    object names and bytes (metadata aside, whose version differs), and
    each package restores the other's snapshot bit-exactly."""
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    monkeypatch.setenv("TSS_TORCH_ENABLE_BATCHING", "1" if batching else "0")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_ENABLE_BATCHING", "1" if batching else "0")
    monkeypatch.setenv("TSS_TORCH_GCS_CHUNK_BYTES", str(256 * 1024))
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_GCS_CHUNK_BYTES", str(256 * 1024))
    tree = _tree(5)
    jts.Snapshot.take("gs://bkt/jax", {"m": jts.StateDict(tree)})
    tts.Snapshot.take("gs://bkt/torch", {"m": tts.StateDict(from_numpy_tree(tree, device="cpu"))})
    assert any("uploadType=resumable" in line for line in gcs_emulator.state.request_log)
    j, t = _objects(gcs_emulator, "jax"), _objects(gcs_emulator, "torch")
    if batching:
        slabs = lambda objs: sorted(v for k, v in objs.items() if k.startswith("batched/"))  # noqa: E731
        assert slabs(j) == slabs(t) and slabs(t)
        j = {k: v for k, v in j.items() if not k.startswith("batched/") and not k.startswith(".checksums")}
        t = {k: v for k, v in t.items() if not k.startswith("batched/") and not k.startswith(".checksums")}
    j.pop(".snapshot_metadata")
    t.pop(".snapshot_metadata")
    assert j == t
    for writer in ("jax", "torch"):
        out = tts.StateDict({k: torch.zeros(v.shape, dtype=from_numpy_tree(v, device="cpu").dtype)
                             for k, v in tree.items() if isinstance(v, np.ndarray)}, step=-1)
        tts.Snapshot(f"gs://bkt/{writer}").restore({"m": out}, device="cpu")
        jout = jts.StateDict()
        jts.Snapshot(f"gs://bkt/{writer}").restore({"m": jout})
        for k, v in tree.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(out[k].numpy().view(np.uint8), v.view(np.uint8)), (writer, k)
                assert np.array_equal(np.asarray(jout[k]).view(np.uint8), v.view(np.uint8)), (writer, k)
        assert out["step"] == jout["step"] == 5
        assert tts.Snapshot(f"gs://bkt/{writer}").verify() == {}


# ---------------------------------------------------------------------------
# Two ranks against the emulator
# ---------------------------------------------------------------------------

CHUNK_BYTES = 64 * 1024


def _worker_env(endpoint):
    os.environ["STORAGE_EMULATOR_HOST"] = endpoint
    os.environ["GOOGLE_CLOUD_PROJECT"] = "test-project"
    os.environ["TSS_TORCH_ENABLE_BATCHING"] = "1"
    os.environ["TSS_TORCH_COMPRESSION"] = "zlib"
    os.environ["TSS_TORCH_GCS_CHUNK_BYTES"] = str(CHUNK_BYTES)
    # Objects above 8 KiB stand alone, as the JAX test's slab threshold.
    os.environ["TSS_TORCH_SLAB_SIZE_THRESHOLD_BYTES"] = "8192"


def _worker_cloud_composition(rank, world_size, endpoint, prefix):
    """Sharded and replicated DTensors and per-rank small tensors: an
    ``async_take`` with slabs, zlib and resumable uploads, then restores
    into the same and the transposed layout."""
    _worker_env(endpoint)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    mesh = DeviceMesh("cpu", list(range(world_size)))
    big = np.random.default_rng(7).standard_normal((4096, 256)).astype(np.float32)
    repl = [np.random.default_rng(20 + i).standard_normal(96 * 1024 // 4).astype(np.float32) for i in range(2)]
    smalls = {f"s{i}": torch.full((256,), float(rank * 100 + i)) for i in range(12)}
    sd = StateDict(
        big=dtensor_from_numpy(big, mesh, [Shard(0)]),
        r0=dtensor_from_numpy(repl[0], mesh, [Replicate()]),
        r1=dtensor_from_numpy(repl[1], mesh, [Replicate()]),
        **smalls,
    )
    path = f"gs://bkt/{prefix}"
    snap = Snapshot.async_take(path, {"s": sd}).wait()
    tgt = StateDict(
        big=dtensor_from_numpy(np.zeros_like(big), mesh, [Shard(0)]),
        r0=dtensor_from_numpy(np.zeros_like(repl[0]), mesh, [Replicate()]),
        r1=dtensor_from_numpy(np.zeros_like(repl[1]), mesh, [Replicate()]),
        **{k: torch.zeros(256) for k in smalls},
    )
    snap.restore({"s": tgt}, device="cpu")
    rows = 4096 // world_size
    assert np.array_equal(tgt["big"].to_local().numpy(), big[rank * rows:(rank + 1) * rows])
    assert np.array_equal(tgt["r0"].to_local().numpy(), repl[0])
    assert np.array_equal(tgt["r1"].to_local().numpy(), repl[1])
    for k, v in smalls.items():
        assert torch.equal(tgt[k], v)
    tgt2 = StateDict(big=dtensor_from_numpy(np.zeros_like(big), mesh, [Shard(1)]))
    snap.restore({"s": tgt2}, device="cpu")
    cols = 256 // world_size
    assert tgt2["big"].placements == (Shard(1),)
    assert np.array_equal(tgt2["big"].to_local().numpy(), big[:, rank * cols:(rank + 1) * cols])


def _worker_cloud_fault(rank, world_size, endpoint, prefix):
    _worker_env(endpoint)
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    sd = StateDict(
        big=torch.from_numpy(np.random.default_rng(rank).standard_normal(CHUNK_BYTES // 4 * 2).astype(np.float32)),
        **{f"v{i}": torch.full((512,), rank * 10 + i, dtype=torch.int32) for i in range(4)},
    )
    pending = Snapshot.async_take(f"gs://bkt/{prefix}", {"s": sd})
    with pytest.raises(Exception):
        pending.wait()


@pytest.mark.multiprocess
def test_multirank_cloud_composition_async_take_commit_restore():
    pytest.importorskip("google.cloud.storage")
    from gcs_emulator import FakeGCSServer

    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    prefix = "ck_ok"
    with FakeGCSServer() as srv:
        run_with_processes(_worker_cloud_composition, 2, args=(srv.endpoint, prefix), timeout_s=240,
                           process_group=True)
        names = [n for (b, n) in srv.state.objects if b == "bkt"]
        log = srv.state.request_log
        assert f"{prefix}/.snapshot_metadata" in names
        assert f"{prefix}/.checksums.0" in names and f"{prefix}/.checksums.1" in names
        assert any("/batched/" in n for n in names) and any(n.endswith(".ftab") for n in names)
        assert any("uploadType=resumable" in line for line in log)
        assert any("uploadType=multipart" in line for line in log)
        repl = [n for n in names if n.startswith(f"{prefix}/replicated/")]
        assert len([n for n in repl if "/r0" in n]) == 1 and len([n for n in repl if "/r1" in n]) == 1


@pytest.mark.multiprocess
def test_multirank_cloud_fault_never_commits():
    pytest.importorskip("google.cloud.storage")
    from gcs_emulator import FakeGCSServer

    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    prefix = "ck_fault"
    with FakeGCSServer() as srv:
        srv.fail_next("uploadType=resumable", n=2, status=403)
        run_with_processes(_worker_cloud_fault, 2, args=(srv.endpoint, prefix), timeout_s=240)
        names = [n for (b, n) in srv.state.objects if b == "bkt"]
        assert not any(n.endswith(".snapshot_metadata") for n in names), names
        assert not srv.state.faults, srv.state.faults

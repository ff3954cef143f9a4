"""The port's S3 plugin (``s3://``), held against the JAX package's.

Counterparts of ``tests/test_s3_storage_plugin.py`` on its fake
``aioboto3`` SDKs: both packages' plugins run every case and must give the
same bytes, parts, retries and errors. The moto-backed wire tests skip
where ``aioboto3`` and ``moto`` are absent, as the JAX package's do.
``s3://`` is driven only on the CPU: the GPU host has neither the SDK nor
a network.
"""

import asyncio
import sys
import types

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import io_types as jio
from torchsnapshot_tpu.storage_plugins import cloud_retry as jretry
from torchsnapshot_tpu.storage_plugins import s3 as js3
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import io_types as tio
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.storage_plugins import cloud_retry as tretry
from torchsnapshot_tpu_torch.storage_plugins import s3 as ts3
from torchsnapshot_tpu_torch.utils import knobs as tknobs

from test_s3_storage_plugin import _install_fake_aioboto3, _install_fake_multipart_s3

PKGS = ("jax", "torch")
MODS = {
    "jax": types.SimpleNamespace(s3=js3, io=jio, retry=jretry, knobs=jknobs),
    "torch": types.SimpleNamespace(s3=ts3, io=tio, retry=tretry, knobs=tknobs),
}


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _got(pkg, rio):
    return rio.buf.getvalue() if pkg == "jax" else bytes(rio.buf)


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    monkeypatch.setattr(jretry, "BASE_BACKOFF_S", 0.001)
    monkeypatch.setattr(tretry, "BASE_BACKOFF_S", 0.001)


@pytest.fixture
def fake_s3(monkeypatch):
    objects: dict = {}
    _install_fake_aioboto3(monkeypatch, objects)
    return objects


@pytest.fixture
def fake_multipart_s3(monkeypatch):
    objects, stats, faults = {}, {}, {}
    _install_fake_multipart_s3(monkeypatch, objects, stats, faults)
    return objects, stats, faults


@pytest.mark.parametrize("pkg", PKGS)
def test_write_read_roundtrip(fake_s3, pkg):
    m = MODS[pkg]
    plugin = m.s3.S3StoragePlugin(root="bucket/check/points")
    payload = bytes(range(256)) * 4

    async def go():
        await plugin.write(m.io.WriteIO(path="a/b", buf=memoryview(payload)))
        rio = m.io.ReadIO(path="a/b")
        await plugin.read(rio)
        await plugin.close()
        return _got(pkg, rio)

    assert _run(go()) == payload
    assert set(fake_s3) == {("bucket", "check/points/a/b")}


@pytest.mark.parametrize("pkg", PKGS)
def test_ranged_read_http_range_translation(fake_s3, pkg):
    m = MODS[pkg]
    plugin = m.s3.S3StoragePlugin(root="bucket")
    payload = bytes(range(256))

    async def go():
        await plugin.write(m.io.WriteIO(path="blob", buf=payload))
        out = []
        for lo, hi in [(0, 1), (10, 20), (128, 256)]:
            rio = m.io.ReadIO(path="blob", byte_range=(lo, hi))
            await plugin.read(rio)
            out.append((lo, hi, _got(pkg, rio)))
        await plugin.close()
        return out

    for lo, hi, got in _run(go()):
        assert got == payload[lo:hi], (lo, hi)


def test_ranged_read_into_the_callers_buffer(fake_s3):
    plugin = ts3.S3StoragePlugin(root="bucket")
    into = memoryview(bytearray(10))

    async def go():
        await plugin.write(tio.WriteIO(path="blob", buf=bytes(range(256))))
        rio = tio.ReadIO(path="blob", byte_range=(10, 20), into=into)
        await plugin.read(rio)
        await plugin.close()
        return rio

    rio = _run(go())
    assert rio.buf is into and bytes(into) == bytes(range(10, 20))


@pytest.mark.parametrize("pkg", PKGS)
def test_delete_and_absence(fake_s3, pkg):
    """Deletes are idempotent; a read of an absent key raises
    FileNotFoundError (normalised from the structured NoSuchKey)."""
    m = MODS[pkg]
    plugin = m.s3.S3StoragePlugin(root="bucket")

    async def go():
        await plugin.write(m.io.WriteIO(path="doomed", buf=b"x"))
        await plugin.delete("doomed")
        with pytest.raises(FileNotFoundError):
            await plugin.read(m.io.ReadIO(path="missing"))
        await plugin.delete("missing")
        await plugin.close()

    _run(go())
    assert fake_s3 == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_missing_sdk_raises_clear_error(monkeypatch, pkg):
    import builtins

    real_import = builtins.__import__

    def no_boto(name, *args, **kwargs):
        if name == "aioboto3":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "aioboto3", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_boto)
    with pytest.raises(RuntimeError, match="aioboto3"):
        MODS[pkg].s3.S3StoragePlugin(root="bucket")


def test_url_dispatch_builds_the_port_plugin(fake_s3):
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    plugin = url_to_storage_plugin("s3://bucket/run/1")
    assert isinstance(plugin, ts3.S3StoragePlugin) and (plugin.bucket, plugin.prefix) == ("bucket", "run/1")
    _run(plugin.close())


# ---------------------------------------------------------------------------
# Multipart uploads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_multipart_upload_with_per_part_faults(fake_multipart_s3, pkg):
    objects, stats, faults = fake_multipart_s3
    m = MODS[pkg]
    payload = bytes(range(256)) * 40
    faults[2] = [ConnectionError("reset")]
    faults[7] = [TimeoutError("stall"), ConnectionError("reset again")]
    plugin = m.s3.S3StoragePlugin(root="bucket/pre")
    with m.knobs.override_s3_chunk_bytes(1024):
        _run(plugin.write(m.io.WriteIO(path="big", buf=memoryview(payload))))
    _run(plugin.close())
    assert objects[("bucket", "pre/big")] == payload
    assert stats["completed"] == 1 and stats.get("aborted", 0) == 0
    assert stats["part_bytes_sent"] == len(payload) + 3 * 1024


@pytest.mark.parametrize("pkg", PKGS)
def test_multipart_upload_aborts_on_permanent_failure(fake_multipart_s3, pkg):
    objects, stats, faults = fake_multipart_s3
    m = MODS[pkg]
    denied = Exception("AccessDenied")
    denied.response = {"Error": {"Code": "AccessDenied"}}
    faults[3] = [denied]
    plugin = m.s3.S3StoragePlugin(root="bucket")
    with m.knobs.override_s3_chunk_bytes(1024):
        with pytest.raises(Exception, match="AccessDenied"):
            _run(plugin.write(m.io.WriteIO(path="nope", buf=bytes(4096))))
    _run(plugin.close())
    assert ("bucket", "nope") not in objects and stats.get("aborted", 0) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_multipart_complete_committed_server_side_is_success(fake_multipart_s3, pkg):
    objects, stats, faults = fake_multipart_s3
    m = MODS[pkg]
    faults["complete_commits_then_fails"] = True
    payload = bytes(range(256)) * 16
    plugin = m.s3.S3StoragePlugin(root="bucket")
    with m.knobs.override_s3_chunk_bytes(1024):
        _run(plugin.write(m.io.WriteIO(path="committed", buf=memoryview(payload))))
    _run(plugin.close())
    assert objects[("bucket", "committed")] == payload
    assert stats.get("heads", 0) >= 1 and stats.get("aborted", 0) == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_probe_failure_surfaces_original_complete_error(fake_multipart_s3, pkg):
    objects, stats, faults = fake_multipart_s3
    m = MODS[pkg]
    faults["complete_vanishes"] = True
    plugin = m.s3.S3StoragePlugin(root="bucket")
    with m.knobs.override_s3_chunk_bytes(1024):
        with pytest.raises(Exception, match="NoSuchUpload") as excinfo:
            _run(plugin.write(m.io.WriteIO(path="gone", buf=bytes(4096))))
    _run(plugin.close())
    assert "NotFound" in repr(excinfo.value.__cause__)
    assert ("bucket", "gone") not in objects


@pytest.mark.parametrize("pkg", PKGS)
def test_small_objects_keep_single_put(fake_multipart_s3, pkg):
    objects, stats, _ = fake_multipart_s3
    m = MODS[pkg]
    plugin = m.s3.S3StoragePlugin(root="bucket")
    with m.knobs.override_s3_chunk_bytes(1024):
        _run(plugin.write(m.io.WriteIO(path="small", buf=b"tiny")))
    _run(plugin.close())
    assert objects[("bucket", "small")] == b"tiny" and stats.get("puts") == 1 and "created" not in stats


# ---------------------------------------------------------------------------
# Transient errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_transient_s3_codes_retried(fake_s3, pkg):
    m = MODS[pkg]
    plugin = m.s3.S3StoragePlugin(root="bucket")

    async def go():
        client = await plugin._get_client()
        real_put = client.put_object
        remaining = {"n": 2}

        async def flaky_put(**kw):
            if remaining["n"]:
                remaining["n"] -= 1
                e = Exception("SlowDown")
                e.response = {"Error": {"Code": "SlowDown"}}
                raise e
            return await real_put(**kw)

        client.put_object = flaky_put
        await plugin.write(m.io.WriteIO(path="k", buf=b"v"))
        await plugin.close()

    _run(go())
    assert fake_s3[("bucket", "k")] == b"v"


@pytest.mark.parametrize("pkg", PKGS)
def test_botocore_network_errors_classified_transient(monkeypatch, pkg):
    gexc = types.ModuleType("botocore.exceptions")

    class FakeBotoConnErr(Exception):
        pass

    class FakeHTTPClientError(Exception):
        pass

    gexc.ConnectionError = FakeBotoConnErr
    gexc.HTTPClientError = FakeHTTPClientError
    boto_mod = types.ModuleType("botocore")
    boto_mod.exceptions = gexc
    monkeypatch.setitem(sys.modules, "botocore", boto_mod)
    monkeypatch.setitem(sys.modules, "botocore.exceptions", gexc)
    is_transient = MODS[pkg].s3._is_transient
    assert is_transient(FakeBotoConnErr("endpoint reset")) and is_transient(FakeHTTPClientError("read timeout"))
    assert not is_transient(ValueError("permanent"))
    denied = Exception("AccessDenied")
    denied.response = {"Error": {"Code": "AccessDenied"}}
    assert not is_transient(denied)
    for code in sorted(js3._TRANSIENT_S3_CODES):
        e = Exception(code)
        e.response = {"Error": {"Code": code}}
        assert is_transient(e), code
    assert ts3._TRANSIENT_S3_CODES == js3._TRANSIENT_S3_CODES


@pytest.mark.parametrize("pkg", PKGS)
def test_mid_stream_read_fault_retried(fake_s3, pkg):
    m = MODS[pkg]
    plugin = m.s3.S3StoragePlugin(root="bucket")

    async def go():
        await plugin.write(m.io.WriteIO(path="k", buf=b"payload"))
        client = await plugin._get_client()
        real_get = client.get_object
        remaining = {"n": 2}

        async def flaky(**kw):
            resp = await real_get(**kw)
            if remaining["n"]:
                remaining["n"] -= 1

                class Dying:
                    async def __aenter__(self):
                        return self

                    async def __aexit__(self, *exc):
                        return False

                    async def read(self):
                        raise ConnectionError("reset mid-stream")

                return {"Body": Dying()}
            return resp

        client.get_object = flaky
        rio = m.io.ReadIO(path="k")
        await plugin.read(rio)
        await plugin.close()
        return _got(pkg, rio)

    assert _run(go()) == b"payload"


# ---------------------------------------------------------------------------
# Streamed writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_streamed_write_lands_as_one_multipart_object(fake_multipart_s3, pkg):
    objects, stats, _ = fake_multipart_s3
    m = MODS[pkg]
    plugin = m.s3.S3StoragePlugin(root="bucket")
    pieces = [bytes([i]) * 700 for i in range(7)]

    async def go():
        stream = await plugin.write_stream("streamed")
        for p in pieces:
            await stream.append(p)
        assert ("bucket", "streamed") not in objects
        await stream.commit()

    with m.knobs.override_s3_chunk_bytes(1024):
        _run(go())
    _run(plugin.close())
    assert objects[("bucket", "streamed")] == b"".join(pieces)
    assert stats["completed"] == 1 and stats.get("aborted", 0) == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_streamed_write_abort_leaves_no_object_no_parts(fake_multipart_s3, pkg):
    objects, stats, _ = fake_multipart_s3
    m = MODS[pkg]
    plugin = m.s3.S3StoragePlugin(root="bucket")

    async def go():
        stream = await plugin.write_stream("doomed")
        await stream.append(bytes(3000))
        await stream.abort()

    with m.knobs.override_s3_chunk_bytes(1024):
        _run(go())
    _run(plugin.close())
    assert ("bucket", "doomed") not in objects and stats.get("aborted", 0) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_streamed_small_stream_degenerates_to_put(fake_multipart_s3, pkg):
    objects, stats, _ = fake_multipart_s3
    m = MODS[pkg]
    plugin = m.s3.S3StoragePlugin(root="bucket")

    async def go():
        stream = await plugin.write_stream("small")
        await stream.append(b"tiny")
        await stream.commit()

    with m.knobs.override_s3_chunk_bytes(1024):
        _run(go())
    _run(plugin.close())
    assert objects[("bucket", "small")] == b"tiny" and stats.get("puts") == 1 and "created" not in stats


def test_both_packages_write_the_same_objects_to_fake_s3(fake_multipart_s3, monkeypatch):
    """The same tree through both packages to ``s3://``, with multipart
    uploads: the same keys and bytes (metadata aside), and each package
    restores the other's snapshot bit-exactly."""
    objects, _, _ = fake_multipart_s3
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    monkeypatch.setenv("TSS_TORCH_S3_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_S3_CHUNK_BYTES", "4096")
    rng = np.random.default_rng(9)
    tree = {"w": rng.standard_normal((64, 40)).astype(np.float32), "b": np.arange(300, dtype=np.int64), "step": 9}
    jts.Snapshot.take("s3://bkt/jax", {"m": jts.StateDict(tree)})
    tts.Snapshot.take("s3://bkt/torch", {"m": tts.StateDict(from_numpy_tree(tree, device="cpu"))})

    def keys(prefix):
        return {k[len(prefix) + 1:]: v for (b, k), v in objects.items()
                if k.startswith(prefix + "/") and "/.telemetry/" not in k and not k.endswith(".snapshot_metadata")}

    assert keys("jax") == keys("torch") and "0/m/w" in keys("torch")
    for writer in ("jax", "torch"):
        out = tts.StateDict(w=torch.zeros(64, 40), b=torch.zeros(300, dtype=torch.int64), step=-1)
        tts.Snapshot(f"s3://bkt/{writer}").restore({"m": out}, device="cpu")
        assert np.array_equal(out["w"].numpy(), tree["w"]) and np.array_equal(out["b"].numpy(), tree["b"])
        jout = jts.StateDict()
        jts.Snapshot(f"s3://bkt/{writer}").restore({"m": jout})
        assert np.array_equal(np.asarray(jout["w"]), tree["w"]) and out["step"] == jout["step"] == 9


# ---------------------------------------------------------------------------
# The real SDK against moto (skips where either is absent)
# ---------------------------------------------------------------------------


@pytest.fixture
def s3_emulator(monkeypatch):
    pytest.importorskip("aioboto3")
    moto_server = pytest.importorskip("moto.server")
    server = moto_server.ThreadedMotoServer(port=0)
    server.start()
    host, port = server.get_host_and_port()
    endpoint = f"http://{host}:{port}"
    monkeypatch.setenv("AWS_ENDPOINT_URL_S3", endpoint)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "testing")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "testing")
    monkeypatch.setenv("AWS_DEFAULT_REGION", "us-east-1")
    import boto3

    boto3.client("s3", endpoint_url=endpoint).create_bucket(Bucket="bkt")
    try:
        yield endpoint
    finally:
        server.stop()


def test_moto_snapshot_end_to_end(s3_emulator):
    arr = torch.arange(4096, dtype=torch.float32)
    path = "s3://bkt/snapshots/s1"
    tts.Snapshot.take(path, {"s": tts.StateDict(arr=arr, step=3)})
    out = {"s": tts.StateDict(arr=torch.zeros(4096), step=0)}
    tts.Snapshot(path).restore(out, device="cpu")
    assert torch.equal(out["s"]["arr"], arr) and out["s"]["step"] == 3
    assert tts.Snapshot(path).verify() == {}

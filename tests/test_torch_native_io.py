"""The port's native O_DIRECT engine (``torchsnapshot_tpu_torch/native``)
against the JAX package's (``torchsnapshot_tpu/native``): the same bytes
on disk, the same crc32, the direct/buffered/disabled routes and their
counts, streamed positioned appends with unaligned tails, and snapshots
crossing between the packages with the engine on."""

import asyncio
import logging
import os
import zlib

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import native as jax_native
from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JaxFSPlugin
from torchsnapshot_tpu.utils import knobs as jax_knobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import native
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.utils import knobs

SIZES = [0, 1, 4095, 4096, 4097, (1 << 20) + 13, 3 * 4096]


@pytest.fixture(scope="module")
def libs():
    port_lib = native.load_native()
    jax_lib = jax_native.load_native()
    if port_lib is None or jax_lib is None:
        pytest.skip("no g++ on this host: the native engines are not built")
    return port_lib, jax_lib


def _data(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def test_abi_and_build_location(libs):
    port_lib, _ = libs
    assert port_lib.tss_io_version() == 3
    path = native._lib_path()
    assert os.path.dirname(path).endswith(os.path.join("torchsnapshot_tpu_torch", "_build"))
    assert os.path.exists(path)
    # The port builds its own copy of the source, never the JAX package's.
    assert not os.path.samefile(native._SRC, jax_native._SRC)


@pytest.mark.parametrize("nbytes", SIZES)
def test_files_identical_to_jax_engine(libs, tmp_path, nbytes):
    port_lib, jax_lib = libs
    data = _data(nbytes, nbytes)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    rec = native.write_file_digest(port_lib, a, data, direct=True, chunk_bytes=1 << 20)
    jrec = jax_native.write_file_digest(jax_lib, b, data, direct=True, chunk_bytes=1 << 20)
    assert rec == jrec == [zlib.crc32(data), nbytes, None]
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read() == data
    out = bytearray(nbytes)
    native.read_into(port_lib, b, out, direct=True, chunk_bytes=1 << 16)
    assert bytes(out) == data
    assert native.file_size(port_lib, a) == nbytes


@pytest.mark.parametrize("offset,length", [(0, 100), (1, 4096), (4095, 2), (8192, 8192), (5000, 70001)])
def test_ranged_reads_match_jax(libs, tmp_path, offset, length):
    port_lib, jax_lib = libs
    data = _data(100_000, 7)
    path = str(tmp_path / "ranged")
    jax_native.write_file(jax_lib, path, data, direct=True, chunk_bytes=1 << 20)
    out, jout = bytearray(length), bytearray(length)
    native.read_into(port_lib, path, out, offset=offset, direct=True, chunk_bytes=16384)
    jax_native.read_into(jax_lib, path, jout, offset=offset, direct=True, chunk_bytes=16384)
    assert bytes(out) == bytes(jout) == data[offset : offset + length]


def test_read_past_eof_raises(libs, tmp_path):
    port_lib, _ = libs
    path = str(tmp_path / "short")
    native.write_file(port_lib, path, b"x" * 10, direct=False, chunk_bytes=4096)
    with pytest.raises(OSError):
        native.read_into(port_lib, path, bytearray(20), direct=False)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _stream(plugin, path, chunks):
    async def go():
        stream = await plugin.write_stream(path)
        for c in chunks:
            await stream.append(c)
        await stream.commit()
        await plugin.close()

    _run(go())


@pytest.mark.parametrize("sizes", [[4096, 4096], [10, 5000, 3, 8191, 4097], [1, 2, 3], [70001, 12289]])
def test_streamed_appends_with_unaligned_tails(libs, tmp_path, sizes):
    """Positioned O_DIRECT appends of the aligned spans, the tail carried
    and written at commit: the same file as the JAX package's stream."""
    data = _data(sum(sizes), len(sizes))
    chunks, pos = [], 0
    for n in sizes:
        chunks.append(memoryview(data)[pos : pos + n])
        pos += n
    native.reset_io_counts()
    _stream(FSStoragePlugin(str(tmp_path / "port")), "a/obj", chunks)
    counts = native.io_counts()
    _stream(JaxFSPlugin(str(tmp_path / "jax")), "a/obj", chunks)
    port_bytes = (tmp_path / "port" / "a" / "obj").read_bytes()
    assert port_bytes == (tmp_path / "jax" / "a" / "obj").read_bytes() == data
    assert counts["direct_write_bytes"] + counts["buffered_write_bytes"] == len(data)
    assert counts["direct_write_bytes"] % 4096 == 0
    assert counts["buffered_write_bytes"] == len(data) % 4096 or counts["direct_write_bytes"] == 0
    assert not [n for n in os.listdir(tmp_path / "port" / "a") if ".tmp." in n]


def test_stream_tail_is_not_a_view_of_the_callers_buffer(libs, tmp_path):
    """The carried tail is copied: the caller may reuse its buffer (the
    staging pool does) right after the append returns."""
    plugin = FSStoragePlugin(str(tmp_path))
    buf = bytearray(b"a" * 5000)

    async def go():
        stream = await plugin.write_stream("obj")
        await stream.append(buf)
        buf[:] = b"b" * 5000  # reused before the commit writes the tail
        await stream.commit()
        await plugin.close()

    _run(go())
    assert (tmp_path / "obj").read_bytes() == b"a" * 5000


@pytest.mark.parametrize("root", ["tmp", "shm"])
def test_routes_and_counts(libs, tmp_path, root):
    """Large objects go through the engine (direct where the file system
    takes O_DIRECT, else buffered inside the engine), small ones through
    Python; every byte is counted on one side."""
    if root == "shm":
        if not os.path.isdir("/dev/shm"):
            pytest.skip("no /dev/shm")
        import tempfile

        base = tempfile.mkdtemp(dir="/dev/shm")
    else:
        base = str(tmp_path)
    direct_ok = _takes_o_direct(base)
    big, small = _data(5 * 1024 * 1024 + 3, 1), _data(1000, 2)
    plugin = FSStoragePlugin(base)
    native.reset_io_counts()

    async def go():
        await plugin.write(WriteIO(path="big", buf=big))
        await plugin.write(WriteIO(path="small", buf=small))
        r1, r2 = ReadIO(path="big"), ReadIO(path="small", byte_range=(10, 900))
        await plugin.read(r1)
        await plugin.read(r2)
        await plugin.close()
        return bytes(r1.buf), bytes(r2.buf)

    try:
        got_big, got_small = _run(go())
        counts = native.io_counts()
    finally:
        if root == "shm":
            import shutil

            shutil.rmtree(base)
    assert got_big == big and got_small == small[10:900]
    assert counts["direct_write_bytes"] + counts["buffered_write_bytes"] == len(big)
    assert counts["python_writes"] == 1 and counts["python_write_bytes"] == len(small)
    assert counts["direct_read_bytes"] + counts["buffered_read_bytes"] == len(big)
    assert counts["python_reads"] == 1 and counts["python_read_bytes"] == 890
    if direct_ok:
        # The engine goes direct wherever the file system lets it.
        assert counts["direct_write_bytes"] >= len(big) - 4096
    else:
        assert counts["direct_write_bytes"] == 0


def _takes_o_direct(directory) -> bool:
    """Whether an aligned O_DIRECT write succeeds in ``directory``."""
    import mmap

    path = os.path.join(str(directory), "odirect_probe")
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_DIRECT, 0o644)
    except OSError:
        return False
    try:
        return os.write(fd, mmap.mmap(-1, 4096)) == 4096
    except OSError:
        return False
    finally:
        os.close(fd)
        os.remove(path)


def test_disabled_engine_writes_the_same_bytes(tmp_path, monkeypatch):
    data = _data(6 * 1024 * 1024, 3)
    native.reset_io_counts()
    monkeypatch.setenv("TSS_TORCH_DISABLE_NATIVE_IO", "1")
    assert native.load_native() is None and native.load_native_nonblocking() is None
    plugin = FSStoragePlugin(str(tmp_path))
    write_io = WriteIO(path="x", buf=data, want_digest=True)
    _run(plugin.write(write_io))
    counts = native.io_counts()
    assert write_io.digest_out is None  # Python hashes it
    assert (tmp_path / "x").read_bytes() == data
    assert counts["python_write_bytes"] == len(data)
    assert counts["direct_writes"] == counts["buffered_writes"] == 0


def test_engine_digest_rides_the_write(libs, tmp_path):
    data = _data(5 * 1024 * 1024, 4)
    plugin = FSStoragePlugin(str(tmp_path))
    write_io = WriteIO(path="x", buf=data, want_digest=True)
    _run(plugin.write(write_io))
    assert write_io.digest_out == [zlib.crc32(data), len(data), None]


def test_failed_build_warns(tmp_path, monkeypatch, caplog):
    """A build that fails on a host with g++ is logged as a warning, and
    the engine is absent (buffered Python I/O), not silently skipped."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.load_native() is None
    assert any("native I/O engine unavailable" in r.getMessage() for r in caplog.records)


def _tree():
    rng = np.random.default_rng(11)
    return {
        "w": rng.standard_normal((640, 1024)).astype(np.float32),  # 2.5 MiB
        "b": rng.standard_normal(300).astype(np.float32),
        "e": rng.integers(0, 100, (2048, 1031)).astype(np.int16),
        "step": 7,
    }


@pytest.mark.parametrize("verify", ["auto", "all"])
def test_jax_snapshot_restores_through_the_port(libs, tmp_path, monkeypatch, verify):
    monkeypatch.setenv("TSS_TORCH_DIRECT_IO_THRESHOLD_BYTES", "65536")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_DIRECT_IO_THRESHOLD_BYTES", "65536")
    monkeypatch.setenv("TSS_TORCH_VERIFY_READS", verify)
    tree = _tree()
    path = str(tmp_path / "jax")
    jts.Snapshot.take(path, {"m": jts.StateDict(**tree)})
    target = {k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in tree.items() if k != "step"}
    target["step"] = 0
    native.reset_io_counts()
    sd = tts.StateDict(**target)
    tts.Snapshot(path).restore({"m": sd}, device="cpu")
    for k, v in tree.items():
        if k == "step":
            assert sd[k] == v
        else:
            assert np.array_equal(sd[k].numpy(), v)
    assert native.io_counts()["direct_reads"] > 0


@pytest.mark.parametrize("verify", ["auto", "all"])
def test_port_snapshot_restores_through_jax(libs, tmp_path, monkeypatch, verify):
    monkeypatch.setenv("TSS_TORCH_DIRECT_IO_THRESHOLD_BYTES", "65536")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_VERIFY_READS", verify)
    tree = _tree()
    path = str(tmp_path / "port")
    native.reset_io_counts()
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    assert native.io_counts()["direct_writes"] > 0
    target = {k: np.zeros_like(v) for k, v in tree.items() if k != "step"}
    target["step"] = 0
    sd = jts.StateDict(**target)
    jts.Snapshot(path).restore({"m": sd})
    for k, v in tree.items():
        assert np.array_equal(np.asarray(sd[k]), v)
    assert jts.Snapshot(path).verify() == {}


def test_sidecars_identical_with_engine_on(libs, tmp_path, monkeypatch):
    """The engine's crc (folded into the write) gives the same sidecar as
    the JAX package's engine."""
    monkeypatch.setenv("TSS_TORCH_DIRECT_IO_THRESHOLD_BYTES", "65536")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_DIRECT_IO_THRESHOLD_BYTES", "65536")
    tree = _tree()
    tts.Snapshot.take(str(tmp_path / "p"), {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    jts.Snapshot.take(str(tmp_path / "j"), {"m": jts.StateDict(**tree)})
    assert (tmp_path / "p" / ".checksums.0").read_bytes() == (tmp_path / "j" / ".checksums.0").read_bytes()
    for name in ("w", "e"):
        assert (tmp_path / "p" / "0" / "m" / name).read_bytes() == (tmp_path / "j" / "0" / "m" / name).read_bytes()


def test_knobs_match_the_jax_package(monkeypatch):
    assert knobs.get_direct_io_threshold_bytes() == jax_knobs.get_direct_io_threshold_bytes()
    assert knobs.get_direct_io_chunk_bytes() == jax_knobs.get_direct_io_chunk_bytes()
    assert knobs.get_direct_io_concurrency() == 2
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert knobs.get_direct_io_concurrency() == 1
    monkeypatch.setenv("TSS_TORCH_DIRECT_IO_CONCURRENCY", "3")
    assert knobs.get_direct_io_concurrency() == 3
    assert FSStoragePlugin.scales_io_with_local_world is True


# ---------------------------------------------------------------------------
# The per-rank budget and the I/O cap of ranks sharing a host
# ---------------------------------------------------------------------------

_AVAILABLE = 10 * 1024**3 + 12345


class _VM:
    available = _AVAILABLE


@pytest.mark.parametrize("local_world", [1, 2, 4])
def test_budget_and_io_cap_match_the_jax_package(monkeypatch, local_world):
    from torchsnapshot_tpu import scheduler as jsched
    from torchsnapshot_tpu.storage_plugins.memory import MemoryStoragePlugin as JaxMemory

    from torchsnapshot_tpu_torch import scheduler
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    monkeypatch.setattr(jsched.psutil, "virtual_memory", lambda: _VM())
    monkeypatch.setattr(scheduler, "_mem_available_bytes", lambda: _AVAILABLE)
    monkeypatch.setattr(jax_knobs, "_local_world_size", local_world)
    monkeypatch.setattr(knobs, "_local_world_size", local_world)
    for prefix in ("TSS_TORCH_", "TORCHSNAPSHOT_TPU_"):
        monkeypatch.delenv(prefix + "PER_RANK_MEMORY_BUDGET_BYTES", raising=False)
        monkeypatch.delenv(prefix + "MAX_CONCURRENT_IO", raising=False)
    budget = scheduler.get_process_memory_budget_bytes(None)
    assert budget == jsched.get_process_memory_budget_bytes(None) == int(_AVAILABLE * 0.6 / local_world)
    fs = FSStoragePlugin(root="/nonexistent-root")
    assert knobs.get_max_concurrent_io_for(fs) == jax_knobs.get_max_concurrent_io_for(JaxFSPlugin(root="/x"))
    assert knobs.get_max_concurrent_io_for(fs) == 16 // local_world
    assert knobs.get_max_concurrent_io_for(MemoryStoragePlugin(root="io_cap")) == 16
    assert jax_knobs.get_max_concurrent_io_for(JaxMemory(root="io_cap")) == 16
    # The override replaces the derived budget verbatim, in both packages.
    monkeypatch.setenv("TSS_TORCH_PER_RANK_MEMORY_BUDGET_BYTES", "777")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_PER_RANK_MEMORY_BUDGET_BYTES", "777")
    assert scheduler.get_process_memory_budget_bytes(None) == jsched.get_process_memory_budget_bytes(None) == 777


def test_budget_reads_mem_available_not_free_pages():
    """``MemAvailable`` counts the reclaimable page cache, which free pages
    (``SC_AVPHYS_PAGES``) leave out."""
    from torchsnapshot_tpu_torch import scheduler

    with open("/proc/meminfo") as f:
        fields = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    got = scheduler._mem_available_bytes()
    # Both read the same moment's meminfo within a few MB of churn.
    assert abs(got - fields["MemAvailable"]) < 256 * 1024**2


def _cohosted_worker(rank, world_size, root):
    """Two ranks on one host: the take's write pipeline plans against half
    of 0.6 x MemAvailable and runs 8 storage operations, learned from the
    hostname gather (LOCAL_WORLD_SIZE is withheld here)."""
    import json

    from torchsnapshot_tpu_torch import scheduler, snapshot

    os.environ.pop("LOCAL_WORLD_SIZE", None)
    knobs._local_world_size = None
    scheduler._mem_available_bytes = lambda: _AVAILABLE
    seen = []
    real = snapshot.sync_execute_write_reqs

    def spy(write_reqs, storage, budget, *a, **k):
        pending = real(write_reqs, storage, budget, *a, **k)
        seen.append((budget, pending._pipeline.io_cap))
        return pending

    snapshot.sync_execute_write_reqs = spy
    state = {"m": tts.StateDict(w=torch.full((64,), float(rank)))}
    tts.Snapshot.take(os.path.join(root, "a"), state)
    tts.Snapshot.take(os.path.join(root, "b"), state)  # a plan-cache hit
    restored = tts.StateDict(w=torch.zeros(64))
    tts.Snapshot(os.path.join(root, "b")).restore({"m": restored}, device="cpu")
    assert torch.equal(restored["w"], state["m"]["w"])
    with open(os.path.join(root, f"seen.{rank}.json"), "w") as f:
        json.dump({"seen": seen, "local": knobs.get_local_world_size()}, f)


def test_cohosted_ranks_split_the_budget_and_the_io_cap(tmp_path):
    import json

    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_cohosted_worker, 2, args=(str(tmp_path),))
    for rank in range(2):
        got = json.loads((tmp_path / f"seen.{rank}.json").read_text())
        assert got["local"] == 2
        assert got["seen"] == [[int(_AVAILABLE * 0.6 / 2), 8]] * 2

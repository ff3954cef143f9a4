"""The sidecars' v2 tree digests and v1 compatibility over the port,
against ``tests/test_hash_compat.py``, with the hashing units of
``tests/test_hashing.py`` held against the JAX package's on the same
bytes.

A v2 take records the JAX package's chunk grid byte for byte and verifies,
scrubs and restores clean; objects within one chunk keep exact v1 records;
scrub names the corrupt chunk and repair patches just its extent;
``VERIFY_READS=all`` catches a chunk-targeted fault on a ranged read that
verification off lets through; a v1 snapshot restores, scrubs and seeds a
v2 take's dedup (in either package), mixed v1-base v2-delta chains round
trip, both formats key the read cache by digest, and the grain enters the
plan fingerprint."""

import asyncio
import json
import os
import random
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import hashing as jhashing
from torchsnapshot_tpu.utils import knobs as jknobs
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import hashing as thashing
from torchsnapshot_tpu_torch.scheduler import ReadVerificationError
from torchsnapshot_tpu_torch.utils import knobs as tknobs

GRAIN = 4096


def _arr(seed=0, kb=64):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(kb * 1024,), dtype=np.uint8).view(np.float32).copy()


def _take(pkg, path, state, grain=GRAIN, base=None):
    if pkg == "jax":
        with jknobs.override_hash_chunk_bytes(grain), jknobs.override_dedup_digests(True):
            jts.Snapshot.take(path, {"m": jts.StateDict(**state)}, base=base)
    else:
        with tknobs.override_hash_chunk_bytes(grain), tknobs.override_dedup_digests(True):
            tts.Snapshot.take(path, {"m": tts.StateDict(**{k: torch.from_numpy(v.copy()) for k, v in state.items()})}, base=base)


def _sidecar(path):
    with open(os.path.join(path, ".checksums.0")) as f:
        return json.load(f)


def _flip(path, obj, offset):
    p = os.path.join(path, obj)
    with open(p, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _restore_both(path, want):
    out = tts.StateDict(**{k: torch.zeros(v.shape) for k, v in want.items()})
    tts.Snapshot(path).restore({"m": out}, device="cpu")
    jout = jts.StateDict(**{k: np.zeros_like(v) for k, v in want.items()})
    jts.Snapshot(path).restore({"m": jout})
    for k, v in want.items():
        assert out[k].numpy().view(np.uint8).tobytes() == v.view(np.uint8).tobytes(), k
        assert np.asarray(jout[k]).view(np.uint8).tobytes() == v.view(np.uint8).tobytes(), k


def test_v2_take_records_the_jax_grid_and_is_clean(tmp_path):
    w = _arr(1)
    _take("port", str(tmp_path / "t"), {"w": w})
    _take("jax", str(tmp_path / "j"), {"w": w})
    rec = _sidecar(str(tmp_path / "t"))["0/m/w"]
    assert rec == _sidecar(str(tmp_path / "j"))["0/m/w"]
    assert thashing.is_v2_record(rec) and rec["grain"] == GRAIN
    assert len(rec["chunks"]) == (w.nbytes + GRAIN - 1) // GRAIN
    with open(os.path.join(tmp_path / "t", "0/m/w"), "rb") as f:
        data = f.read()
    assert rec == thashing.digest_of_bytes(data, GRAIN) == jhashing.digest_of_bytes(data, GRAIN)
    path = str(tmp_path / "t")
    assert tts.Snapshot(path).verify() == jts.Snapshot(path).verify() == {}
    assert tts.Snapshot(path).scrub()["clean"] and jts.Snapshot(path).scrub()["clean"]
    _restore_both(path, {"w": w})


def test_small_objects_keep_exact_v1_records(tmp_path):
    small = np.arange(16, dtype=np.float32)
    _take("port", str(tmp_path / "t"), {"s": small})
    _take("jax", str(tmp_path / "j"), {"s": small})
    rec = _sidecar(str(tmp_path / "t"))["0/m/s"]
    assert rec == _sidecar(str(tmp_path / "j"))["0/m/s"]
    assert isinstance(rec, list) and len(rec) == 3
    with open(os.path.join(tmp_path / "t", "0/m/s"), "rb") as f:
        assert rec == thashing.serial_digest(memoryview(f.read()), True)


def _two_copies(tmp_path, state):
    path = str(tmp_path / "t")
    _take("port", path, state)
    copy = str(tmp_path / "copy")
    shutil.copytree(path, copy)
    return path, copy


def test_scrub_names_the_corrupt_chunk_as_the_jax_package(tmp_path):
    path, copy = _two_copies(tmp_path, {"w": _arr(2)})
    for p in (path, copy):
        _flip(p, "0/m/w", 5 * GRAIN + 17)
    with tknobs.override_hash_chunk_bytes(GRAIN):
        report = tts.Snapshot(path).scrub()
    with jknobs.override_hash_chunk_bytes(GRAIN):
        jreport = jts.Snapshot(copy).scrub()
    assert report == jreport
    entry = report["entries"]["0/m/w"]
    assert entry["status"] == "corrupt" and "[5]" in entry["detail"] and "chunk" in entry["detail"]


def test_repair_patches_one_chunk_extent_as_the_jax_package(tmp_path):
    w = _arr(3)
    path, copy = _two_copies(tmp_path, {"a": w, "b": w.copy()})
    for p in (path, copy):
        _flip(p, "0/m/a", 2 * GRAIN + 1)
    with tknobs.override_hash_chunk_bytes(GRAIN):
        report = tts.Snapshot(path).scrub(repair=True)
        assert tts.Snapshot(path).scrub()["clean"]
    with jknobs.override_hash_chunk_bytes(GRAIN):
        jreport = jts.Snapshot(copy).scrub(repair=True)
    assert report == jreport
    assert report["repaired"] == 1 and report["quarantined"] == 0
    assert "chunk(s) [2] patched from 0/m/b" in report["entries"]["0/m/a"]["detail"]
    _restore_both(path, {"a": w, "b": w})


def test_ranged_verified_reads_catch_a_chunk_targeted_fault(tmp_path):
    w = _arr(4)
    path = str(tmp_path / "t")
    _take("port", path, {"w": w})
    spec = "op=read,kind=corrupt,chunk=3,path=0/m/w"
    with tknobs.override_hash_chunk_bytes(GRAIN), tknobs.override_faults(spec), tknobs.override_verify_reads("all"):
        with pytest.raises(ReadVerificationError) as err:
            tts.Snapshot(path).read_object("0/m/w", memory_budget_bytes=4 * GRAIN, device="cpu")
        assert "chunk" in str(err.value)
    with tknobs.override_hash_chunk_bytes(GRAIN), tknobs.override_faults(spec), tknobs.override_verify_reads("off"):
        got = tts.Snapshot(path).read_object("0/m/w", memory_budget_bytes=4 * GRAIN, device="cpu")
    assert got.numpy().view(np.uint8).tobytes() != w.view(np.uint8).tobytes()
    with tknobs.override_hash_chunk_bytes(GRAIN), tknobs.override_verify_reads("all"):
        got = tts.Snapshot(path).read_object("0/m/w", memory_budget_bytes=4 * GRAIN, device="cpu")
    assert got.numpy().view(np.uint8).tobytes() == w.view(np.uint8).tobytes()


@pytest.mark.parametrize("delta_writer", ["port", "jax"])
def test_v1_snapshot_seeds_a_v2_take_in_either_package(tmp_path, delta_writer):
    """The port's v1 (grain 0) take restores and scrubs clean; a v2 take
    on it, by either package, links the unchanged object and records v2
    with the v1 whole sha."""
    w = _arr(6)
    v1 = str(tmp_path / "v1")
    _take("port", v1, {"w": w}, grain=0)
    rec = _sidecar(v1)["0/m/w"]
    assert isinstance(rec, list) and rec[2] is not None
    assert tts.Snapshot(v1).verify() == {} and tts.Snapshot(v1).scrub()["clean"]
    _restore_both(v1, {"w": w})
    v2 = str(tmp_path / "v2")
    _take(delta_writer, v2, {"w": w}, base=v1)
    assert os.stat(os.path.join(v1, "0/m/w")).st_ino == os.stat(os.path.join(v2, "0/m/w")).st_ino
    rec2 = _sidecar(v2)["0/m/w"]
    assert thashing.is_v2_record(rec2) and rec2["sha"] == rec[2]


def test_mixed_v1_base_v2_delta_chain_round_trips(tmp_path):
    frozen, hot0, hot1 = _arr(7), _arr(8), _arr(9)
    base, delta = str(tmp_path / "base"), str(tmp_path / "delta")
    _take("port", base, {"frozen": frozen, "hot": hot0}, grain=0)
    _take("port", delta, {"frozen": frozen, "hot": hot1}, base=base)
    assert os.stat(os.path.join(base, "0/m/frozen")).st_ino == os.stat(os.path.join(delta, "0/m/frozen")).st_ino
    assert os.stat(os.path.join(base, "0/m/hot")).st_ino != os.stat(os.path.join(delta, "0/m/hot")).st_ino
    for path, hot in ((base, hot0), (delta, hot1)):
        _restore_both(path, {"frozen": frozen, "hot": hot})
        assert tts.Snapshot(path).verify() == {} and tts.Snapshot(path).scrub()["clean"]
        assert jts.Snapshot(path).verify() == {} and jts.Snapshot(path).scrub()["clean"]


@pytest.mark.parametrize("grain", [0, GRAIN], ids=["v1", "v2"])
def test_both_formats_key_the_read_cache_as_the_jax_package(tmp_path, grain):
    w = _arr(10)
    path = str(tmp_path / "t")
    _take("port", path, {"w": w}, grain=grain)

    def names(cache_dir):
        out = []
        for _, _, files in os.walk(os.path.join(cache_dir, "by-digest")):
            out.extend(files)
        return sorted(out)

    with tknobs.override_hash_chunk_bytes(grain), tknobs.override_read_cache_dir(str(tmp_path / "tcache")):
        for _ in range(2):
            out = tts.StateDict(w=torch.zeros(w.shape))
            tts.Snapshot(path).restore({"m": out}, device="cpu")
            assert out["w"].numpy().view(np.uint8).tobytes() == w.view(np.uint8).tobytes()
    with jknobs.override_hash_chunk_bytes(grain), jknobs.override_read_cache_dir(str(tmp_path / "jcache")):
        jts.Snapshot(path).restore({"m": jts.StateDict(w=np.zeros_like(w))})
    got = names(str(tmp_path / "tcache"))
    assert got and got == names(str(tmp_path / "jcache"))
    if grain:
        assert any(n.endswith(f"-t{grain}") for n in got)
    else:
        assert all(len(n) == 64 for n in got)


def test_hash_grain_shapes_the_plan_fingerprint():
    from torchsnapshot_tpu_torch.take_plan import compute_fingerprint

    with tknobs.override_hash_chunk_bytes(1024):
        a = compute_fingerprint({}, 1, [])
    with tknobs.override_hash_chunk_bytes(2048):
        b = compute_fingerprint({}, 1, [])
    assert a != b


# ---------------------------------------------------------------------------
# The hashing units (tests/test_hashing.py) on the same bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_crc32_combine_matches_the_jax_package(seed):
    import zlib

    rng = random.Random(seed)
    data = rng.randbytes(rng.randrange(0, 5000))
    cut = rng.randrange(0, len(data) + 1)
    a, b = zlib.crc32(data[:cut]), zlib.crc32(data[cut:])
    got = thashing.crc32_combine(a, b, len(data) - cut)
    assert got == jhashing.crc32_combine(a, b, len(data) - cut) == zlib.crc32(data)


@pytest.mark.parametrize("size,grain", [(0, 16), (1, 16), (15, 16), (16, 16), (17, 16), (5000, 512), (5000, 0)])
def test_digests_and_extents_match_the_jax_package(size, grain):
    data = random.Random(size * 31 + grain).randbytes(size)
    if grain:
        assert thashing.chunk_extents(size, grain) == jhashing.chunk_extents(size, grain)
    for want_sha in (True, False):
        rec = thashing.digest_of_bytes(data, grain, want_sha)
        assert rec == jhashing.digest_of_bytes(data, grain, want_sha)
        assert thashing.record_content_keys(rec) == jhashing.record_content_keys(rec)
        assert thashing.record_cache_key(rec) == jhashing.record_cache_key(rec)
        assert thashing.record_size(rec) == jhashing.record_size(rec) == size


def test_verification_verdicts_match_the_jax_package():
    data = bytearray(random.Random(2).randbytes(5000))
    rec = thashing.digest_of_bytes(bytes(data), 512)
    data[1100] ^= 0xFF
    mv = memoryview(bytes(data))
    assert thashing.find_bad_chunks(mv, rec) == jhashing.find_bad_chunks(mv, rec) == [2]
    assert thashing.verify_buffer(mv, rec) == jhashing.verify_buffer(mv, rec)
    for begin, end in ((0, 1024), (1024, 2048), (1000, 1600), (512, 5000)):
        part = mv[begin:end]
        assert thashing.verify_range(part, rec, begin, end) == jhashing.verify_range(part, rec, begin, end)
        assert thashing.range_verifiable(rec, begin, end) == jhashing.range_verifiable(rec, begin, end)


@pytest.mark.parametrize("grain", [0, 64, 512])
def test_stream_hasher_matches_the_whole_buffer_digest(grain):
    rng = random.Random(grain)
    data = rng.randbytes(5000)

    async def go():
        ex = ThreadPoolExecutor(max_workers=3)
        try:
            h = thashing.make_stream_hasher(grain, True, asyncio.get_running_loop(), ex)
            off = 0
            while off < len(data):
                take = rng.randrange(1, 700)
                await h.feed(data[off : off + take])
                off += take
            return await h.finalize()
        finally:
            ex.shutdown(wait=True)

    loop = asyncio.new_event_loop()
    try:
        got = loop.run_until_complete(go())
    finally:
        loop.close()
    assert got == thashing.digest_of_bytes(data, grain) == jhashing.digest_of_bytes(data, grain)

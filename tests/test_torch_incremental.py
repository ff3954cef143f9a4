"""Incremental takes (``take(base=)``) of the port, against the JAX package.

Objects byte-identical to the base's (size and sha256 or tree root, from
its sidecars) are hard-linked: ``os.path.samefile`` holds for unchanged
objects, slabs included (they match by content, their paths being new each
take), and not for changed ones. Deleting the base leaves the incremental
snapshot whole. A port take against a JAX-written base links the byte-equal
objects. With dedup digests off, ``base=`` is ignored with a warning.
"""

import logging
import os
import shutil

import numpy as np
import pytest

import torchsnapshot_tpu as jts

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.convert import from_numpy_tree


@pytest.fixture(autouse=True)
def _pin_digests(monkeypatch):
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_DEDUP_DIGESTS", "1")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "frozen": rng.standard_normal((64, 32)).astype(np.float32),
        "head": rng.standard_normal((16, 32)).astype(np.float32),
        "small_frozen": {f"b{i}": rng.standard_normal(8).astype(np.float32) for i in range(4)},
        "small_live": {f"c{i}": rng.standard_normal(8).astype(np.float32) for i in range(3)},
        "step": 1,
    }


def _object_of(path, manifest, key):
    return os.path.join(path, manifest[key].location)


def _samefile(base, inc, key):
    bm, im = tts.Snapshot(base).get_manifest(), tts.Snapshot(inc).get_manifest()
    return os.path.samefile(_object_of(base, bm, key), _object_of(inc, im, key))


def _restore(path, tree):
    target = tts.StateDict(from_numpy_tree({k: _zeros(v) for k, v in tree.items()}, device="cpu"))
    tts.Snapshot(path).restore({"m": target}, device="cpu")
    return target


def _zeros(v):
    if isinstance(v, dict):
        return {k: _zeros(x) for k, x in v.items()}
    return np.zeros_like(v) if isinstance(v, np.ndarray) else None


def _assert_equal(got, want):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_equal(got[k], v)
        elif isinstance(v, np.ndarray):
            assert np.array_equal(got[k].numpy(), v), k
        else:
            assert got[k] == v, k


def _step(tree):
    """The next step: the head, the live small tensors and the step change."""
    tree = {k: (dict(v) if isinstance(v, dict) else v) for k, v in tree.items()}
    tree["head"] = tree["head"] + 1
    tree["small_live"] = {k: v * 2 for k, v in tree["small_live"].items()}
    tree["step"] += 1
    return tree


@pytest.mark.parametrize("batching", [False, True], ids=["plain", "batched"])
@pytest.mark.parametrize("kind", ["sync", "async"])
def test_unchanged_objects_are_linked_changed_ones_written(tmp_path, monkeypatch, batching, kind):
    monkeypatch.setenv("TSS_TORCH_ENABLE_BATCHING", "1" if batching else "0")
    # Slabs close at 128 bytes here: the four frozen 32-byte members fill
    # one slab, the live ones another.
    monkeypatch.setenv("TSS_TORCH_SLAB_SIZE_THRESHOLD_BYTES", "128")
    tree0 = _tree(0)
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    tts.Snapshot.take(base, {"m": tts.StateDict(from_numpy_tree(tree0, device="cpu"))})
    tree1 = _step(tree0)
    app = {"m": tts.StateDict(from_numpy_tree(tree1, device="cpu"))}
    if kind == "sync":
        tts.Snapshot.take(inc, app, base=base)
        stats = dict(snapshot_mod.LAST_SYNC_DRAIN_STATS)
    else:
        pending = tts.Snapshot.async_take(inc, app, base=base)
        pending.wait()
        stats = pending.drain_stats
    for key in ("0/m/frozen", "0/m/small_frozen/b0", "0/m/small_frozen/b3"):
        assert _samefile(base, inc, key), key
    for key in ("0/m/head", "0/m/small_live/c0"):
        assert not _samefile(base, inc, key), key
    bm, im = tts.Snapshot(base).get_manifest(), tts.Snapshot(inc).get_manifest()
    if batching:
        # A slab's path is new each take: it matched by content.
        assert bm["0/m/small_frozen/b0"].location.startswith("batched/")
        assert bm["0/m/small_frozen/b0"].location != im["0/m/small_frozen/b0"].location
    linked = 2 if batching else 5
    assert stats["objects_linked"] == linked
    assert stats["bytes_deduped"] == tree0["frozen"].nbytes + 4 * 32
    _assert_equal(_restore(inc, tree1), tree1)
    assert tts.Snapshot(inc).verify() == {}


def test_deleting_the_base_keeps_the_incremental_snapshot(tmp_path):
    tree0 = _tree(1)
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    tts.Snapshot.take(base, {"m": tts.StateDict(from_numpy_tree(tree0, device="cpu"))})
    tree1 = _step(tree0)
    tts.Snapshot.take(inc, {"m": tts.StateDict(from_numpy_tree(tree1, device="cpu"))}, base=base)
    assert _samefile(base, inc, "0/m/frozen")
    shutil.rmtree(base)
    _assert_equal(_restore(inc, tree1), tree1)
    assert tts.Snapshot(inc).verify() == {}


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_port_take_against_a_jax_base_links_byte_equal_objects(tmp_path, monkeypatch, codec):
    """The JAX package writes the base; the port's incremental take of the
    next step links the objects whose bytes did not change (compressed ones
    too: the codecs are deterministic at one library version and level)."""
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_COMPRESSION", codec)
    monkeypatch.setenv("TSS_TORCH_COMPRESSION", codec)
    tree0 = _tree(2)
    base, inc = str(tmp_path / "jax_base"), str(tmp_path / "inc")
    jts.Snapshot.take(base, {"m": jts.StateDict(tree0)})
    tree1 = _step(tree0)
    tts.Snapshot.take(inc, {"m": tts.StateDict(from_numpy_tree(tree1, device="cpu"))}, base=base)
    for key in ("0/m/frozen", "0/m/small_frozen/b1"):
        assert _samefile(base, inc, key), key
    for key in ("0/m/head", "0/m/small_live/c1"):
        assert not _samefile(base, inc, key), key
    _assert_equal(_restore(inc, tree1), tree1)
    # ...and the JAX package restores the port's incremental snapshot.
    target = jts.StateDict({k: _zeros(v) for k, v in tree1.items()})
    jts.Snapshot(inc).restore({"m": target})
    assert np.array_equal(np.asarray(target["frozen"]), tree1["frozen"])
    assert np.array_equal(np.asarray(target["head"]), tree1["head"])


def test_base_ignored_without_dedup_digests(tmp_path, monkeypatch, caplog):
    tree0 = _tree(3)
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    tts.Snapshot.take(base, {"m": tts.StateDict(from_numpy_tree(tree0, device="cpu"))})
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "0")
    with caplog.at_level(logging.WARNING, logger="torchsnapshot_tpu_torch.snapshot"):
        tts.Snapshot.take(inc, {"m": tts.StateDict(from_numpy_tree(tree0, device="cpu"))}, base=base)
    assert any("ignored" in r.getMessage() for r in caplog.records)
    assert not _samefile(base, inc, "0/m/frozen")
    assert snapshot_mod.LAST_SYNC_DRAIN_STATS["objects_linked"] == 0
    _assert_equal(_restore(inc, tree0), tree0)


def test_a_base_without_digests_or_metadata_writes_everything(tmp_path, monkeypatch, caplog):
    """An unusable base never fails the take: a base taken with dedup
    digests off carries no identities, and an uncommitted one no metadata."""
    tree0 = _tree(4)
    no_sha, inc = str(tmp_path / "no_sha"), str(tmp_path / "inc")
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "0")
    tts.Snapshot.take(no_sha, {"m": tts.StateDict(from_numpy_tree(tree0, device="cpu"))})
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    with caplog.at_level(logging.WARNING, logger="torchsnapshot_tpu_torch.snapshot"):
        tts.Snapshot.take(inc, {"m": tts.StateDict(from_numpy_tree(tree0, device="cpu"))}, base=no_sha)
        tts.Snapshot.take(inc + "2", {"m": tts.StateDict(from_numpy_tree(tree0, device="cpu"))}, base=str(tmp_path / "nowhere"))
    messages = " ".join(r.getMessage() for r in caplog.records)
    assert "no sha256 dedup identities" in messages and "no committed metadata" in messages
    assert not _samefile(no_sha, inc, "0/m/frozen")
    _assert_equal(_restore(inc + "2", tree0), tree0)


def test_link_in_fails_soft(tmp_path):
    """The fs plugin's link_in: an atomic hard link, or False (the caller
    then writes)."""
    import asyncio

    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    src = tmp_path / "src.bin"
    src.write_bytes(b"abc")
    plugin = FSStoragePlugin(str(tmp_path / "dst"))
    loop = asyncio.new_event_loop()
    try:
        assert loop.run_until_complete(plugin.link_in(str(src), "a/b/obj"))
        assert os.path.samefile(src, tmp_path / "dst" / "a" / "b" / "obj")
        assert not loop.run_until_complete(plugin.link_in(str(tmp_path / "missing"), "a/c"))
        assert not os.path.exists(tmp_path / "dst" / "a" / "c")
        assert os.listdir(tmp_path / "dst" / "a") == ["b"]  # no temp left behind
    finally:
        plugin.sync_close(loop)
        loop.close()


def test_v2_records_dedup_against_v1_base(tmp_path, monkeypatch):
    """A base hashed at grain 0 (v1 whole-object sha256) and an incremental
    take at a small grain (v2 tree roots) still match: the take records the
    whole-object sha256 too when the base holds v1 records."""
    tree0 = {"x": np.arange(4096, dtype=np.float32), "y": np.ones(4, np.float32)}
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    monkeypatch.setenv("TSS_TORCH_HASH_CHUNK_BYTES", "0")
    tts.Snapshot.take(base, {"m": tts.StateDict(from_numpy_tree(tree0, device="cpu"))})
    monkeypatch.setenv("TSS_TORCH_HASH_CHUNK_BYTES", "1024")
    tts.Snapshot.take(inc, {"m": tts.StateDict(from_numpy_tree(tree0, device="cpu"))}, base=base)
    assert _samefile(base, inc, "0/m/x") and _samefile(base, inc, "0/m/y")


def test_frozen_finetune_drive_on_cpu(tmp_path):
    """``chip_smoke.py``'s phase 5 at a tiny size on the CPU: a prepared-take
    miss then hit, an incremental take that links every frozen tensor, a
    zlib take, three bit-exact restores and a bit-identical resume; then a
    batched miss, hit and incremental take, each restored bit-exactly."""
    from torchsnapshot_tpu_torch import dryrun
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=128, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=16)
    out = dryrun.frozen_finetune_checkpoints(cfg, str(tmp_path), device="cpu", batch=2, frozen_blocks=2)
    assert out["c0_cache"] == {"plan_cache_hit": False, "prepared_cache_hit": False}
    assert out["c1_cache"] == {"plan_cache_hit": False, "prepared_cache_hit": True}
    assert out["c2_bytes_deduped"] >= out["frozen_bytes"] > 0
    assert out["c2_samefile"] == out["c2_objects_linked"] >= 2 + 2 * 12
    assert len(out["losses"]) == 10 and out["c3_disk_bytes"] > 0
    assert out["c4_cache"] == {"plan_cache_hit": False, "prepared_cache_hit": False}
    assert out["c5_cache"] == {"plan_cache_hit": False, "prepared_cache_hit": True}
    assert 0 < out["c6_bytes_deduped"] and out["c6_samefile"] == out["c6_objects_linked"] >= 1
    for c in ("c0", "c1", "c2", "c3", "c4", "c5", "c6"):
        assert out[c + "_stream"]["decision"]["mode"] in ("auto", "on", "off"), c
    assert not os.listdir(tmp_path)  # the snapshots were removed


@pytest.mark.parametrize("grain", [0, 64, 1 << 20], ids=["serial", "chunked", "single_chunk"])
@pytest.mark.parametrize("want_sha", [True, False], ids=["sha", "crc_only"])
def test_record_helpers_match_the_jax_package(grain, want_sha):
    """The dedup identities: the same bytes give the same record and the
    same size, whole sha256, content keys and cache key in both packages."""
    from torchsnapshot_tpu import hashing as jhashing
    from torchsnapshot_tpu_torch import hashing as thashing

    data = np.random.default_rng(5).integers(0, 255, 1000).astype(np.uint8).tobytes()
    rec = thashing.digest_of_bytes(data, grain, want_sha)
    assert rec == jhashing.digest_of_bytes(data, grain, want_sha)
    for name in ("record_size", "record_whole_sha", "record_content_keys", "record_cache_key"):
        assert getattr(thashing, name)(rec) == getattr(jhashing, name)(rec), name
    assert thashing.record_size(rec) == len(data)
    assert bool(thashing.record_content_keys(rec)) == want_sha

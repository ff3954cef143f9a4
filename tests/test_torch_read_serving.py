"""Read serving in the port against the JAX package: ``memory://``,
verified reads, the read cache (one directory for both packages), lazy
``include=`` restores, the broadcast and swarm plan math, 2-rank broadcast
and swarm restores (gloo), re-election past a stalled reader, and
``scrub`` with and without repair. Inputs come from seeded numpy."""

import asyncio
import json
import os
import shutil

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import bcast as jax_bcast
from torchsnapshot_tpu import scheduler as jax_scheduler
from torchsnapshot_tpu import snapshot as jax_snapshot
from torchsnapshot_tpu import swarm as jax_swarm
from torchsnapshot_tpu.storage_plugins import cache as jax_cache

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import bcast, scheduler, swarm
from torchsnapshot_tpu_torch import snapshot as port_snapshot
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.io_types import ReadIO
from torchsnapshot_tpu_torch.storage_plugins import cache as port_cache
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

_ENV = {"TSS_TORCH_DEDUP_DIGESTS": "1", "TORCHSNAPSHOT_TPU_DEDUP_DIGESTS": "1"}


@pytest.fixture(autouse=True)
def _pin_digests(monkeypatch):
    for k, v in _ENV.items():
        monkeypatch.setenv(k, v)


def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "emb": rng.standard_normal((300, 64)).astype(np.float32),
        "blocks": {
            "0": {"w": rng.standard_normal((64, 64)).astype(np.float32), "b": rng.standard_normal(64).astype(np.float32)},
            "1": {"w": rng.standard_normal((64, 64)).astype(np.float32), "b": rng.standard_normal(64).astype(np.float32)},
        },
        "ids": rng.integers(0, 1000, 777).astype(np.int64),
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in tree.items()}


def _port_restore(path, tree, **kw):
    target = tts.StateDict(**_zeros_like(tree))
    tts.Snapshot(path).restore({"m": target}, device="cpu", **kw)
    return target


def _assert_tree_equal(target, tree):
    for k, v in _flat(tree).items():
        node = target
        for part in k.split("/"):
            node = node[part]
        assert np.array_equal(node.numpy(), v), k


# ---------------------------------------------------------------------------
# memory://
# ---------------------------------------------------------------------------


def test_memory_round_trip_matches_jax():
    from torchsnapshot_tpu.storage_plugins.memory import _SHARED_ROOTS as jax_roots
    from torchsnapshot_tpu_torch.storage_plugins.memory import SHARED_ROOTS as port_roots

    tree = _tree(1)
    tts.Snapshot.take("memory://serving-rt", {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    jts.Snapshot.take("memory://serving-rt", {"m": jts.StateDict(**tree)})
    port_objs = port_roots["serving-rt"].objects
    jax_objs = jax_roots["serving-rt"].objects
    # Both packages write the per-rank telemetry artifact; only its
    # contents (timings, pids, versions) differ.
    assert ".telemetry/rank_0.json" in port_objs
    assert set(port_objs) == set(jax_objs)
    for p in port_objs:
        if p != ".snapshot_metadata" and not p.startswith(".telemetry/"):
            assert port_objs[p] == jax_objs[p], p
    _assert_tree_equal(_port_restore("memory://serving-rt", tree), tree)
    got = tts.Snapshot("memory://serving-rt").read_object("0/m/ids", device="cpu")
    assert np.array_equal(got.numpy(), tree["ids"])


def test_memory_plugin_reads_into_the_callers_buffer():
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    plugin = MemoryStoragePlugin()
    plugin.objects["x"] = bytes(range(100))
    into = memoryview(bytearray(10))
    read_io = ReadIO(path="x", byte_range=(5, 15), into=into)
    asyncio.new_event_loop().run_until_complete(plugin.read(read_io))
    assert read_io.buf is into and bytes(into) == bytes(range(5, 15))
    with pytest.raises(FileNotFoundError):
        asyncio.new_event_loop().run_until_complete(plugin.read(ReadIO(path="missing")))


# ---------------------------------------------------------------------------
# Verified reads
# ---------------------------------------------------------------------------


def _flip(path: str, offset: int = 0) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corrupt_object_raises_under_all_in_both_packages(tmp_path, monkeypatch, writer):
    tree = _tree(2)
    path = str(tmp_path / "s")
    if writer == "jax":
        jts.Snapshot.take(path, {"m": jts.StateDict(**tree)})
    else:
        tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    _flip(os.path.join(path, "0/m/emb"), 100)
    monkeypatch.setenv("TSS_TORCH_VERIFY_READS", "all")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_VERIFY_READS", "all")
    with pytest.raises(tts.CheckpointAbortedError) as tinfo:
        _port_restore(path, tree)
    assert isinstance(tinfo.value.__cause__, scheduler.ReadVerificationError)
    jtarget = jts.StateDict(**{k: (np.zeros_like(v) if not isinstance(v, dict) else {kk: {kkk: np.zeros_like(vvv) for kkk, vvv in vv.items()} for kk, vv in v.items()}) for k, v in tree.items()})
    # Both packages wrap it, at world 1 too.
    with pytest.raises(jax_snapshot.CheckpointAbortedError) as info:
        jts.Snapshot(path).restore({"m": jtarget})
    assert isinstance(info.value.__cause__, jax_scheduler.ReadVerificationError)
    assert (tinfo.value.rank, tinfo.value.phase) == (info.value.rank, info.value.phase) == (0, "restore.read")
    # Under auto the direct pipeline trusts origin reads, in both packages.
    monkeypatch.setenv("TSS_TORCH_VERIFY_READS", "auto")
    target = _port_restore(path, tree)
    assert not np.array_equal(target["emb"].numpy(), tree["emb"])


def test_ranged_reads_are_verified_chunk_by_chunk(tmp_path, monkeypatch):
    """A budgeted read_object sub-reads ranges; under ``all`` each range
    is checked against the v2 chunks it covers."""
    monkeypatch.setenv("TSS_TORCH_HASH_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TSS_TORCH_VERIFY_READS", "all")
    x = np.random.default_rng(3).standard_normal(8192).astype(np.float32)
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=torch.from_numpy(x))})
    got = tts.Snapshot(path).read_object("0/m/x", device="cpu", memory_budget_bytes=8192)
    assert np.array_equal(got.numpy(), x)
    _flip(os.path.join(path, "0/m/x"), 20000)
    with pytest.raises(scheduler.ReadVerificationError):
        tts.Snapshot(path).read_object("0/m/x", device="cpu", memory_budget_bytes=8192)


def test_verify_checker_matches_jax():
    rec = {"v": 2, "crc": 0, "size": 10000, "grain": 4096, "root": None, "chunks": None, "crcs": [1, 2, 3], "sha": None}
    for rng in [None, (0, 10000), (0, 4096), (10, 4000), (4096, 9000), (100, 9000)]:
        a = scheduler._verify_checker(rec, rng)
        b = jax_scheduler._verify_checker(rec, rng)
        assert (a is None) == (b is None), rng


# ---------------------------------------------------------------------------
# The read cache: one directory for both packages
# ---------------------------------------------------------------------------


def _cache_files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            rel = os.path.relpath(p, root)
            if not rel.startswith("tmp"):
                out[rel] = open(p, "rb").read()
    return out


def _jax_restore(path, tree):
    def zeros(t):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in t.items()}

    target = jts.StateDict(**zeros(tree))
    jts.Snapshot(path).restore({"m": target})
    for k, v in _flat(tree).items():
        node = target
        for part in k.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node), v), k
    return jax_snapshot.LAST_RESTORE_STATS


@pytest.mark.parametrize("filler", ["jax", "port"])
def test_cache_filled_by_one_package_serves_the_other(tmp_path, monkeypatch, filler):
    tree = _tree(4)
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    cache_dir = str(tmp_path / "cache")
    monkeypatch.setenv("TSS_TORCH_READ_CACHE_DIR", cache_dir)
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_READ_CACHE_DIR", cache_dir)
    if filler == "jax":
        _jax_restore(path, tree)
    else:
        _assert_tree_equal(_port_restore(path, tree), tree)
        assert port_snapshot.LAST_RESTORE_STATS["attribution"]["origin_bytes"] > 0
    filled = _cache_files(cache_dir)
    assert any(k.startswith("by-digest") for k in filled)
    # The origin goes away: every read must come from the cache.
    shutil.move(path, str(tmp_path / "gone"))
    if filler == "jax":
        _assert_tree_equal(_port_restore(path, tree), tree)
        attribution = port_snapshot.LAST_RESTORE_STATS["attribution"]
        assert attribution["origin_bytes"] == 0 and attribution["cache_bytes"] > 0
    else:
        stats = _jax_restore(path, tree)
        assert stats["attribution"]["origin_bytes"] == 0
    assert _cache_files(cache_dir) == filled


def _cache_ops(mod, inner_root, cache_dir, digests):
    """The same operations through one package's CachedStoragePlugin."""
    from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JaxFS

    inner = (JaxFS if mod is jax_cache else FSStoragePlugin)(inner_root)
    cache = mod.CachedStoragePlugin(inner, origin_id="origin", cache_dir=cache_dir, max_bytes=30000)
    cache.attach_digest_index(digests)
    loop = asyncio.new_event_loop()
    got = []

    def read(path, rng=None):
        if mod is jax_cache:
            from torchsnapshot_tpu.io_types import ReadIO as JReadIO

            rio = JReadIO(path=path, byte_range=rng)
            loop.run_until_complete(cache.read(rio))
            return rio.buf.getvalue()
        rio = ReadIO(path=path, byte_range=rng)
        loop.run_until_complete(cache.read(rio))
        return bytes(rio.buf)

    got.append(read("a"))  # miss, populate by digest
    got.append(read("a"))  # hit
    got.append(read("b", (4096, 8192)))  # ranged miss: one chunk into the sparse tier
    got.append(read("b", (4100, 8000)))  # served from the sparse entry
    got.append(read("c"))  # path-keyed (no digest)
    got.append(read("d"))  # evicts past 30000 bytes
    removed = cache.quarantine_path("a")
    loop.run_until_complete(cache.close())
    loop.close()
    return got, removed


def test_cache_layout_and_results_match_jax(tmp_path):
    from torchsnapshot_tpu_torch import hashing

    rng = np.random.default_rng(5)
    blobs = {n: rng.integers(0, 256, size, dtype=np.uint8).tobytes() for n, size in [("a", 10000), ("b", 12288), ("c", 500), ("d", 20000)]}
    origin = tmp_path / "origin"
    origin.mkdir()
    for n, data in blobs.items():
        (origin / n).write_bytes(data)
    digests = {}
    for n in ("a", "b", "d"):
        rec = hashing.digest_of_bytes(blobs[n], 4096, True)
        digests[n] = (hashing.record_size(rec), hashing.record_cache_key(rec), hashing.record_crc(rec), hashing.record_chunk_info(rec))
    port_got, port_removed = _cache_ops(port_cache, str(origin), str(tmp_path / "pc"), digests)
    jax_got, jax_removed = _cache_ops(jax_cache, str(origin), str(tmp_path / "jc"), digests)
    assert port_got == jax_got
    assert port_got[0] == blobs["a"] and port_got[3] == blobs["b"][4100:8000]
    assert port_removed == jax_removed
    assert _cache_files(str(tmp_path / "pc")).keys() == _cache_files(str(tmp_path / "jc")).keys()


def test_corrupt_cache_entry_falls_back_to_origin(tmp_path, monkeypatch):
    tree = _tree(6)
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    cache_dir = str(tmp_path / "cache")
    monkeypatch.setenv("TSS_TORCH_READ_CACHE_DIR", cache_dir)
    _port_restore(path, tree)
    entries = [os.path.join(d, n) for d, _, ns in os.walk(os.path.join(cache_dir, "by-digest")) for n in ns]
    for e in entries:
        _flip(e, 3)
    _assert_tree_equal(_port_restore(path, tree), tree)
    assert port_snapshot.LAST_RESTORE_STATS["attribution"]["origin_bytes"] > 0
    _assert_tree_equal(_port_restore(path, tree), tree)  # re-populated
    assert port_snapshot.LAST_RESTORE_STATS["attribution"]["origin_bytes"] == 0


# ---------------------------------------------------------------------------
# Lazy restore (include=)
# ---------------------------------------------------------------------------


def test_include_entry_sets_match_jax():
    paths = ["m/emb", "m/blocks/0/w", "m/blocks/0/b", "m/blocks/10/w", "m/ids", "m/blocks"]
    for globs in (["m/blocks/0"], ["m/blocks/0/"], ["m/*/1*/w"], ["m/emb", "m/ids"], ["m/blocks/*"], ["x"]):
        for p in paths:
            assert port_snapshot._matches_include(p, globs) == jax_snapshot._matches_include(p, globs), (p, globs)


def test_include_reads_only_the_subtree(tmp_path):
    tree = _tree(7)
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    target = tts.StateDict(**_zeros_like(tree))
    live_emb = target["emb"].clone().fill_(5)
    target["emb"].copy_(live_emb)
    tts.Snapshot(path).restore({"m": target}, device="cpu", include=["m/blocks/1"])
    assert np.array_equal(target["blocks"]["1"]["w"].numpy(), tree["blocks"]["1"]["w"])
    assert np.array_equal(target["blocks"]["1"]["b"].numpy(), tree["blocks"]["1"]["b"])
    assert torch.equal(target["emb"], live_emb)  # kept its live value
    assert not target["blocks"]["0"]["w"].any()
    subtree = tree["blocks"]["1"]["w"].nbytes + tree["blocks"]["1"]["b"].nbytes
    assert port_snapshot.LAST_RESTORE_STATS["bytes_read"] == subtree
    jtarget = jts.StateDict(**{k: np.zeros_like(v) if not isinstance(v, dict) else {kk: {kkk: np.zeros_like(vvv) for kkk, vvv in vv.items()} for kk, vv in v.items()} for k, v in tree.items()})
    jts.Snapshot(path).restore({"m": jtarget}, include=["m/blocks/1"])
    assert jax_snapshot.LAST_RESTORE_STATS["bytes_read"] == subtree


# ---------------------------------------------------------------------------
# Broadcast and swarm plan math
# ---------------------------------------------------------------------------


def test_reader_order_matches_jax():
    for world in (1, 2, 3, 7):
        for i in range(50):
            rng = None if i % 3 == 0 else (i * 4096, i * 4096 + 777)
            path = f"replicated/m/p{i}"
            assert bcast.elect_reader(path, rng, world) == jax_bcast.elect_reader(path, rng, world)
            assert bcast.reader_order(path, rng, world) == jax_bcast.reader_order(path, rng, world)
    for members in (frozenset({0}), frozenset({1, 3}), frozenset({0, 1, 2, 5})):
        for k in range(10):
            assert swarm.need_order("p", (k, k + 9), members) == jax_swarm.need_order("p", (k, k + 9), members)


def _digests_of_take(tmp_path, grain):
    import torchsnapshot_tpu_torch.utils.knobs as knobs

    tree = _tree(8)
    path = str(tmp_path / "g")
    with knobs.override_hash_chunk_bytes(grain):
        tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))}, replicated=["**"])
    return json.load(open(os.path.join(path, ".checksums.0")))


def test_chunk_grid_and_plan_objects_match_jax(tmp_path):
    digests = _digests_of_take(tmp_path, 4096)
    paths = sorted(digests)
    for p in paths:
        assert swarm.chunk_grid(digests, p) == jax_swarm.chunk_grid(digests, p)
    gridded = [p for p in paths if swarm.chunk_grid(digests, p) is not None]
    assert gridded, digests
    for world in (2, 3, 5):
        a = swarm.plan_objects(gridded, digests, world)
        b = jax_swarm.plan_objects(gridded, digests, world)
        for x, y in zip(a, b):
            assert (x.path, x.size, x.grain, x.shas, x.crcs, x.extents, x.orders) == (
                y.path, y.size, y.grain, y.shas, y.crcs, y.extents, y.orders
            )
    bad = dict(digests)
    p = gridded[0]
    bad[p] = dict(bad[p], root="0" * 64)
    assert swarm.chunk_grid(bad, p) is None and jax_swarm.chunk_grid(bad, p) is None


class _FakeMesh:
    def __init__(self, shape, ranks):
        self.shape = tuple(shape)
        self.mesh = torch.tensor(ranks).reshape(shape)


class _FakeDTensor:
    """What the need-plan reads of a DTensor: its mesh and placements."""

    def __init__(self, shape, mesh, placements):
        self.shape = torch.Size(shape)
        self.device_mesh = mesh
        self.placements = placements


def test_plan_reshard_need_matches_jax(tmp_path):
    """Saved in two row shards, restored column-sharded over two ranks:
    each chunk is needed by both (the need sets equal the JAX package's
    for the same geometry on 8 CPU devices in two fake processes)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from torch.distributed.tensor import Shard as TShard

    from torchsnapshot_tpu import manifest as jax_manifest
    from torchsnapshot_tpu_torch import manifest as port_manifest

    rows, cols, grain = 64, 32, 2048
    digests = {}
    for r in range(2):
        data = np.random.default_rng(r).standard_normal((rows // 2, cols)).astype(np.float32).tobytes()
        from torchsnapshot_tpu_torch import hashing

        digests[f"sharded/m/w.{r * rows // 2}_0"] = hashing.digest_of_bytes(data, grain, True)

    def entry(mod):
        shards = [
            mod.Shard(
                offsets=[r * rows // 2, 0],
                sizes=[rows // 2, cols],
                tensor=mod.ArrayEntry(
                    location=f"sharded/m/w.{r * rows // 2}_0", serializer="raw", dtype="float32",
                    shape=[rows // 2, cols], replicated=False,
                ),
            )
            for r in range(2)
        ]
        return mod.ShardedArrayEntry(dtype="float32", shape=[rows, cols], shards=shards)

    live = _FakeDTensor((rows, cols), _FakeMesh((2,), [0, 1]), (TShard(1),))
    port_need = swarm.plan_reshard_need(entry(port_manifest), live, digests, 2)
    devices = np.array(jax.devices()[:8])
    sharding = NamedSharding(Mesh(devices, ("x",)), P(None, "x"))
    jax_need = jax_swarm.plan_reshard_need(
        entry(jax_manifest), sharding, (rows, cols), digests, 2,
        process_of_device=lambda d: 0 if d.id < 4 else 1,
    )
    assert port_need == jax_need and port_need is not None
    assert all(s == frozenset({0, 1}) for sets in port_need.values() for s in sets)
    live_rows = _FakeDTensor((rows, cols), _FakeMesh((2,), [0, 1]), (TShard(0),))
    row_need = swarm.plan_reshard_need(entry(port_manifest), live_rows, digests, 2)
    assert row_need == {
        "sharded/m/w.0_0": [frozenset({0})] * 2,
        "sharded/m/w.32_0": [frozenset({1})] * 2,
    }


def test_select_restore_mode_matches_jax(tmp_path, monkeypatch):
    from torchsnapshot_tpu import manifest as jax_manifest
    from torchsnapshot_tpu_torch import manifest as port_manifest

    digests = _digests_of_take(tmp_path, 4096)
    md = json.load(open(os.path.join(str(tmp_path / "g"), ".snapshot_metadata")))
    monkeypatch.setenv("TSS_TORCH_BCAST_MAX_BYTES", "20000")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_BCAST_MAX_BYTES", "20000")
    modes = []
    for d in md["manifest"].values():
        if d["type"] in ("dict", "list", "OrderedDict", "tuple"):
            continue
        pe, je = port_manifest.entry_from_dict(d), jax_manifest.entry_from_dict(d)
        for flags in [(True, True), (True, False), (False, True), (False, False)]:
            a = bcast.select_restore_mode(pe, None, *flags, digests)
            b = jax_bcast.select_restore_mode(je, None, *flags, digests)
            assert a == b, (d, flags)
            modes.append(a)
        assert bcast.replicated_read_cost(pe, None) == jax_bcast.replicated_read_cost(je, None)
        assert bcast.eligible(pe, None) == jax_bcast.eligible(je, None)
    assert {"bcast", "swarm"} <= set(modes)


# ---------------------------------------------------------------------------
# Two ranks: broadcast and swarm restores (gloo), against the JAX package
# ---------------------------------------------------------------------------


def _serving_tree():
    rng = np.random.default_rng(9)
    return {
        "emb": rng.standard_normal((256, 96)).astype(np.float32),  # 98304 B
        "w": rng.standard_normal((64, 64)).astype(np.float32),  # 16384 B
        "b": rng.standard_normal(64).astype(np.float32),
        "big": rng.integers(-9, 9, (100, 1000)).astype(np.int16),  # 200000 B
    }


_SERVING_KNOBS = {
    "HASH_CHUNK_BYTES": "16384",
    "BCAST_MAX_BYTES": "20000",
}


def _serving_stats(mod_snapshot, mod_bcast, mod_swarm):
    return {
        "bcast_origin": mod_bcast.LAST_RESTORE_BCAST["origin_bytes"],
        "bcast_recv": mod_bcast.LAST_RESTORE_BCAST["recv_bytes"],
        "swarm_origin": mod_swarm.LAST_RESTORE_SWARM["origin_bytes"],
        "swarm_peer": mod_swarm.LAST_RESTORE_SWARM["peer_bytes"],
        "origin": mod_snapshot.LAST_RESTORE_STATS["attribution"]["origin_bytes"],
        "bytes_read": mod_snapshot.LAST_RESTORE_STATS["bytes_read"],
    }


def _port_serving_worker(rank, world_size, root):
    import os as _os

    for k, v in _SERVING_KNOBS.items():
        _os.environ["TSS_TORCH_" + k] = v
    _os.environ.update(_ENV)
    from torchsnapshot_tpu_torch import bcast as b_mod, snapshot as s_mod, swarm as w_mod

    tree = _serving_tree()
    path = _os.path.join(root, "port")
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))}, replicated=["**"])
    out = {}
    for mode, env in [("bcast", {"BCAST_RESTORE": "1", "SWARM_RESTORE": "0"}), ("swarm", {"BCAST_RESTORE": "0", "SWARM_RESTORE": "1"})]:
        for k, v in env.items():
            _os.environ["TSS_TORCH_" + k] = v
        target = tts.StateDict(**{k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in tree.items()})
        tts.Snapshot(path).restore({"m": target}, device="cpu")
        for k, v in tree.items():
            assert np.array_equal(target[k].numpy(), v), (mode, k)
        out[mode] = _serving_stats(s_mod, b_mod, w_mod)
    with open(_os.path.join(root, f"port_{rank}.json"), "w") as f:
        json.dump(out, f)


def _jax_serving_worker(rank, world_size, root):
    import os as _os

    for k, v in _SERVING_KNOBS.items():
        _os.environ["TORCHSNAPSHOT_TPU_" + k] = v
    from torchsnapshot_tpu import bcast as b_mod, snapshot as s_mod, swarm as w_mod

    tree = _serving_tree()
    path = _os.path.join(root, "port")  # the port's snapshot, read by the JAX package
    out = {}
    for mode, env in [("bcast", {"BCAST_RESTORE": "1", "SWARM_RESTORE": "0"}), ("swarm", {"BCAST_RESTORE": "0", "SWARM_RESTORE": "1"})]:
        for k, v in env.items():
            _os.environ["TORCHSNAPSHOT_TPU_" + k] = v
        target = jts.StateDict(**{k: np.zeros_like(v) for k, v in tree.items()})
        jts.Snapshot(path).restore({"m": target})
        for k, v in tree.items():
            assert np.array_equal(np.asarray(target[k]), v), (mode, k)
        out[mode] = _serving_stats(s_mod, b_mod, w_mod)
    with open(_os.path.join(root, f"jax_{rank}.json"), "w") as f:
        json.dump(out, f)


def test_two_rank_bcast_and_swarm_read_what_the_jax_package_reads(tmp_path):
    from torchsnapshot_tpu.test_utils import run_with_processes as jax_run
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_port_serving_worker, 2, args=(str(tmp_path),), process_group=True)
    jax_run(_jax_serving_worker, 2, args=(str(tmp_path),))
    port = [json.load(open(tmp_path / f"port_{r}.json")) for r in range(2)]
    jax_ = [json.load(open(tmp_path / f"jax_{r}.json")) for r in range(2)]
    assert port == jax_
    tree = _serving_tree()
    # Broadcast: the replicated objects up to the cap read once in all;
    # those above it ("emb", "big") by every rank, directly.
    small = sum(v.nbytes for v in tree.values() if v.nbytes <= 20000)
    assert sum(p["bcast"]["bcast_origin"] for p in port) == small
    assert sum(p["bcast"]["bcast_recv"] for p in port) == small
    # Swarm: every chunk of the objects above the cap read once in all.
    above = sum(v.nbytes for v in tree.values() if v.nbytes > 20000)
    assert sum(p["swarm"]["swarm_origin"] for p in port) == above
    assert all(p["swarm"]["swarm_origin"] > 0 for p in port)


def _stalled_reader_worker(rank, world_size, root, mode):
    import os as _os
    import time as _time

    _os.environ.update(_ENV)
    _os.environ["TSS_TORCH_HASH_CHUNK_BYTES"] = "16384"
    _os.environ["TSS_TORCH_BCAST_MAX_BYTES"] = "20000" if mode == "swarm" else str(1 << 20)
    _os.environ["TSS_TORCH_BCAST_READER_DEADLINE_S"] = "0.3"
    _os.environ["TSS_TORCH_SWARM_CHUNK_DEADLINE_S"] = "0.3"
    _os.environ["TSS_TORCH_BCAST_RESTORE"] = "1"
    _os.environ["TSS_TORCH_SWARM_RESTORE"] = "1"
    from torchsnapshot_tpu_torch import bcast as b_mod, swarm as w_mod
    from torchsnapshot_tpu_torch.storage_plugins import fs as fs_mod

    tree = _serving_tree()
    path = _os.path.join(root, "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))}, replicated=["**"])
    if rank == 1:
        # A reader that has gone silent: its data reads stall far past the
        # deadline (the JAX package injects this through faults.py).
        inner = fs_mod.FSStoragePlugin.read

        async def stalled(self, read_io):
            if not read_io.path.startswith("."):
                await asyncio.sleep(3.0)
            await inner(self, read_io)

        fs_mod.FSStoragePlugin.read = stalled
    target = tts.StateDict(**{k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in tree.items()})
    t0 = _time.monotonic()
    tts.Snapshot(path).restore({"m": target}, device="cpu")
    wall = _time.monotonic() - t0
    for k, v in tree.items():
        assert np.array_equal(target[k].numpy(), v), k
    rec = b_mod.LAST_RESTORE_BCAST if mode == "bcast" else w_mod.LAST_RESTORE_SWARM
    with open(_os.path.join(root, f"{mode}_{rank}.json"), "w") as f:
        json.dump({"reelections": rec["reelections"], "wall": wall}, f)


@pytest.mark.parametrize("mode", ["bcast", "swarm"])
def test_silent_reader_is_re_elected_within_the_deadline(tmp_path, mode):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_stalled_reader_worker, 2, args=(str(tmp_path), mode), process_group=True)
    recs = [json.load(open(tmp_path / f"{mode}_{r}.json")) for r in range(2)]
    # Rank 0 gave up on rank 1 after the 0.3 s deadline and read itself,
    # rather than wait for the store's own 300 s timeout.
    assert recs[0]["reelections"] > 0, recs
    assert recs[0]["wall"] < 30.0, recs


# ---------------------------------------------------------------------------
# scrub
# ---------------------------------------------------------------------------


def _scrub_tree():
    shared = np.arange(4096, dtype=np.float32)  # 16 KiB: v2 at a 4 KiB grain
    return {
        "a": shared.copy(),
        "b": shared.copy(),
        "u": np.random.default_rng(1).standard_normal(512).astype(np.float32),
        "v": np.random.default_rng(2).standard_normal(3000).astype(np.float32),
    }


@pytest.mark.parametrize("repair", [False, True])
def test_scrub_reports_equal_the_jax_packages(tmp_path, monkeypatch, repair):
    monkeypatch.setenv("TSS_TORCH_HASH_CHUNK_BYTES", "4096")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_HASH_CHUNK_BYTES", "4096")
    tree = _scrub_tree()
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    tts.Snapshot.take(p, {"s": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    jts.Snapshot.take(j, {"s": jts.StateDict(**tree)})
    assert tts.Snapshot(p).scrub()["clean"] and jts.Snapshot(j).scrub()["clean"]
    for root in (p, j):
        _flip(os.path.join(root, "0/s/a"), 5000)  # chunk 1 of a v2 record; b holds a copy
        _flip(os.path.join(root, "0/s/u"), 7)  # v1, unique: quarantined
        _flip(os.path.join(root, "0/s/v"), 11000)  # v2, unique
    port_report = tts.Snapshot(p).scrub(repair=repair)
    jax_report = jts.Snapshot(j).scrub(repair=repair)
    assert port_report == jax_report
    statuses = {k: e["status"] for k, e in port_report["entries"].items()}
    if repair:
        assert statuses == {"0/s/a": "repaired", "0/s/b": "ok", "0/s/u": "quarantined", "0/s/v": "quarantined"}
        assert "chunk(s) [1] patched from 0/s/b" in port_report["entries"]["0/s/a"]["detail"]
        assert tts.Snapshot(p).scrub()["entries"]["0/s/a"]["status"] == "ok"
        assert os.path.exists(os.path.join(p, "0/s/u.quarantined"))
        with pytest.raises(tts.CheckpointAbortedError) as info:
            tts.Snapshot(p).restore({"s": tts.StateDict(**_zeros_like(tree))}, device="cpu")
        assert info.value.phase == "restore.read" and isinstance(info.value.__cause__, FileNotFoundError)
    else:
        assert statuses == {"0/s/a": "corrupt", "0/s/b": "ok", "0/s/u": "corrupt", "0/s/v": "corrupt"}
        assert port_report["corrupt"] == 3 and not port_report["clean"]


def test_scrub_flags_missing_unverified_and_ftab(tmp_path, monkeypatch):
    monkeypatch.setenv("TSS_TORCH_COMPRESSION", "zlib")
    monkeypatch.setenv("TSS_TORCH_COMPRESSION_FRAME_BYTES", "32768")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_COMPRESSION", "zlib")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_COMPRESSION_FRAME_BYTES", "32768")
    big = np.random.default_rng(0).standard_normal(64 * 1024).astype(np.float32)
    small = np.arange(10, dtype=np.int32)
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    tts.Snapshot.take(p, {"s": tts.StateDict(w=torch.from_numpy(big), x=torch.from_numpy(small))})
    jts.Snapshot.take(j, {"s": jts.StateDict(w=big, x=small)})
    for root in (p, j):
        ftab = os.path.join(root, "0/s/w.ftab")
        table = json.load(open(ftab))
        table["sizes"][0] += 3
        json.dump(table, open(ftab, "w"))
        os.remove(os.path.join(root, "0/s/x"))
    port_report, jax_report = tts.Snapshot(p).scrub(), jts.Snapshot(j).scrub()
    assert port_report == jax_report
    assert port_report["entries"]["0/s/w.ftab"]["status"] == "ftab-mismatch"
    assert port_report["entries"]["0/s/x"]["status"] == "missing"


def _reshard_and_warm_worker(rank, world_size, root):
    import os as _os

    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import swarm as w_mod
    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    _os.environ.update(_ENV)
    _os.environ["TSS_TORCH_HASH_CHUNK_BYTES"] = "65536"
    _os.environ["TSS_TORCH_SWARM_RESTORE"] = "1"
    mesh = DeviceMesh("cpu", list(range(world_size)))
    a = np.random.default_rng(1).standard_normal((256, 512)).astype(np.float32)
    path = _os.path.join(root, "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(a=dtensor_from_numpy(a, mesh, [Shard(0)]))})
    out = {}
    _os.environ["TSS_TORCH_READ_CACHE_DIR"] = _os.path.join(root, f"cache{rank}")
    for run in ("cold", "warm"):
        sd = tts.StateDict(a=dtensor_from_numpy(np.zeros_like(a), mesh, [Shard(1)]))
        tts.Snapshot(path).restore({"m": sd}, device="cpu")
        want = dtensor_from_numpy(a, mesh, [Shard(1)]).to_local()
        assert torch.equal(sd["a"].to_local(), want), run
        rec = w_mod.LAST_RESTORE_SWARM
        out[run] = {k: rec[k] for k in ("origin_bytes", "peer_bytes", "cache_bytes", "chunks")}
    with open(_os.path.join(root, f"r{rank}.json"), "w") as f:
        json.dump(out, f)


def test_need_aware_swarm_reshard_and_a_warm_host(tmp_path):
    """Saved row-sharded, restored column-sharded on two ranks: every chunk
    is needed by both, read once from the origin in all and traded; the
    second restore serves every chunk from each rank's sparse cache."""
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_reshard_and_warm_worker, 2, args=(str(tmp_path),), process_group=True)
    recs = [json.load(open(tmp_path / f"r{r}.json")) for r in range(2)]
    assert sum(r["cold"]["origin_bytes"] for r in recs) == 256 * 512 * 4
    assert all(r["cold"]["peer_bytes"] > 0 for r in recs)
    for r in recs:
        assert r["warm"]["origin_bytes"] == r["warm"]["peer_bytes"] == 0, r
        assert r["warm"]["cache_bytes"] == 256 * 512 * 4, r


# ---------------------------------------------------------------------------
# The read cache's own rules (modelled on tests/test_read_cache.py)
# ---------------------------------------------------------------------------


class _CountingMemory:
    """An origin that counts its reads (optionally slow)."""

    def __init__(self, delay: float = 0.0):
        from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

        self.inner = MemoryStoragePlugin()
        self.reads = 0
        self.delay = delay

    def make(self):
        counter = self

        class Plugin(type(self.inner)):
            async def read(self, read_io):
                counter.reads += 1
                if counter.delay:
                    await asyncio.sleep(counter.delay)
                await type(counter.inner).read(self, read_io)

        plugin = Plugin()
        plugin.objects = self.inner.objects
        return plugin


def _make_cache(tmp_path, max_bytes=None, delay=0.0):
    origin = _CountingMemory(delay)
    cache = port_cache.CachedStoragePlugin(
        origin.make(), origin_id="mem", cache_dir=str(tmp_path / "c"), max_bytes=max_bytes
    )
    return cache, origin


def _read(cache, path, rng=None):
    rio = ReadIO(path=path, byte_range=rng)
    asyncio.new_event_loop().run_until_complete(cache.read(rio))
    return bytes(rio.buf)


def test_cache_concurrent_readers_share_one_origin_fetch(tmp_path):
    cache, origin = _make_cache(tmp_path, delay=0.01)
    origin.inner.objects["obj"] = b"z" * 4096

    async def both():
        a, b = ReadIO(path="obj"), ReadIO(path="obj")
        await asyncio.gather(cache.read(a), cache.read(b))
        return bytes(a.buf), bytes(b.buf)

    assert asyncio.new_event_loop().run_until_complete(both()) == (b"z" * 4096,) * 2
    assert origin.reads == 1


def test_cache_evicts_least_recently_used_past_its_budget(tmp_path):
    import time as _time

    cache, origin = _make_cache(tmp_path, max_bytes=2500)
    for name in ("hot", "cold", "new"):
        origin.inner.objects[name] = name[0].encode() * 1000
    _read(cache, "hot")
    _time.sleep(0.02)
    _read(cache, "cold")
    _time.sleep(0.02)
    _read(cache, "hot")  # more recent than cold
    _time.sleep(0.02)
    _read(cache, "new")  # over budget: cold goes
    assert sum(sz for _, sz, _ in cache._scan()) <= 2500
    n = origin.reads
    assert _read(cache, "hot") == b"h" * 1000 and origin.reads == n
    assert _read(cache, "cold") == b"c" * 1000 and origin.reads == n + 1


def test_cache_write_through_drops_the_path_entry(tmp_path):
    from torchsnapshot_tpu_torch.io_types import WriteIO

    cache, origin = _make_cache(tmp_path)
    origin.inner.objects["obj"] = b"old"
    _read(cache, "obj")
    asyncio.new_event_loop().run_until_complete(cache.write(WriteIO(path="obj", buf=b"newer")))
    assert _read(cache, "obj") == b"newer"


def test_cache_populate_failure_is_fail_open(tmp_path):
    cache, origin = _make_cache(tmp_path)
    origin.inner.objects["obj"] = b"k" * 100

    def boom(entry, data):
        raise OSError("disk full")

    cache._write_entry = boom
    assert _read(cache, "obj") == b"k" * 100
    assert _read(cache, "obj") == b"k" * 100
    assert origin.reads == 2


def test_cache_sparse_entry_never_serves_a_whole_object(tmp_path):
    from torchsnapshot_tpu_torch import hashing

    grain = 4096
    data = np.random.default_rng(2).integers(0, 256, 3 * grain, np.uint8).tobytes()
    cache, origin = _make_cache(tmp_path)
    origin.inner.objects["obj"] = data
    rec = hashing.digest_of_bytes(data, grain, True)
    cache.attach_digest_index({"obj": (len(data), hashing.record_cache_key(rec), hashing.record_crc(rec), hashing.record_chunk_info(rec))})
    assert _read(cache, "obj", (0, grain)) == data[:grain]
    n = origin.reads
    assert _read(cache, "obj", (10, 100)) == data[10:100] and origin.reads == n  # sparse hit
    assert _read(cache, "obj") == data and origin.reads == n + 1  # not served sparse
    assert _read(cache, "obj") == data and origin.reads == n + 1  # now whole


def test_find_read_cache_walks_inner_links(tmp_path):
    cache, _ = _make_cache(tmp_path)

    class Wrapper:
        def __init__(self, inner):
            self.inner = inner

    assert port_cache.find_read_cache(Wrapper(Wrapper(cache))) is cache
    assert port_cache.find_read_cache(Wrapper(None)) is None
    assert port_cache.find_read_cache(FSStoragePlugin(str(tmp_path))) is None


def test_cached_restore_of_slabs_with_large_members_reads_no_origin_bytes(tmp_path, monkeypatch):
    """A slab whose members each cover its hash chunks only in part: over a
    read cache the restore reads the slab whole (as the JAX package merges
    it), so the second restore is served from the cache alone."""
    monkeypatch.setenv("TSS_TORCH_ENABLE_BATCHING", "1")
    monkeypatch.setenv("TSS_TORCH_HASH_CHUNK_BYTES", str(1 << 20))
    rng = np.random.default_rng(12)
    tree = {f"t{i}": rng.standard_normal(384 * 1024).astype(np.float32) for i in range(3)}  # 1.5 MiB each
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    assert any(loc.startswith("batched/") for loc in json.load(open(os.path.join(path, ".checksums.0"))))
    monkeypatch.setenv("TSS_TORCH_READ_CACHE_DIR", str(tmp_path / "cache"))
    for expect_origin in (True, False):
        _assert_tree_equal(_port_restore(path, tree), tree)
        origin = port_snapshot.LAST_RESTORE_STATS["attribution"]["origin_bytes"]
        assert (origin > 0) == expect_origin, origin

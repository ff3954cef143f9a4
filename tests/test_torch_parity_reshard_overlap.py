"""Minimal-byte elastic reshard over the port, against
``tests/test_reshard_overlap.py``: a reshard fetches only the rows each
target overlaps; those ranged reads verify at the sidecars' chunk grain;
chunk-aligned sub-ranges populate the read cache and a warm repeat reads
no origin byte; on two ranks, a range both ranks need is read from the
origin once and traded, and disjoint needs stay direct reads.

The JAX package writes a ``[16, 512]`` float32 array column-sharded over 4
of its CPU devices (a 4 KiB hash grain); the port plans and restores it.
The two-rank cases run on gloo ranks, with the port's own column-sharded
take restored by the JAX package too."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.io_preparers.sharded_array import ShardedArrayIOPreparer as JPreparer
from torchsnapshot_tpu.scheduler import ReadVerificationError as JReadVerificationError
from torchsnapshot_tpu.utils import knobs as jknobs
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import snapshot as tsnapshot
from torchsnapshot_tpu_torch import telemetry as ttelemetry
from torchsnapshot_tpu_torch.io_preparers.sharded_array import ShardedArrayIOPreparer as TPreparer
from torchsnapshot_tpu_torch.scheduler import ReadVerificationError
from torchsnapshot_tpu_torch.storage_plugins import fs as tfs
from torchsnapshot_tpu_torch.utils import knobs as tknobs

GRAIN = 4096
SHAPE = (16, 512)


def _host():
    return np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32)


def _jax_col_sharded_take(path):
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    src = jax.device_put(jnp.asarray(_host()), NamedSharding(mesh, P(None, "x")))
    with jknobs.override_hash_chunk_bytes(GRAIN):
        jts.Snapshot.take(path, {"s": jts.StateDict(w=src)})
    return path


@pytest.fixture
def jax_snapshot(tmp_path):
    return _jax_col_sharded_take(str(tmp_path / "ckpt"))


def _spy_reads(monkeypatch):
    reads = []
    inner = tfs.FSStoragePlugin.read

    async def spying(self, read_io):
        await inner(self, read_io)
        if "sharded/" in read_io.path:
            b, e = read_io.byte_range
            reads.append((read_io.path, e - b))

    monkeypatch.setattr(tfs.FSStoragePlugin, "read", spying)
    return reads


def test_partial_overlap_reads_only_the_overlap_rows(jax_snapshot):
    """Rows [0, 8) of every column: half of each saved shard, in both
    packages' plans."""
    tentry = tts.Snapshot(jax_snapshot).get_manifest()["0/s/w"]
    jentry = jts.Snapshot(jax_snapshot).get_manifest()["0/s/w"]
    assert tentry.type == "sharded_array" and len(tentry.shards) == 4
    treqs = TPreparer.prepare_read(tentry, [(torch.zeros(8, 512), [0, 0], [8, 512])])
    jreqs = JPreparer.prepare_read(jentry, [(np.zeros((8, 512), np.float32), [0, 0], [8, 512])])
    shard_bytes = 16 * 128 * 4
    assert [(r.path, tuple(r.byte_range)) for r in treqs] == [(r.path, tuple(r.byte_range)) for r in jreqs]
    assert all(tuple(r.byte_range) == (0, shard_bytes // 2) for r in treqs)


def test_restore_reads_each_byte_once_and_attributes_it(jax_snapshot, monkeypatch):
    reads = _spy_reads(monkeypatch)
    tgt = tts.StateDict(w=torch.zeros(SHAPE))
    tts.Snapshot(jax_snapshot).restore({"s": tgt}, device="cpu")
    assert tgt["w"].numpy().tobytes() == _host().tobytes()
    total = sum(n for _, n in reads)
    assert total <= 1.1 * _host().nbytes
    assert tsnapshot.LAST_RESTORE_STATS["attribution"]["origin_bytes"] == total


def _flip(path, loc, offset):
    with open(os.path.join(path, loc), "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def test_ranged_reads_verify_at_chunk_granularity_as_in_the_jax_package(jax_snapshot, tmp_path):
    """A flipped byte inside chunk 1 of the first saved shard: the 4 KiB
    budget's chunk-aligned ranged reads catch it under ``VERIFY_READS=all``
    in both packages (each on its own copy)."""
    jcopy = str(tmp_path / "jcopy")
    shutil.copytree(jax_snapshot, jcopy)
    for path in (jax_snapshot, jcopy):
        loc = tts.Snapshot(path).get_manifest()["0/s/w"].shards[0].tensor.location
        _flip(path, loc, GRAIN + 17)
    with tknobs.override_verify_reads("all"), tknobs.override_memory_budget_bytes(4096):
        with pytest.raises(Exception) as port_err:
            tts.Snapshot(jax_snapshot).restore({"s": tts.StateDict(w=torch.zeros(SHAPE))}, device="cpu")
    with jknobs.override_verify_reads("all"), jknobs.override_memory_budget_bytes(4096):
        with pytest.raises(Exception) as jax_err:
            jts.Snapshot(jcopy).restore({"s": jts.StateDict(w=np.zeros(SHAPE, np.float32))})

    def chain(e):
        out = []
        while e is not None:
            out.append(type(e))
            e = e.__cause__
        return out

    assert ReadVerificationError in chain(port_err.value)
    assert JReadVerificationError in chain(jax_err.value)
    assert type(port_err.value).__name__ == type(jax_err.value).__name__


def test_ranged_reads_populate_and_hit_the_cache(jax_snapshot, tmp_path, monkeypatch):
    """The cold restore's ranged misses populate the cache's sub-range tier
    (counted as servable range misses, no bypass); the warm one reads no
    origin byte."""
    reads = _spy_reads(monkeypatch)

    def restore_once():
        tm = ttelemetry.Telemetry()
        tgt = tts.StateDict(w=torch.zeros(SHAPE))
        tts.Snapshot(jax_snapshot).restore({"s": tgt}, device="cpu", _telemetry=tm)
        assert tgt["w"].numpy().tobytes() == _host().tobytes()
        return tm.metrics.as_dict()

    with tknobs.override_read_cache_dir(str(tmp_path / "cache")), tknobs.override_memory_budget_bytes(4096):
        cold = restore_once()
        assert reads
        reads.clear()
        warm = restore_once()
    assert reads == []
    assert cold.get("cache.range_populates", 0) > 0, cold
    assert cold.get("cache.range_misses", 0) > 0, cold
    assert cold.get("cache.bypass_reads", 0) == 0, cold
    assert warm.get("cache.range_misses", 0) in (0, None) or warm.get("cache.hits", 0) > 0, warm


# ---------------------------------------------------------------------------
# Two ranks: the need-aware swarm exchange
# ---------------------------------------------------------------------------


def _fleet_worker(rank, world_size, root, target):
    """The port takes the array column-sharded over two ranks, then
    restores it with the swarm on: onto a ``(2, 1)`` mesh as
    ``(Replicate(), Shard(1))`` (replicated across the ranks, sharded over
    an axis within each: both ranks need every byte, as the JAX test's
    ``P(None, "b")`` over two processes of two devices), or row-sharded
    (disjoint needs)."""
    import os as _os

    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch import swarm as swarm_mod
    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    _os.environ["TSS_TORCH_HASH_CHUNK_BYTES"] = str(GRAIN)
    _os.environ["TSS_TORCH_DEDUP_DIGESTS"] = "1"
    mesh = DeviceMesh("cpu", list(range(world_size)))
    host = _host()
    path = _os.path.join(root, "ckpt")
    tts.Snapshot.take(path, {"s": tts.StateDict(w=dtensor_from_numpy(host, mesh, [Shard(1)]))})
    if target == "replicated":
        tmesh = DeviceMesh("cpu", [[0], [1]], mesh_dim_names=("a", "b"))
        placements = [Replicate(), Shard(1)]
    else:
        tmesh, placements = mesh, [Shard(0)]
    tgt = tts.StateDict(w=dtensor_from_numpy(np.zeros_like(host), tmesh, placements))
    with tknobs.override_swarm_restore(True):
        tts.Snapshot(path).restore({"s": tgt}, device="cpu")
    assert torch.equal(tgt["w"].to_local(), dtensor_from_numpy(host, tmesh, placements).to_local())
    d = swarm_mod.LAST_RESTORE_SWARM
    rec = {k: d[k] for k in ("objects", "chunks", "chunks_origin", "chunks_peer", "chunks_cache", "peer_chunks_verified", "origin_bytes")}
    rec["origin_reads"] = [list(x) for x in d["origin_reads"]]
    with open(_os.path.join(root, f"{target}_{rank}.json"), "w") as f:
        json.dump(rec, f)


@pytest.mark.parametrize("target", ["replicated", "disjoint"])
def test_two_rank_reshard_reads_each_overlap_once(tmp_path, target):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_fleet_worker, 2, args=(str(tmp_path), target), process_group=True)
    recs = [json.load(open(tmp_path / f"{target}_{r}.json")) for r in range(2)]
    payload = int(np.prod(SHAPE)) * 4
    assert sum(r["origin_bytes"] for r in recs) == payload, recs
    if target == "replicated":
        reads = [tuple(x) for r in recs for x in r["origin_reads"]]
        assert len(reads) == len(set(reads)) == recs[0]["chunks"], recs
        for r in recs:
            assert r["objects"] == 2
            assert r["chunks"] == r["chunks_origin"] + r["chunks_peer"] + r["chunks_cache"]
            assert r["chunks_peer"] > 0 and r["peer_chunks_verified"] == r["chunks_peer"]
            assert r["origin_reads"]
    else:
        for r in recs:
            assert r["chunks_peer"] == 0
            assert r["origin_bytes"] <= 1.1 * payload / 2
    # The port's take restores through the JAX package into a row-sharded
    # layout on its 8 devices.
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("x",))
    live = jax.device_put(jnp.zeros(SHAPE, jnp.float32), NamedSharding(mesh, P("x")))
    tgt = jts.StateDict(w=live)
    jts.Snapshot(str(tmp_path / "ckpt")).restore({"s": tgt})
    assert np.asarray(tgt["w"]).tobytes() == _host().tobytes()

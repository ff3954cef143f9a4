"""Budgeted reads of sharded entries over the port, against
``tests/test_sharded_read_budget.py``: under a byte budget, the read plan
of a sharded entry fetches budget-sized runs of whole rows (one row when
a row is wider than the budget), never whole saved shards; ``read_object``
and ``restore`` keep every data read within the budget, into a target of
another layout too, and compose with shards subdivided at the save.

The JAX package writes a ``[64, 32]`` float32 array row-sharded over its 8
CPU devices; both packages plan and read it. The port's sharded targets
are DTensors on two gloo ranks, and its own subdivided take comes back
through the JAX package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.io_preparers.sharded_array import ShardedArrayIOPreparer as JPreparer
from torchsnapshot_tpu.storage_plugins import fs as jfs
from torchsnapshot_tpu.utils import knobs as jknobs
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.io_preparers.sharded_array import ShardedArrayIOPreparer as TPreparer
from torchsnapshot_tpu_torch.storage_plugins import fs as tfs

SHAPE = (64, 32)


def _host():
    return np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)


def _jax_take(path, max_shard=None):
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("x",))
    arr = jax.device_put(jnp.asarray(_host()), NamedSharding(mesh, P("x")))
    if max_shard is None:
        jts.Snapshot.take(path, {"s": jts.StateDict(w=arr)})
    else:
        with jknobs.override_max_shard_size_bytes(max_shard):
            jts.Snapshot.take(path, {"s": jts.StateDict(w=arr)})
    return path


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    return _jax_take(str(tmp_path_factory.mktemp("budget") / "ckpt"))


def _spy(monkeypatch, mod):
    """The byte count of each data read (not ``.snapshot_metadata``)."""
    sizes = []
    inner = mod.FSStoragePlugin.read

    async def spying(self, read_io):
        await inner(self, read_io)
        if "sharded/" in read_io.path and read_io.byte_range is not None:
            sizes.append(read_io.byte_range[1] - read_io.byte_range[0])

    monkeypatch.setattr(mod.FSStoragePlugin, "read", spying)
    return sizes


def _plans(path, budget):
    """Both packages' read plans of the whole entry into one target."""
    jentry = jts.Snapshot(path).get_manifest()["0/s/w"]
    tentry = tts.Snapshot(path).get_manifest()["0/s/w"]
    jreqs = JPreparer.prepare_read(jentry, [(np.zeros(SHAPE, np.float32), [0, 0], list(SHAPE))], buffer_size_limit_bytes=budget)
    treqs = TPreparer.prepare_read(tentry, [(torch.zeros(SHAPE), [0, 0], list(SHAPE))], buffer_size_limit_bytes=budget)
    # A whole-shard read carries no range in the JAX package; the port's
    # reads always carry theirs (each 8 x 32 float32 shard is 1024 bytes).
    return (
        [(r.path, tuple(r.byte_range)) for r in treqs],
        [(r.path, tuple(r.byte_range) if r.byte_range is not None else (0, 1024)) for r in jreqs],
    )


@pytest.mark.parametrize("budget,n_reads,max_bytes", [(256, 32, 256), (1, 64, 128), (None, 8, 1024)], ids=["budget", "one_row", "unbudgeted"])
def test_read_plan_splits_to_the_budget_as_in_the_jax_package(jax_snapshot, budget, n_reads, max_bytes):
    tplan, jplan = _plans(jax_snapshot, budget)
    assert tplan == jplan
    assert len(tplan) == n_reads
    for _, (b, e) in tplan:
        assert e - b <= max_bytes and (e - b) % (32 * 4) == 0


def test_read_object_keeps_every_read_within_the_budget(jax_snapshot, monkeypatch):
    tsizes, jsizes = _spy(monkeypatch, tfs), _spy(monkeypatch, jfs)
    got = tts.Snapshot(jax_snapshot).read_object("0/s/w", memory_budget_bytes=256, device="cpu")
    jgot = jts.Snapshot(jax_snapshot).read_object("0/s/w", memory_budget_bytes=256)
    assert got.numpy().tobytes() == np.asarray(jgot).tobytes() == _host().tobytes()
    assert tsizes and max(tsizes) <= 256
    assert sorted(tsizes) == sorted(jsizes)


def test_budgeted_reads_compose_with_a_subdivided_save(tmp_path):
    path = _jax_take(str(tmp_path / "sub"), max_shard=512)
    assert len(tts.Snapshot(path).get_manifest()["0/s/w"].shards) == 16
    got = tts.Snapshot(path).read_object("0/s/w", memory_budget_bytes=200, device="cpu")
    assert got.numpy().tobytes() == _host().tobytes()


def _two_rank_worker(rank, world_size, jax_path, root):
    """(a) ``read_object`` into a column-sharded DTensor under a 300-byte
    budget; (b) a restore into a row-sharded DTensor under a 512-byte
    process budget, every data read within it; (c) a take subdivided at
    512 bytes per shard piece, for the JAX package to read back."""
    import os as _os

    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    host = _host()
    mesh = DeviceMesh("cpu", list(range(world_size)))
    live = dtensor_from_numpy(np.zeros_like(host), mesh, [Shard(1)])
    tts.Snapshot(jax_path).read_object("0/s/w", obj_out=live, memory_budget_bytes=300)
    want = dtensor_from_numpy(host, mesh, [Shard(1)]).to_local()
    assert torch.equal(live.to_local(), want)

    sizes = []
    inner = tfs.FSStoragePlugin.read

    async def spying(self, read_io):
        await inner(self, read_io)
        if "sharded/" in read_io.path and read_io.byte_range is not None:
            sizes.append(read_io.byte_range[1] - read_io.byte_range[0])

    tfs.FSStoragePlugin.read = spying
    _os.environ["TSS_TORCH_PER_RANK_MEMORY_BUDGET_BYTES"] = "512"
    tgt = tts.StateDict(w=dtensor_from_numpy(np.zeros_like(host), mesh, [Shard(0)]))
    tts.Snapshot(jax_path).restore({"s": tgt}, device="cpu")
    del _os.environ["TSS_TORCH_PER_RANK_MEMORY_BUDGET_BYTES"]
    tfs.FSStoragePlugin.read = inner
    assert torch.equal(tgt["w"].to_local(), dtensor_from_numpy(host, mesh, [Shard(0)]).to_local())
    assert sizes and max(sizes) <= 512, sizes

    _os.environ["TSS_TORCH_MAX_SHARD_SIZE_BYTES"] = "512"
    tts.Snapshot.take(_os.path.join(root, "port_sub"), {"s": tts.StateDict(w=dtensor_from_numpy(host, mesh, [Shard(0)]))})


def test_sharded_targets_and_a_subdivided_port_take(jax_snapshot, tmp_path):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_two_rank_worker, 2, args=(jax_snapshot, str(tmp_path)), process_group=True)
    port_sub = str(tmp_path / "port_sub")
    assert len(jts.Snapshot(port_sub).get_manifest()["0/s/w"].shards) == 8
    got = jts.Snapshot(port_sub).read_object("0/s/w", memory_budget_bytes=200)
    assert np.asarray(got).tobytes() == _host().tobytes()
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("x",))
    live = jax.device_put(jnp.zeros(SHAPE, jnp.float32), NamedSharding(mesh, P(None, "x")))
    got = jts.Snapshot(port_sub).read_object("0/s/w", obj_out=live, memory_budget_bytes=300)
    assert np.asarray(got).tobytes() == _host().tobytes()

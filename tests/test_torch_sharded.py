"""Multi-rank take and restore of DTensor state, against the JAX package.

Ranks are spawned processes on the CPU (gloo, CPU DTensors), at most 3 per
spawn. Bits are compared through ``view(torch.uint8)`` / ``view(np.uint8)``.

- the port at 2 ranks, restored by the JAX package into ``NamedSharding``s
  with other specs on the 8 CPU devices;
- a JAX 8-device take restored by the port at 1, 2 and 3 ranks into
  DTensors, and the port's 2-rank take restored by the port at 1 and 3
  ranks (N -> M);
- the merged ``ShardedArrayEntry`` and the shard object files, identical to
  what the JAX package writes for the same global arrays and rectangles;
- two ranks holding different plain tensors at one path, with no
  clobbering (each rank used to write ``0/<path>``);
- a 2-rank ``async_take`` followed by in-place mutation;
- one rank failing in planning or in the write: ``CheckpointAbortedError``
  on every rank, naming the rank and phase, and no ``.snapshot_metadata``;
- ``verify() == {}``.
"""

import json
import os

import numpy as np
import pytest
import torch

_ENV = {"TSS_TORCH_DEDUP_DIGESTS": "1", "TORCHSNAPSHOT_TPU_DEDUP_DIGESTS": "1"}


def _globals():
    """The global arrays every rank and the JAX side agree on (from a seed)."""
    rng = np.random.default_rng(0)
    import ml_dtypes

    return {
        # even: cross-package restores on 8 devices
        "w": rng.standard_normal((8, 16)).astype(ml_dtypes.bfloat16),
        "v": rng.integers(-100, 100, (16, 8)).astype(np.int32),
        # uneven and tiny: torch.chunk sizes, an empty shard
        "odd": rng.standard_normal((7, 5)).astype(np.float64),
        "tiny": rng.integers(0, 255, (1, 3)).astype(np.uint8),
        "rep": rng.standard_normal((4,)).astype(np.float32),
        "rep2d": rng.standard_normal((6, 4)).astype(np.float32),
    }


def _placements(kind):
    from torch.distributed.tensor import Replicate, Shard

    if kind == "save":
        return {"w": [Shard(0)], "v": [Shard(1)], "odd": [Shard(0)], "tiny": [Shard(0)], "rep": [Replicate()]}
    return {"w": [Shard(1)], "v": [Shard(0)], "odd": [Shard(1)], "tiny": [Shard(1)], "rep": [Replicate()]}


def _bytes(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def _np_bytes(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _assert_local_equals(dt, global_array, mesh, placements):
    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    want = dtensor_from_numpy(global_array, mesh, placements).to_local()
    assert dt.to_local().dtype == want.dtype
    assert torch.equal(_bytes(dt.to_local()), _bytes(want))


def _targets(mesh, kind, names):
    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    g = _globals()
    pl = _placements(kind)
    return {k: dtensor_from_numpy(np.zeros_like(g[k]), mesh, pl[k]) for k in names}


class _Unpicklable:
    def __reduce__(self):
        raise RuntimeError("cannot pickle this rank's object")


class _BrokenState:
    def state_dict(self):
        raise RuntimeError("state_dict failed on this rank")

    def load_state_dict(self, sd):
        pass


def _expect_abort(fn, rank, bad_rank, phase, path):
    from torchsnapshot_tpu_torch.snapshot import CheckpointAbortedError

    with pytest.raises(CheckpointAbortedError) as info:
        fn()
    e = info.value
    assert (e.rank, e.phase) == (bad_rank, phase), (e.rank, e.phase, str(e))
    assert e.__cause__ is not None
    if rank == bad_rank and phase == "write":
        assert "cannot pickle" in repr(e.__cause__)
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


# ---------------------------------------------------------------------------
# The 2-rank port side
# ---------------------------------------------------------------------------


def _port_two_ranks(rank, world_size, root, jax_path):
    os.environ.update(_ENV)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy
    from torchsnapshot_tpu_torch.utils import knobs

    mesh = DeviceMesh("cpu", list(range(world_size)))
    mesh2d = DeviceMesh("cpu", [[0, 1]])  # (1, 2): rank 1 is a replica
    g = _globals()
    pl = _placements("save")

    def state():
        sd = {k: dtensor_from_numpy(g[k], mesh, pl[k]) for k in pl}
        sd["rep2d"] = dtensor_from_numpy(g["rep2d"], mesh2d, [Shard(0), Replicate()])
        sd["mine"] = torch.arange(5, dtype=torch.float32) + 100 * rank  # per rank, one path
        sd["ddp"] = torch.arange(6, dtype=torch.int64)  # replicated by glob
        sd["step"] = 10 + rank
        return sd

    # Plain take, batching off: the layout the parity test reads.
    sd = state()
    path = os.path.join(root, "plain")
    with knobs.override_batching_enabled(False):
        tts.Snapshot.take(path, {"m": tts.StateDict(sd)}, replicated=["m/ddp"])
    assert tts.Snapshot(path).verify() == {}

    # Same placements, in place.
    tgt = _targets(mesh, "save", pl)
    tgt["rep2d"] = dtensor_from_numpy(np.zeros_like(g["rep2d"]), mesh2d, [Shard(0), Replicate()])
    ptrs = {k: t.to_local().data_ptr() for k, t in tgt.items()}
    tgt["mine"], tgt["ddp"] = torch.zeros(5), torch.zeros(6, dtype=torch.int64)
    restored = tts.StateDict(tgt)
    tts.Snapshot(path).restore({"m": restored}, device="cpu")
    for k in pl:
        assert restored[k].to_local().data_ptr() == ptrs[k]
        _assert_local_equals(restored[k], g[k], mesh, pl[k])
    assert restored["rep2d"].to_local().data_ptr() == ptrs["rep2d"]
    _assert_local_equals(restored["rep2d"], g["rep2d"], mesh2d, [Shard(0), Replicate()])
    assert torch.equal(restored["mine"], torch.arange(5, dtype=torch.float32) + 100 * rank)
    assert torch.equal(restored["ddp"], torch.arange(6, dtype=torch.int64))
    assert restored["step"] == 10 + rank

    # Swapped placements: every target overlaps both saved shards.
    after = _placements("restore")
    restored = tts.StateDict(_targets(mesh, "restore", after))
    tts.Snapshot(path).restore({"m": restored}, device="cpu")
    for k in after:
        _assert_local_equals(restored[k], g[k], mesh, after[k])

    # read_object of a sharded entry: the whole array, from one rank.
    full = tts.Snapshot(path).read_object("0/m/odd", device="cpu")
    assert np.array_equal(full.numpy(), g["odd"])

    # Batched take, then async take with in-place mutation right after.
    with knobs.override_batching_enabled(True):
        tts.Snapshot.take(os.path.join(root, "batched"), {"m": tts.StateDict(state())}, replicated=["m/ddp"])
        sd = state()
        pending = tts.Snapshot.async_take(
            os.path.join(root, "async"), {"m": tts.StateDict(sd)}, replicated=["m/ddp"]
        )
        for k in pl:
            sd[k].to_local().add_(1)
        sd["mine"].add_(1)
        pending.wait()
    for name in ("batched", "async"):
        p = os.path.join(root, name)
        assert tts.Snapshot(p).verify() == {}
        restored = tts.StateDict(_targets(mesh, "restore", after))
        restored["mine"] = torch.zeros(5)
        tts.Snapshot(p).restore({"m": restored}, device="cpu")
        for k in after:
            _assert_local_equals(restored[k], g[k], mesh, after[k])
        assert torch.equal(restored["mine"], torch.arange(5, dtype=torch.float32) + 100 * rank)

    # The JAX package's 8-device take, restored at 2 ranks.
    _restore_jax_take(jax_path, mesh)

    # Failures: one rank fails; every rank raises, naming it.
    bad = os.path.join(root, "bad_write")
    app = {"m": tts.StateDict(x=_Unpicklable() if rank == 1 else 1.5, w=sd["w"])}
    _expect_abort(lambda: tts.Snapshot.take(bad, app), rank, 1, "write", bad)
    bad = os.path.join(root, "bad_plan")
    app = {"m": _BrokenState() if rank == 0 else tts.StateDict(w=sd["w"])}
    _expect_abort(lambda: tts.Snapshot.take(bad, app), rank, 0, "plan", bad)
    bad = os.path.join(root, "bad_async")
    app = {"m": tts.StateDict(x=_Unpicklable() if rank == 0 else 1.5, w=sd["w"])}
    _expect_abort(lambda: tts.Snapshot.async_take(bad, app).wait(), rank, 0, "write", bad)
    # After the failures the ranks still agree: a clean take commits.
    tts.Snapshot.take(os.path.join(root, "after"), {"m": tts.StateDict(w=sd["w"])})
    assert tts.Snapshot(os.path.join(root, "after")).verify() == {}


def _jax_targets_placements():
    from torch.distributed.tensor import Replicate, Shard

    return {"a": [Shard(1)], "b": [Shard(0)], "c": [Replicate()], "d": [Shard(0)], "s": [Replicate()]}


def _jax_globals():
    rng = np.random.default_rng(1)
    import ml_dtypes

    return {
        "a": rng.standard_normal((16, 6)).astype(np.float32),
        "b": rng.standard_normal((4, 16)).astype(ml_dtypes.bfloat16),
        "c": rng.integers(0, 1000, (8, 6)).astype(np.int32),
        "d": rng.integers(0, 2, (8, 2)).astype(np.bool_),
        "s": np.array(3.25, dtype=np.float32),
    }


def _restore_jax_take(jax_path, mesh):
    import torchsnapshot_tpu_torch as tts

    g = _jax_globals()
    pl = _jax_targets_placements()
    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    tgt = {k: dtensor_from_numpy(np.zeros_like(g[k]), mesh, pl[k]) for k in g}
    restored = tts.StateDict(tgt)
    tts.Snapshot(jax_path).restore({"m": restored}, device="cpu")
    for k in g:
        _assert_local_equals(restored[k], g[k], mesh, pl[k])


def _restore_elsewhere(rank, world_size, port_path, jax_path):
    """N -> M: the port's 2-rank take and the JAX 8-device take, restored
    at ``world_size`` ranks with the restore placements."""
    os.environ.update(_ENV)
    from torch.distributed.device_mesh import DeviceMesh

    import torchsnapshot_tpu_torch as tts

    mesh = DeviceMesh("cpu", list(range(world_size)))
    g = _globals()
    after = _placements("restore")
    restored = tts.StateDict(_targets(mesh, "restore", after))
    restored["mine"] = torch.zeros(5)
    tts.Snapshot(port_path).restore({"m": restored}, device="cpu")
    for k in after:
        _assert_local_equals(restored[k], g[k], mesh, after[k])
    if rank < 2:
        assert torch.equal(restored["mine"], torch.arange(5, dtype=torch.float32) + 100 * rank)
    _restore_jax_take(jax_path, mesh)


# ---------------------------------------------------------------------------
# Fixtures: the JAX take, then the spawned ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory, monkeypatch_module):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import torchsnapshot_tpu as jts

    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    root = str(tmp_path_factory.mktemp("sharded"))
    devices = np.array(jax.devices()[:8])
    mesh1 = Mesh(devices, ("x",))
    mesh2 = Mesh(devices.reshape(4, 2), ("x", "y"))
    specs = {
        "a": NamedSharding(mesh1, P("x")),
        "b": NamedSharding(mesh1, P(None, "x")),
        "c": NamedSharding(mesh2, P("x", "y")),
        "d": NamedSharding(mesh2, P("y", None)),
        "s": NamedSharding(mesh1, P()),
    }
    jg = _jax_globals()
    jax_path = os.path.join(root, "jax8")
    jts.Snapshot.take(jax_path, {"m": jts.StateDict({k: jax.device_put(v, specs[k]) for k, v in jg.items()})})
    port_path = os.path.join(root, "port2")
    os.makedirs(port_path)
    run_with_processes(_port_two_ranks, 2, args=(port_path, jax_path), process_group=True)
    return {"root": root, "jax": jax_path, "port": port_path}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    for k, v in _ENV.items():
        mp.setenv(k, v)
    yield mp
    mp.undo()


def test_port_two_rank_cases_pass(snapshots):
    """Every case of the 2-rank spawn (in place, reshard, async with
    mutation, failures on one rank, verify) passed on both ranks."""
    assert os.path.exists(os.path.join(snapshots["port"], "after", ".snapshot_metadata"))
    for bad in ("bad_write", "bad_plan", "bad_async"):
        assert not os.path.exists(os.path.join(snapshots["port"], bad, ".snapshot_metadata"))


def test_per_rank_tensors_at_one_path_do_not_clobber(snapshots):
    import torchsnapshot_tpu as jts

    path = os.path.join(snapshots["port"], "plain")
    meta = json.load(open(os.path.join(path, ".snapshot_metadata")))
    assert meta["world_size"] == 2
    assert meta["manifest"]["0/m/mine"]["location"] == "0/m/mine"
    assert meta["manifest"]["1/m/mine"]["location"] == "1/m/mine"
    assert sorted(f for f in os.listdir(path) if f.startswith(".checksums")) == [".checksums.0", ".checksums.1"]
    for rank in (0, 1):
        got = jts.Snapshot(path).read_object(f"{rank}/m/mine")
        np.testing.assert_array_equal(got, np.arange(5, dtype=np.float32) + 100 * rank)
    # The replicated tensor is written once, by one rank.
    assert meta["manifest"]["0/m/ddp"]["location"] == "replicated/m/ddp"
    assert os.path.exists(os.path.join(path, "replicated", "m", "ddp"))


@pytest.mark.parametrize("take", ["plain", "batched", "async"])
def test_jax_restores_port_take_into_other_shardings(snapshots, take):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import torchsnapshot_tpu as jts

    g = _globals()
    devices = np.array(jax.devices()[:8])
    mesh1 = Mesh(devices, ("x",))
    mesh2 = Mesh(devices.reshape(2, 4), ("x", "y"))
    specs = {"w": NamedSharding(mesh1, P(None, "x")), "v": NamedSharding(mesh2, P("y", "x")), "rep": NamedSharding(mesh1, P())}
    target = {k: jax.device_put(np.zeros_like(g[k]), s) for k, s in specs.items()}
    target["odd"] = np.zeros_like(g["odd"])
    target["tiny"] = np.zeros_like(g["tiny"])
    sd = jts.StateDict(target)
    jts.Snapshot(os.path.join(snapshots["port"], take)).restore({"m": sd})
    for k in ("w", "v", "rep", "odd", "tiny"):
        got = np.asarray(sd[k])
        assert got.dtype == g[k].dtype and got.shape == g[k].shape
        np.testing.assert_array_equal(_np_bytes(got), _np_bytes(g[k]))
        if k in specs:
            assert sd[k].sharding == specs[k]
    np.testing.assert_array_equal(np.asarray(sd["rep2d"]), g["rep2d"])


def test_jax_verifies_port_take(snapshots):
    import torchsnapshot_tpu as jts

    for take in ("plain", "batched", "async"):
        assert jts.Snapshot(os.path.join(snapshots["port"], take)).verify() == {}


@pytest.mark.parametrize("world", [1, 3])
def test_restore_at_other_world_sizes(snapshots, world):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(
        _restore_elsewhere,
        world,
        args=(os.path.join(snapshots["port"], "plain"), snapshots["jax"]),
        process_group=True,
    )


def test_sharded_entries_and_objects_match_jax(snapshots, tmp_path):
    """For the same global arrays cut into the same rectangles, the merged
    ``ShardedArrayEntry`` and every shard object are identical."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.utils import knobs as jknobs
    from torchsnapshot_tpu import manifest as jmanifest

    g = _globals()
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    specs = {"w": NamedSharding(mesh, P("x")), "v": NamedSharding(mesh, P(None, "x"))}
    path = str(tmp_path / "jax2")
    with jknobs.override_batching_enabled(False):
        jts.Snapshot.take(path, {"m": jts.StateDict({k: jax.device_put(g[k], s) for k, s in specs.items()})})
    port = os.path.join(snapshots["port"], "plain")
    jmeta = jts.Snapshot(path).metadata
    pmeta = jts.Snapshot(port).metadata
    for k in specs:
        jentry = jmanifest.get_manifest_for_rank(jmeta, 0)[f"m/{k}"]
        pentry = jmanifest.get_manifest_for_rank(pmeta, 0)[f"m/{k}"]

        def canon(e):
            d = jmanifest.entry_to_dict(e)
            d["shards"] = sorted(d["shards"], key=lambda s: s["offsets"])
            return d

        assert canon(pentry) == canon(jentry)
        assert len(jentry.shards) == 2
        for shard in jentry.shards:
            loc = shard.tensor.location
            with open(os.path.join(path, loc), "rb") as a, open(os.path.join(port, loc), "rb") as b:
                assert a.read() == b.read(), loc

"""The plan cache (``take_plan.py``) and the prepared-take cache
(``prepare_cache.py``) of the port.

- the fingerprint ignores values and changes with each field that shapes
  staging: dtype, shape, strides, device, a DTensor's mesh, placements and
  local shard, the world size, the replicated globs and every
  prepare-affecting knob;
- on 2 ranks a steady-state take hits: no ``all_gather``, and exactly the
  port's pinned store operations; a structure change on one rank only is a
  global miss, with no hang;
- at world size 1 a prepared-take hit with other values restores
  bit-exactly; ``unbind`` drops the tensors a cached take held; a take
  overlapping another of the same structure misses on the busy latch;
- every snapshot a hit wrote (1 and 2 ranks) has the manifest, objects and
  checksum records of the JAX package's take of the same numpy state under
  the same knobs (slab uuids normalised), and the JAX package restores it
  bit for bit;
- ``dryrun_multichip``'s certification passes.
"""

import gc
import os
import threading
import weakref

import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_compression import _normalized_dir

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import prepare_cache
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.io_preparers.sharded_array import DTensorLeaf
from torchsnapshot_tpu_torch.parallel.coordinator import get_coordinator
from torchsnapshot_tpu_torch.take_plan import compute_fingerprint


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_DEDUP_DIGESTS", "1")
    prepare_cache.reset(get_coordinator())
    yield
    prepare_cache.reset(get_coordinator())


def _leaf(placement="shard0", offsets=(0, 0), mesh=(2,), coordinate=(0,)):
    from torch.distributed.tensor import Replicate, Shard

    p = {"shard0": Shard(0), "shard1": Shard(1), "rep": Replicate()}[placement]
    return DTensorLeaf(
        local=torch.zeros(4, 6), global_shape=(8, 6), mesh_shape=mesh, placements=(p,),
        coordinate=coordinate, offsets=list(offsets), sizes=[4, 6],
    )


def _flat(**over):
    base = {
        "m/w": torch.zeros(8, 6, dtype=torch.bfloat16),
        "m/dt": _leaf(),
        "m/n": np.zeros(3, np.float32),
        "m/step": 3,
        "m/obj": ("a", 1),
    }
    base.update(over)
    return base


def test_fingerprint_ignores_values():
    a = compute_fingerprint(_flat(), 2, ["m/n"])
    b = compute_fingerprint(
        _flat(**{"m/w": torch.ones(8, 6, dtype=torch.bfloat16), "m/step": 9, "m/n": np.ones(3, np.float32)}), 2, ["m/n"]
    )
    assert a == b


FIELD_CHANGES = {
    "dtype": lambda: ({"m/w": torch.zeros(8, 6, dtype=torch.float16)}, {}),
    "shape": lambda: ({"m/w": torch.zeros(6, 8, dtype=torch.bfloat16)}, {}),
    "strides": lambda: ({"m/w": torch.zeros(6, 8, dtype=torch.bfloat16).t()}, {}),
    "device": lambda: ({"m/w": torch.zeros(8, 6, dtype=torch.bfloat16, device="meta")}, {}),
    "numpy_dtype": lambda: ({"m/n": np.zeros(3, np.float64)}, {}),
    "leaf_kind": lambda: ({"m/step": "three"}, {}),
    "path": lambda: ({"m/w2": torch.zeros(8, 6, dtype=torch.bfloat16)}, {}),
    "mesh_shape": lambda: ({"m/dt": _leaf(mesh=(2, 1), coordinate=(0, 0))}, {}),
    "placements": lambda: ({"m/dt": _leaf(placement="shard1")}, {}),
    "local_offsets": lambda: ({"m/dt": _leaf(offsets=(4, 0), coordinate=(1,))}, {}),
    "batching": lambda: ({}, {"TSS_TORCH_ENABLE_BATCHING": "1"}),
    "codec": lambda: ({}, {"TSS_TORCH_COMPRESSION": "zlib"}),
    "level": lambda: ({}, {"TSS_TORCH_COMPRESSION": "zlib", "TSS_TORCH_COMPRESSION_LEVEL": "6"}),
    "frame_bytes": lambda: ({}, {"TSS_TORCH_COMPRESSION_FRAME_BYTES": "4096"}),
    "stream_mode": lambda: ({}, {"TSS_TORCH_STREAM_WRITES": "off"}),
    "stream_chunk": lambda: ({}, {"TSS_TORCH_STREAM_CHUNK_BYTES": "1024"}),
    "stream_inflight": lambda: ({}, {"TSS_TORCH_STREAM_INFLIGHT": "2"}),
    "hash_grain": lambda: ({}, {"TSS_TORCH_HASH_CHUNK_BYTES": "4096"}),
    "dedup_digests": lambda: ({}, {"TSS_TORCH_DEDUP_DIGESTS": "auto"}),
    "max_chunk": lambda: ({}, {"TSS_TORCH_MAX_CHUNK_SIZE_BYTES": "64"}),
    "max_shard": lambda: ({}, {"TSS_TORCH_MAX_SHARD_SIZE_BYTES": "64"}),
}


@pytest.mark.parametrize("field", sorted(FIELD_CHANGES))
def test_fingerprint_changes_with_each_field(monkeypatch, field):
    monkeypatch.setenv("TSS_TORCH_COMPRESSION", "none")
    before = compute_fingerprint(_flat(), 2, ["m/n"])
    leaves, env = FIELD_CHANGES[field]()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert compute_fingerprint(_flat(**leaves), 2, ["m/n"]) != before


def test_fingerprint_changes_with_world_size_and_globs():
    before = compute_fingerprint(_flat(), 2, ["m/n"])
    assert compute_fingerprint(_flat(), 4, ["m/n"]) != before
    assert compute_fingerprint(_flat(), 2, ["m/*"]) != before
    assert compute_fingerprint(_flat(), 2, ["m/n", "m/n"]) == before


# ---------------------------------------------------------------------------
# Two ranks (the port's TCPStore coordinator)
# ---------------------------------------------------------------------------


def _count_all_gathers(coord):
    counts = [0]
    original = coord.all_gather_object

    def counting(*args, **kwargs):
        counts[0] += 1
        return original(*args, **kwargs)

    coord.all_gather_object = counting
    return counts


STEPS = (0, 7, 8)


def _rank_values(rank, i):
    """Rank ``rank``'s per-rank state at take ``i``."""
    return {
        "w": np.arange(16, dtype=np.float32) + rank + i,
        "b": np.ones(3, np.float32) * rank,
        "step": STEPS[i],
    }


def _steady_state_worker(rank, world_size, root):
    os.environ["TSS_TORCH_DEDUP_DIGESTS"] = "1"
    os.environ["TSS_TORCH_ENABLE_BATCHING"] = "1"
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod
    from torchsnapshot_tpu_torch.dryrun import cert_store_ops, counting_store_ops
    from torchsnapshot_tpu_torch.parallel.coordinator import get_coordinator

    coord = get_coordinator()
    all_gathers = _count_all_gathers(coord)
    vals = _rank_values(rank, 0)
    w = torch.from_numpy(vals["w"].copy())
    app = {"train": tts.StateDict(w=w, b=torch.from_numpy(vals["b"]), step=0), "repl": tts.StateDict(table=torch.arange(6))}
    tts.Snapshot.take(os.path.join(root, "c0"), app, replicated=["repl/*"])
    assert all_gathers[0] >= 2 and not snapshot_mod.LAST_TAKE_CACHE["plan_cache_hit"]
    for i, kind in enumerate(("sync", "async")):
        all_gathers[0] = 0
        vals = _rank_values(rank, i + 1)
        app["train"]["step"] = vals["step"]
        w.copy_(torch.from_numpy(vals["w"]))  # new values, same tensor
        path = os.path.join(root, f"c{i + 1}")
        with counting_store_ops(coord) as counted:
            if kind == "sync":
                tts.Snapshot.take(path, app, replicated=["repl/*"])
            else:
                pending = tts.Snapshot.async_take(path, app, replicated=["repl/*"])
        ops = dict(counted)
        if kind == "async":
            pending.wait()
        assert snapshot_mod.LAST_TAKE_CACHE["plan_cache_hit"], kind
        assert all_gathers[0] == 0, (kind, all_gathers[0])
        ops.pop("delete", None)
        if kind == "async":
            # The stall window: the preflight and the manifest delta only.
            assert ops == cert_store_ops(rank, world_size), ops
        else:
            # ...and the commit barrier's two phases (their polls vary).
            assert ops["add"] == 2, ops
        snap = tts.Snapshot(path)
        manifest = snap.get_manifest()
        assert manifest[f"{rank}/train/step"].get_value() == vals["step"]
        assert manifest[f"{rank}/repl/table"].location.startswith(("replicated/", "batched/"))
        tgt = {"train": tts.StateDict(w=torch.zeros(16), b=torch.zeros(3), step=-1), "repl": tts.StateDict(table=torch.zeros(6, dtype=torch.int64))}
        snap.restore(tgt, device="cpu")
        assert tgt["train"]["step"] == vals["step"]
        assert torch.equal(tgt["train"]["w"], w) and torch.equal(tgt["repl"]["table"], torch.arange(6))


def _jax_steady_state_worker(rank, world_size, root):
    """The JAX package's takes of the same per-rank numpy states."""
    os.environ["TORCHSNAPSHOT_TPU_DEDUP_DIGESTS"] = "1"
    os.environ["TORCHSNAPSHOT_TPU_ENABLE_BATCHING"] = "1"
    import torchsnapshot_tpu as jts

    for i in range(len(STEPS)):
        vals = _rank_values(rank, i)
        app = {"train": jts.StateDict(w=vals["w"], b=vals["b"], step=vals["step"]), "repl": jts.StateDict(table=np.arange(6))}
        jts.Snapshot.take(os.path.join(root, f"c{i}"), app, replicated=["repl/*"])


def test_two_rank_steady_state_hit_pins_store_ops(tmp_path):
    from torchsnapshot_tpu.test_utils import run_with_processes as run_jax
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_steady_state_worker, 2, args=(str(tmp_path / "port"),), timeout_s=120)
    run_jax(_jax_steady_state_worker, 2, args=(str(tmp_path / "jax"),), timeout_s=120)
    for i in range(len(STEPS)):
        port_dir, jax_dir = str(tmp_path / "port" / f"c{i}"), str(tmp_path / "jax" / f"c{i}")
        assert _normalized_dir(port_dir) == _normalized_dir(jax_dir), f"c{i}"
        snap = jts.Snapshot(port_dir)
        for rank in range(2):
            vals = _rank_values(rank, i)
            for name in ("w", "b"):
                got = np.asarray(snap.read_object(f"{rank}/train/{name}"))
                assert got.dtype == vals[name].dtype and got.tobytes() == vals[name].tobytes(), (i, rank, name)
            assert snap.read_object(f"{rank}/train/step") == vals["step"]
            assert np.array_equal(snap.read_object(f"{rank}/repl/table"), np.arange(6))


def _structure_change_worker(rank, world_size, root):
    os.environ["TSS_TORCH_DEDUP_DIGESTS"] = "1"
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod
    from torchsnapshot_tpu_torch.parallel.coordinator import get_coordinator

    all_gathers = _count_all_gathers(get_coordinator())
    tts.Snapshot.take(os.path.join(root, "c0"), {"s": tts.StateDict(w=torch.arange(8.0))})
    all_gathers[0] = 0
    # Only rank 1's structure changes: every rank must miss, none hang.
    n = 12 if rank == 1 else 8
    tts.Snapshot.take(os.path.join(root, "c1"), {"s": tts.StateDict(w=torch.arange(float(n)))})
    assert not snapshot_mod.LAST_TAKE_CACHE["plan_cache_hit"]
    assert all_gathers[0] >= 2
    tgt = {"s": tts.StateDict(w=torch.zeros(n))}
    tts.Snapshot(os.path.join(root, "c1")).restore(tgt, device="cpu")
    assert torch.equal(tgt["s"]["w"], torch.arange(float(n)))
    # A rank with the plan cache off forces a global miss the same way.
    if rank == 0:
        os.environ["TSS_TORCH_PLAN_CACHE"] = "0"
    tts.Snapshot.take(os.path.join(root, "c2"), {"s": tts.StateDict(w=torch.arange(float(n)))})
    assert not snapshot_mod.LAST_TAKE_CACHE["plan_cache_hit"]


def test_one_rank_structure_change_is_a_global_miss(tmp_path):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_structure_change_worker, 2, args=(str(tmp_path),), timeout_s=120)


# ---------------------------------------------------------------------------
# World size 1: the prepared-take cache
# ---------------------------------------------------------------------------


def _np_state(seed):
    """Numpy arrays from a seed, and primitives; ``t_T`` is taken
    transposed (the port as a strided view)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 16)).astype(np.float32),
        "b": rng.standard_normal(16).astype(ml_dtypes.bfloat16),
        "t_T": rng.standard_normal((8, 12)).astype(np.float32),
        "big": rng.standard_normal((300, 10)).astype(np.float32),
        "step": seed,
        "obj": ("cfg", seed),
    }


def _state(seed):
    np_state = _np_state(seed)
    state = from_numpy_tree({k: v for k, v in np_state.items() if k != "t_T"}, device="cpu")
    state["t"] = torch.from_numpy(np_state["t_T"]).t()  # a strided view
    return state


def _jax_state(seed):
    np_state = _np_state(seed)
    state = {k: v for k, v in np_state.items() if k != "t_T"}
    state["t"] = np.ascontiguousarray(np_state["t_T"].T)
    return state


def _restore_and_check(path, state):
    tgt = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else None) for k, v in state.items()}
    sd = tts.StateDict(tgt)
    tts.Snapshot(path).restore({"m": sd}, device="cpu")
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(sd[k].contiguous().view(torch.uint8), v.contiguous().view(torch.uint8)), k
        else:
            assert sd[k] == v, k


def _jax_restore_and_check(path, state):
    """The JAX package restores the port's snapshot into numpy, bit for bit."""
    sd = jts.StateDict({k: (np.zeros_like(v) if isinstance(v, np.ndarray) else None) for k, v in state.items()})
    jts.Snapshot(path).restore({"m": sd})
    for k, v in state.items():
        if isinstance(v, np.ndarray):
            got = np.asarray(sd[k])
            assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k
        else:
            assert sd[k] == v, k


PREPARED_LAYOUTS = {
    "plain": {},
    "batched": {"ENABLE_BATCHING": "1"},
    "zlib_slabs": {"ENABLE_BATCHING": "1", "COMPRESSION": "zlib"},
    "streamed_framed": {
        "COMPRESSION": "zlib", "COMPRESSION_FRAME_BYTES": "2048",
        "STREAM_CHUNK_BYTES": "3000", "STREAM_WRITES": "on",
        "MAX_CHUNK_SIZE_BYTES": "8000",
    },
}


@pytest.mark.parametrize("layout", sorted(PREPARED_LAYOUTS))
@pytest.mark.parametrize("kind", ["sync", "async"])
def test_prepared_hit_with_other_values_restores_bit_exact(tmp_path, monkeypatch, kind, layout):
    """Each take's snapshot, the hits' too, restores bit-exactly through
    both packages and equals the JAX package's take of the same numpy
    state under the same knobs."""
    for k, v in PREPARED_LAYOUTS[layout].items():
        monkeypatch.setenv("TSS_TORCH_" + k, v)
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_" + k, v)
    hits = []
    for step in range(3):
        state = _state(step)
        path = str(tmp_path / f"s{step}")
        app = {"m": tts.StateDict(state)}
        if kind == "sync":
            tts.Snapshot.take(path, app)
        else:
            tts.Snapshot.async_take(path, app).wait()
        hits.append(snapshot_mod.LAST_TAKE_CACHE["prepared_cache_hit"])
        _restore_and_check(path, state)
        assert tts.Snapshot(path).verify() == {}
        _jax_restore_and_check(path, _jax_state(step))
        jax_path = str(tmp_path / f"jax{step}")
        jts.Snapshot.take(jax_path, {"m": jts.StateDict(_jax_state(step))})
        assert _normalized_dir(path) == _normalized_dir(jax_path), step
    assert hits == [False, True, True]


def test_unbind_drops_the_captured_tensors(tmp_path):
    """After a take, the cached entry holds no tensor: the cache alone
    keeps nothing alive (on the card it would pin the fork's memory)."""
    state = _state(0)
    ref = weakref.ref(state["w"])
    tts.Snapshot.async_take(str(tmp_path / "a"), {"m": tts.StateDict(state)}).wait()
    stats = prepare_cache.stats(get_coordinator())
    assert stats["entries"] == 1
    entry = next(iter(get_coordinator()._prepared_take_cache.values()))
    stagers = [r.buffer_stager for reqs in entry.leaf_index.values() for r in reqs]
    assert stagers and all(getattr(s, "tensor", None) is None for s in stagers if hasattr(s, "tensor"))
    del state
    gc.collect()
    assert ref() is None


def test_overlapping_take_misses_on_the_busy_latch(tmp_path, monkeypatch):
    from torchsnapshot_tpu_torch.storage_plugins import fs

    state = _state(1)
    tts.Snapshot.async_take(str(tmp_path / "a"), {"m": tts.StateDict(state)}).wait()
    gate = threading.Event()
    write = fs.FSStoragePlugin._write_file

    def held_write(self, *args):
        gate.wait(30)
        return write(self, *args)

    monkeypatch.setattr(fs.FSStoragePlugin, "_write_file", held_write)
    first = tts.Snapshot.async_take(str(tmp_path / "b"), {"m": tts.StateDict(state)})
    assert snapshot_mod.LAST_TAKE_CACHE["prepared_cache_hit"]
    second = tts.Snapshot.async_take(str(tmp_path / "c"), {"m": tts.StateDict(state)})
    assert not snapshot_mod.LAST_TAKE_CACHE["prepared_cache_hit"]  # the entry was busy
    gate.set()
    first.wait()
    second.wait()
    for name in ("b", "c"):
        _restore_and_check(str(tmp_path / name), state)


def test_acquire_release_and_lru(monkeypatch):
    coord = get_coordinator()
    monkeypatch.setenv("TSS_TORCH_PREPARED_CACHE_SIZE", "2")

    def entry(key):
        return prepare_cache.PreparedTake(key, {}, {}, {}, [], {})

    keys = [(f"f{i}", "FSStoragePlugin", True) for i in range(3)]
    for k in keys:
        prepare_cache.store(coord, k, entry(k))
        assert prepare_cache.acquire(coord, k) is None  # busy until released
        prepare_cache.release(coord._prepared_take_cache[k])
    assert prepare_cache.stats(coord)["entries"] == 2  # the oldest went
    got = prepare_cache.acquire(coord, keys[2])
    assert got is not None and prepare_cache.acquire(coord, keys[2]) is None
    prepare_cache.release(got)
    prepare_cache.invalidate(coord, keys[2])
    assert prepare_cache.acquire(coord, keys[2]) is None


def test_dryrun_multichip_certifies_the_plan_cache():
    """Two gloo ranks: the dry run's sharded step and restores, then two
    async takes of the (dp=1, tp=2)-sharded state, the second a plan-cache
    and prepared-take hit with the pinned store operations and no
    all_gather, restored bit-exactly."""
    from torchsnapshot_tpu_torch import dryrun

    dryrun.dryrun_multichip(2, device="cpu", timeout_s=240)

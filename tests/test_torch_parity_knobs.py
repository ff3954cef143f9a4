"""The catalog switch, the chain length, the swarm's fan-out and the
broadcast's re-election bound: each knob has the JAX package's effect on
the same inputs (``TSS_TORCH_*`` beside ``TORCHSNAPSHOT_TPU_*``). Their
parsing is held by ``test_torch_capture_modes.py::KNOBS``."""

import json
import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import catalog as jcat
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import catalog as tcat
from torchsnapshot_tpu_torch.convert import from_numpy_tree

FROZEN = np.random.default_rng(0).standard_normal(4000).astype(np.float32)


@pytest.fixture(autouse=True)
def _pinned_and_cold(monkeypatch):
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    tcat._CHAIN_CACHE.clear()
    jcat._CHAIN_CACHE.clear()
    yield
    tcat._CHAIN_CACHE.clear()
    jcat._CHAIN_CACHE.clear()


def _tree(step):
    return {"frozen": FROZEN, "lora": np.full((64,), step, np.float32), "step": step}


def _take(pkg, bucket, step, **kw):
    path = os.path.join(bucket, f"step_{step}")
    if pkg == "jax":
        jts.Snapshot.take(path, {"m": jts.StateDict(_tree(step))}, job="ft", step=step, **kw)
    else:
        tts.Snapshot.take(path, {"m": tts.StateDict(from_numpy_tree(_tree(step), device="cpu"))}, job="ft", step=step, **kw)
    return path


def _catalog_view(pkg, bucket):
    """(records' (name, base, chain_len), chain cache entries, whether the
    steps share the frozen object's inode) of a bucket."""
    cat = (jcat if pkg == "jax" else tcat).Catalog(bucket)
    with cat:
        records = [(r.name, r.base, r.chain_len) for r in cat.load()]
    cache = sorted(v for k, v in (jcat if pkg == "jax" else tcat)._CHAIN_CACHE.items() if k[1] == "ft")
    inodes = {os.stat(os.path.join(bucket, d, "0/m/frozen")).st_ino for d in sorted(os.listdir(bucket)) if d.startswith("step_")}
    return records, cache, len(inodes)


@pytest.mark.parametrize("catalog", [True, False], ids=["catalog_on", "catalog_off"])
def test_catalog_switch_has_the_jax_effect(tmp_path, monkeypatch, catalog):
    """Off, three ``job=`` takes are plain full takes: no record, no base
    (no hard link of the frozen tensor), no chain-cache entry, and the
    ``job=`` restore appends no rollout record."""
    views = {}
    for pkg, prefix in (("jax", "TORCHSNAPSHOT_TPU_"), ("port", "TSS_TORCH_")):
        monkeypatch.setenv(prefix + "CATALOG", "1" if catalog else "0")
        bucket = str(tmp_path / pkg)
        for step in range(3):
            path = _take(pkg, bucket, step)
        if pkg == "jax":
            jts.Snapshot(path).restore({"m": jts.StateDict(_tree(0))}, job="ft")
        else:
            tts.Snapshot(path).restore({"m": tts.StateDict(from_numpy_tree(_tree(0), device="cpu"))}, device="cpu", job="ft")
        rollouts = os.path.join(bucket, ".catalog", "rollouts")
        views[pkg] = _catalog_view(pkg, bucket) + (os.path.isdir(rollouts) and bool(os.listdir(rollouts)),)
    assert views["port"] == views["jax"]
    records, cache, inodes, rollout = views["port"]
    if catalog:
        assert [r[2] for r in records] == [0, 1, 2] and cache and inodes == 1 and rollout
    else:
        assert (records, cache, inodes, rollout) == ([], [], 3, False)


@pytest.mark.parametrize("max_chain_len", [1, 2, 16])
def test_max_chain_len_rebases_as_in_the_jax_package(tmp_path, monkeypatch, max_chain_len):
    """``MAX_CHAIN_LEN=2``: the third delta would be three deep, so the
    fourth take rebases to a full snapshot: chains 0, 1, 2, 0, 1."""
    views = {}
    for pkg, prefix in (("jax", "TORCHSNAPSHOT_TPU_"), ("port", "TSS_TORCH_")):
        monkeypatch.setenv(prefix + "MAX_CHAIN_LEN", str(max_chain_len))
        bucket = str(tmp_path / pkg)
        for step in range(5):
            _take(pkg, bucket, step)
        views[pkg] = _catalog_view(pkg, bucket)
    assert views["port"] == views["jax"]
    chains = [r[2] for r in views["port"][0]]
    assert chains == [min(i, i % (max_chain_len + 1)) for i in range(5)]


# ---------------------------------------------------------------------------
# Two ranks: the broadcast's re-elections and the swarm's fan-out
# ---------------------------------------------------------------------------


def _reelect_worker(rank, world_size, root, pkg, reelect_max):
    """Rank 0's read of one object it was elected to stalls past the reader
    deadline. With re-elections left, rank 1 re-elects; with none, it
    reads that object from the origin at once."""
    import os as _os

    prefix = "TORCHSNAPSHOT_TPU_" if pkg == "jax" else "TSS_TORCH_"
    _os.environ[prefix + "BCAST_RESTORE"] = "1"
    _os.environ[prefix + "BCAST_READER_DEADLINE_S"] = "0.3"
    _os.environ[prefix + "BCAST_REELECT_MAX"] = str(reelect_max)
    if pkg == "jax":
        from torchsnapshot_tpu import bcast as b_mod
    else:
        from torchsnapshot_tpu_torch import bcast as b_mod
    tree = {"w1": np.arange(500, dtype=np.float32), "w2": np.arange(500, 1000).astype(np.float64)}
    path = _os.path.join(root, pkg, str(reelect_max))
    if pkg == "jax":
        jts.Snapshot.take(path, {"app": jts.StateDict(**tree)}, replicated=["app/*"])
        manifest = jts.Snapshot(path).get_manifest()
    else:
        tts.Snapshot.take(path, {"app": tts.StateDict(**from_numpy_tree(tree, device="cpu"))}, replicated=["app/*"])
        manifest = tts.Snapshot(path).get_manifest()
    locs = sorted({getattr(e, "location", None) for e in manifest.values() if getattr(e, "location", None)})
    elected0 = [p for p in locs if b_mod.elect_reader(p, None, world_size) == 0]
    assert elected0
    if rank == 0:
        _os.environ[prefix + "FAULTS"] = "op=read,kind=stall,secs=2,path=" + elected0[0]
    if pkg == "jax":
        tgt = jts.StateDict(w1=np.zeros(500, np.float32), w2=np.zeros(500, np.float64))
        jts.Snapshot(path).restore({"app": tgt})
    else:
        tgt = tts.StateDict(w1=torch.zeros(500), w2=torch.zeros(500, dtype=torch.float64))
        tts.Snapshot(path).restore({"app": tgt}, device="cpu")
    for k, v in tree.items():
        assert np.array_equal(np.asarray(tgt[k]), v), k
    d = b_mod.LAST_RESTORE_BCAST
    with open(_os.path.join(root, f"reelect_{pkg}_{reelect_max}_{rank}.json"), "w") as f:
        json.dump({"reelections": d["reelections"], "direct_fallbacks": d["direct_fallbacks"]}, f)


@pytest.mark.parametrize("reelect_max", [0, 1])
def test_bcast_reelect_max_has_the_jax_effect(tmp_path, reelect_max):
    from torchsnapshot_tpu.test_utils import run_with_processes as jax_run
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_reelect_worker, 2, args=(str(tmp_path), "port", reelect_max), process_group=True)
    jax_run(_reelect_worker, 2, args=(str(tmp_path), "jax", reelect_max))
    got = {
        pkg: [json.load(open(tmp_path / f"reelect_{pkg}_{reelect_max}_{r}.json")) for r in range(2)]
        for pkg in ("port", "jax")
    }
    assert got["port"] == got["jax"]
    peer = got["port"][1]
    if reelect_max == 0:
        assert peer == {"reelections": 0, "direct_fallbacks": 1}
    else:
        assert peer["reelections"] >= 1


def _fanout_worker(rank, world_size, root, pkg, fanout):
    """A swarm restore of one 200,000-byte object cut in 16 KiB chunks;
    each rank's data reads are counted in flight (each held 20 ms)."""
    import asyncio as _asyncio
    import os as _os

    prefix = "TORCHSNAPSHOT_TPU_" if pkg == "jax" else "TSS_TORCH_"
    for k, v in {"HASH_CHUNK_BYTES": "16384", "BCAST_MAX_BYTES": "20000", "SWARM_RESTORE": "1",
                 "BCAST_RESTORE": "0", "SWARM_FANOUT": str(fanout), "DEDUP_DIGESTS": "1"}.items():
        _os.environ[prefix + k] = v
    if pkg == "jax":
        from torchsnapshot_tpu.storage_plugins import fs as fs_mod
    else:
        from torchsnapshot_tpu_torch.storage_plugins import fs as fs_mod
    big = np.random.default_rng(3).integers(-9, 9, (100, 1000)).astype(np.int16)
    path = _os.path.join(root, pkg, str(fanout))
    if pkg == "jax":
        jts.Snapshot.take(path, {"m": jts.StateDict(big=big)}, replicated=["**"])
    else:
        tts.Snapshot.take(path, {"m": tts.StateDict(big=torch.from_numpy(big.copy()))}, replicated=["**"])
    inner = fs_mod.FSStoragePlugin.read
    state = {"now": 0, "most": 0, "reads": 0}

    async def counted(self, read_io):
        if read_io.path.startswith("."):
            return await inner(self, read_io)
        state["now"] += 1
        state["reads"] += 1
        state["most"] = max(state["most"], state["now"])
        try:
            await _asyncio.sleep(0.02)
            return await inner(self, read_io)
        finally:
            state["now"] -= 1

    fs_mod.FSStoragePlugin.read = counted
    if pkg == "jax":
        tgt = jts.StateDict(big=np.zeros_like(big))
        jts.Snapshot(path).restore({"m": tgt})
    else:
        tgt = tts.StateDict(big=torch.zeros(100, 1000, dtype=torch.int16))
        tts.Snapshot(path).restore({"m": tgt}, device="cpu")
    fs_mod.FSStoragePlugin.read = inner
    assert np.array_equal(np.asarray(tgt["big"]), big)
    with open(_os.path.join(root, f"fanout_{pkg}_{fanout}_{rank}.json"), "w") as f:
        json.dump({"most_in_flight": state["most"], "reads": state["reads"]}, f)


@pytest.mark.parametrize("fanout", [1, 8])
def test_swarm_fanout_bounds_origin_reads_in_flight_as_in_the_jax_package(tmp_path, fanout):
    from torchsnapshot_tpu.test_utils import run_with_processes as jax_run
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_fanout_worker, 2, args=(str(tmp_path), "port", fanout), process_group=True)
    jax_run(_fanout_worker, 2, args=(str(tmp_path), "jax", fanout))
    got = {
        pkg: [json.load(open(tmp_path / f"fanout_{pkg}_{fanout}_{r}.json")) for r in range(2)]
        for pkg in ("port", "jax")
    }
    assert got["port"] == got["jax"]
    assert sum(r["reads"] for r in got["port"]) == 13  # each chunk read once in all
    most = max(r["most_in_flight"] for r in got["port"])
    assert most == 1 if fanout == 1 else most > 1

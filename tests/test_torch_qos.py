"""QoS classes end to end on the CPU: a ``qos="background"`` async take
raced by a ``qos="foreground"`` restore, and the cooperative pause points
of broadcast, swarm, cache populates, scrub and gc.

Preemption is made deterministic by holding ``demand_scope(FOREGROUND)``
in the test, never by timing: the drain is paused with QoS on and never
with ``TSS_TORCH_QOS=0``, and its artifact's ``engine`` section says so.
The drained snapshot's manifest, objects and sidecars equal the JAX
package's ``take(qos="background")`` of the same state, and it restores
through the JAX package. Each pause case holds a higher demand under a
short ``TSS_TORCH_QOS_MAX_PAUSE_S``, so the operation records a pause
(the flight recorder's ``engine.pause`` events) and then completes.
"""

import asyncio
import json
import os
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import engine, telemetry
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.storage_plugins.cache import CachedStoragePlugin
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import artifact

_ENV = {
    "TSS_TORCH_DEDUP_DIGESTS": "1",
    "TORCHSNAPSHOT_TPU_DEDUP_DIGESTS": "1",
    "TSS_TORCH_ENABLE_BATCHING": "0",
    "TORCHSNAPSHOT_TPU_ENABLE_BATCHING": "0",
}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in _ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TSS_TORCH_QOS_POLL_S", "0.005")
    monkeypatch.setenv("TSS_TORCH_QOS_MAX_PAUSE_S", "0.05")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        **{f"w{i}": rng.standard_normal((64, 96)).astype(np.float32) for i in range(6)},
        "ids": rng.integers(0, 1000, 50).astype(np.int64),
        "step": 11,
    }


def _zeros(tree):
    return {k: np.zeros_like(v) if isinstance(v, np.ndarray) else 0 for k, v in tree.items()}


def _assert_port_tree(sd, tree):
    for k, v in tree.items():
        got = sd[k]
        if isinstance(v, np.ndarray):
            assert got.dtype == torch.from_numpy(v).dtype and np.array_equal(got.numpy(), v), k
        else:
            assert got == v, k


def _pauses(engine_name, since):
    rec = telemetry.recorder.get_recorder()
    return [e for e in rec.series("engine.pause") if e.get("engine") == engine_name and e["ts"] >= since]


def _metadata(path):
    with open(os.path.join(path, ".snapshot_metadata")) as f:
        md = json.load(f)
    md.pop("version")
    return md


def _files(path):
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), path)
            if not rel.startswith(".telemetry"):
                with open(os.path.join(root, name), "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("qos", ["on", "off"])
def test_background_drain_preempted_by_foreground_restore(tmp_path, monkeypatch, qos):
    monkeypatch.setenv("TSS_TORCH_QOS", "1" if qos == "on" else "0")
    tree, serve = _tree(0), _tree(1)
    serve_path, drain_path, jax_path = (str(tmp_path / n) for n in ("serve", "drain", "jax"))
    tts.Snapshot.take(serve_path, {"m": tts.StateDict(**from_numpy_tree(serve, device="cpu"))})
    with engine.demand_scope(engine.Priority.FOREGROUND):
        pending = tts.Snapshot.async_take(
            drain_path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))}, qos="background"
        )
        target = tts.StateDict(**from_numpy_tree(_zeros(serve), device="cpu"))
        tts.Snapshot(serve_path).restore({"m": target}, device="cpu", qos="foreground")
        _assert_port_tree(target, serve)
    pending.wait()
    with open(os.path.join(drain_path, ".telemetry", "rank_0.json"), "rb") as f:
        section = artifact.parse_artifact(f.read())["engine"]
    if qos == "on":
        assert section["preemptions"] > 0 and section["preempted_wait_s"] > 0
        assert section["pause_intervals"]
    else:
        assert (section["preemptions"], section["preempted_wait_s"], section["pause_intervals"]) == (0, 0.0, [])
    # The drained snapshot is the JAX package's take of the same state.
    jts.Snapshot.take(jax_path, {"m": jts.StateDict(**tree)}, qos="background")
    assert _metadata(drain_path) == _metadata(jax_path)
    assert _files(drain_path) == _files(jax_path)
    back = tts.StateDict(**from_numpy_tree(_zeros(tree), device="cpu"))
    tts.Snapshot(drain_path).restore({"m": back}, device="cpu")
    _assert_port_tree(back, tree)
    jback = jts.StateDict(**_zeros(tree))
    jts.Snapshot(drain_path).restore({"m": jback})
    for k, v in tree.items():
        assert np.array_equal(np.asarray(jback[k]), v) if isinstance(v, np.ndarray) else jback[k] == v


def test_qos_argument_is_parsed_and_scoped(tmp_path):
    path = str(tmp_path / "s")
    with pytest.raises(ValueError, match="unknown QoS class"):
        tts.Snapshot.take(path, {"m": tts.StateDict(x=1)}, qos="urgent")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=1)}, qos=engine.Priority.BACKGROUND)
    assert engine.current_priority() is engine.Priority.NORMAL
    assert engine.get_arbiter().demand_snapshot() == {"BACKGROUND": 0, "NORMAL": 0, "FOREGROUND": 0}


# ----------------------------------------------------------- pause points


def _small_snapshot(path):
    tree = _tree(2)
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    return tree


def test_scrub_pauses_under_higher_demand_then_completes(tmp_path):
    path = str(tmp_path / "s")
    _small_snapshot(path)
    since = time.time()
    with engine.demand_scope(engine.Priority.NORMAL):
        report = tts.Snapshot(path).scrub()
    assert report["clean"] and report["objects"] > 0
    assert _pauses("scrub", since)


def test_gc_pauses_under_higher_demand_then_completes(tmp_path):
    bucket = tmp_path / "b"
    _small_snapshot(str(bucket / "s1"))
    open(bucket / "s1" / "x.tmp.123", "wb").close()  # debris
    since = time.time()
    with engine.demand_scope(engine.Priority.FOREGROUND):
        report = tts.Snapshot.gc(str(bucket), dry_run=False)
    assert report["remove"] == ["s1/x.tmp.123"] and report["removed"] == 1
    assert not os.path.exists(bucket / "s1" / "x.tmp.123")
    assert _pauses("gc", since)


def test_cache_populate_pauses_under_higher_demand_then_completes(tmp_path, monkeypatch):
    monkeypatch.setenv("TSS_TORCH_READ_CACHE_DIR", str(tmp_path / "cache"))
    path = str(tmp_path / "s")
    _small_snapshot(path)
    with open(os.path.join(path, ".checksums.0")) as f:
        digests = json.load(f)
    obj = "0/m/w0"
    with open(os.path.join(path, obj), "rb") as f:
        data = f.read()
    cache = CachedStoragePlugin(FSStoragePlugin(path), origin_id="origin", cache_dir=str(tmp_path / "cache"))
    tts.Snapshot._attach_cache_digests(cache, digests)
    loop = asyncio.new_event_loop()
    try:
        since = time.time()
        with engine.demand_scope(engine.Priority.FOREGROUND):
            loop.run_until_complete(cache.populate_object(obj, data))
        assert _pauses("pause_point", since)
        assert loop.run_until_complete(cache.try_read_object(obj)) == data
        loop.run_until_complete(cache.close())
    finally:
        loop.close()


def _serving_worker(rank, world_size, root, mode):
    import os as _os

    _os.environ.update(_ENV)
    _os.environ["TSS_TORCH_QOS_POLL_S"] = "0.005"
    _os.environ["TSS_TORCH_QOS_MAX_PAUSE_S"] = "0.05"
    _os.environ["TSS_TORCH_HASH_CHUNK_BYTES"] = "4096"
    _os.environ["TSS_TORCH_BCAST_RESTORE"] = "1" if mode == "bcast" else "0"
    _os.environ["TSS_TORCH_SWARM_RESTORE"] = "1" if mode == "swarm" else "0"
    if mode == "swarm":
        _os.environ["TSS_TORCH_BCAST_MAX_BYTES"] = "1"
    from torchsnapshot_tpu_torch import bcast as b_mod, swarm as w_mod

    tree = _tree(3)
    path = _os.path.join(root, "served")
    tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))}, replicated=["**"])
    since = time.time()
    target = tts.StateDict(**from_numpy_tree(_zeros(tree), device="cpu"))
    with engine.demand_scope(engine.Priority.FOREGROUND):
        tts.Snapshot(path).restore({"m": target}, device="cpu")
    _assert_port_tree(target, tree)
    stats = b_mod.LAST_RESTORE_BCAST if mode == "bcast" else w_mod.LAST_RESTORE_SWARM
    with open(_os.path.join(root, f"{mode}_{rank}.json"), "w") as f:
        json.dump({"pauses": len(_pauses("pause_point", since)), "origin_bytes": stats["origin_bytes"]}, f)


@pytest.mark.parametrize("mode", ["bcast", "swarm"])
def test_collective_restore_pauses_under_higher_demand_then_completes(tmp_path, mode):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_serving_worker, 2, args=(str(tmp_path), mode), process_group=True)
    ranks = [json.load(open(tmp_path / f"{mode}_{r}.json")) for r in range(2)]
    # Every origin fetch passed a pause point, so each rank that read from
    # the origin recorded a pause.
    assert sum(r["origin_bytes"] for r in ranks) > 0
    for r in ranks:
        assert (r["pauses"] > 0) == (r["origin_bytes"] > 0), ranks

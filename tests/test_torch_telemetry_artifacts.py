"""Persisted telemetry of the port held against the JAX package's.

Each package reads the other's per-rank artifacts
(``.telemetry/rank_<k>.json``), the byte counters of one tree agree, a
bucket's step records and rollout records are one series whichever package
wrote them, and gc and scrub treat real artifacts as the JAX package does.
"""

import json
import os
import shutil

import numpy as np
import pytest

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import catalog as jcat
from torchsnapshot_tpu.telemetry import aggregate as jagg
from torchsnapshot_tpu.telemetry import artifact as jart

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import catalog as tcat
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.telemetry import aggregate as tagg
from torchsnapshot_tpu_torch.telemetry import artifact as tart

COUNTERS = ("scheduler.bytes_staged", "storage.fs.write_bytes", "batcher.write_slabs")


@pytest.fixture(autouse=True)
def _same_knobs(monkeypatch):
    for prefix in ("TSS_TORCH_", "TORCHSNAPSHOT_TPU_"):
        monkeypatch.setenv(prefix + "DEDUP_DIGESTS", "1")
        monkeypatch.setenv(prefix + "ENABLE_BATCHING", "1")
    tcat._CHAIN_CACHE.clear()
    jcat._CHAIN_CACHE.clear()
    yield
    tcat._CHAIN_CACHE.clear()
    jcat._CHAIN_CACHE.clear()


def _tree(step: int = 0):
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((96, 64)).astype(np.float32),
        "b": np.full(32, step, np.float32),
        "ids": np.arange(10, dtype=np.int32),
        "step": step,
    }


def _take(pkg, path, value=0, op="take", **kw):
    tree = _tree(value)
    if pkg == "jax":
        app = {"m": jts.StateDict(**{k: v.copy() if isinstance(v, np.ndarray) else v for k, v in tree.items()})}
        mod = jts
    else:
        app = {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))}
        mod = tts
    if op == "take":
        mod.Snapshot.take(path, app, **kw)
    else:
        mod.Snapshot.async_take(path, app, **kw).wait()


def _restore(pkg, path, **kw):
    tree = _tree()
    if pkg == "jax":
        jts.Snapshot(path).restore({"m": jts.StateDict(**{k: np.zeros_like(v) if isinstance(v, np.ndarray) else 0 for k, v in tree.items()})}, **kw)
    else:
        target = from_numpy_tree({k: np.zeros_like(v) if isinstance(v, np.ndarray) else 0 for k, v in tree.items()}, device="cpu")
        tts.Snapshot(path).restore({"m": tts.StateDict(**target)}, device="cpu", **kw)


def _artifact_bytes(path, name="rank_0.json"):
    with open(os.path.join(path, ".telemetry", name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("op", ["take", "async_take"])
def test_artifacts_cross_read_and_counters_agree(tmp_path, op):
    _take("port", str(tmp_path / "p"), op=op)
    _take("jax", str(tmp_path / "j"), op=op)
    port_art = jart.parse_artifact(_artifact_bytes(tmp_path / "p"))
    jax_art = tart.parse_artifact(_artifact_bytes(tmp_path / "j"))
    assert port_art["op"] == jax_art["op"] == op
    # The same sections, "engine" (QoS preemptions and pauses) included.
    assert set(jax_art) == set(port_art)
    assert set(port_art["engine"]) == set(jax_art["engine"])
    assert port_art["engine"]["preemptions"] == jax_art["engine"]["preemptions"] == 0
    for key in COUNTERS:
        assert port_art["metrics"][key] == jax_art["metrics"][key], key
    assert port_art["bytes"] == jax_art["bytes"]
    assert port_art["requests"] == jax_art["requests"]
    # Each package's aggregate merges the other's artifact, with the same
    # byte totals as its own.
    jagg_port = jagg.aggregate({0: port_art}, world_size=1)
    tagg_jax = tagg.aggregate({0: jax_art}, world_size=1)
    assert jagg_port["totals"]["bytes_written"] == tagg_jax["totals"]["bytes_written"] > 0
    assert jagg_port["storage_bytes"] == tagg_jax["storage_bytes"]
    # Through the storage plugins: each package's reader on the other's snapshot.
    ws, arts, problems = jagg.read_snapshot_artifacts(str(tmp_path / "p"))
    assert (ws, problems) == (1, {}) and arts[0]["metrics"] == port_art["metrics"]
    ws, arts, problems = tagg.read_snapshot_artifacts(str(tmp_path / "j"))
    assert (ws, problems) == (1, {}) and arts[0]["metrics"] == jax_art["metrics"]


def test_restore_artifact_cross_reads(tmp_path):
    path = str(tmp_path / "s")
    _take("port", path)
    _restore("port", path)
    _, arts, problems = jagg.read_snapshot_artifacts(path, op="restore")
    assert problems == {} and arts[0]["op"] == "restore"
    assert {"restore.read_metadata", "restore.load_stateful"} <= set(arts[0]["phases_s"])
    assert arts[0]["metrics"]["scheduler.bytes_read"] > 0


def test_artifacts_knob_off_writes_none(tmp_path, monkeypatch):
    monkeypatch.setenv("TSS_TORCH_TELEMETRY_ARTIFACTS", "0")
    _take("port", str(tmp_path / "s"))
    assert not os.path.exists(tmp_path / "s" / ".telemetry")
    assert tts.Snapshot(str(tmp_path / "s")).verify() == {}


def test_gc_and_scrub_treat_artifacts_as_jax_does(tmp_path):
    bucket = tmp_path / "b"
    _take("port", str(bucket / "s1"))
    _restore("port", str(bucket / "s1"))
    _take("port", str(bucket / "s2"))
    open(bucket / "s2" / "x.tmp.123", "wb").close()  # debris
    shutil.copytree(bucket, tmp_path / "c")
    port = tts.Snapshot.gc(str(bucket), dry_run=False)
    jax = jts.Snapshot.gc(str(tmp_path / "c"), dry_run=False)
    assert port == jax
    assert "s1/.telemetry/rank_0.json" in port["keep"] and "s1/.telemetry/restore_rank_0.json" in port["keep"]
    assert port["remove"] == ["s2/x.tmp.123"]
    report = tts.Snapshot(str(bucket / "s1")).scrub()
    assert report == jts.Snapshot(str(tmp_path / "c" / "s1")).scrub()
    assert report["clean"]


def test_step_records_and_rollouts_are_one_series(tmp_path):
    """A port take and a JAX take of one job into one bucket: both packages
    read the same step series, and restore(job=, step=) of either appends
    rollout records both read back, naming the same snapshots."""
    bucket = str(tmp_path / "bucket")
    _take("port", f"{bucket}/step_1", value=1, job="ft", step=1)
    _take("jax", f"{bucket}/step_2", value=2, job="ft", step=2)
    with tcat.Catalog(bucket) as cat:
        port_series = cat.load_step_telemetry(job="ft")
    with jcat.Catalog(bucket) as cat:
        jax_series = cat.load_step_telemetry(job="ft")
    assert [(r["name"], r["step"], r["chain_len"], r["base"]) for r in port_series] == [
        ("step_1", 1, 0, None),
        ("step_2", 2, 1, "step_1"),
    ]
    assert port_series == jax_series
    assert [r["bytes"]["written"] > 0 for r in port_series] == [True, True]
    _restore("port", f"{bucket}/step_2", job="ft", step=2)
    _restore("jax", f"{bucket}/step_1", job="ft")
    with tcat.Catalog(bucket) as cat:
        port_rollouts = cat.load_rollout_telemetry(job="ft")
    with jcat.Catalog(bucket) as cat:
        jax_rollouts = cat.load_rollout_telemetry(job="ft")
    assert port_rollouts == jax_rollouts
    assert [(r["name"], r["step"], r["mode"]) for r in port_rollouts] == [
        ("step_1", 1, "direct"),
        ("step_2", 2, "direct"),
    ]
    assert all(r["bytes"]["origin"] > 0 for r in port_rollouts)


def test_step_record_rebuilds_from_the_artifacts(tmp_path):
    """The committed step record is the JAX package's rollup of the
    snapshot's own artifacts."""
    from torchsnapshot_tpu.telemetry import steprecord as jstep

    bucket = str(tmp_path / "bucket")
    _take("port", f"{bucket}/step_3", value=3, job="j")
    with tcat.Catalog(bucket) as cat:
        (rec,) = cat.load_step_telemetry(job="j")
    ws, arts, _ = jagg.read_snapshot_artifacts(f"{bucket}/step_3")
    rebuilt = jstep.build_step_record("j", 3, "step_3", jagg.aggregate(arts, ws), arts, base=None, chain_len=0)
    drop = {"created_unix"}
    assert {k: v for k, v in rec.items() if k not in drop} == {k: v for k, v in rebuilt.items() if k not in drop}
    assert json.loads(json.dumps(rec)) == rec

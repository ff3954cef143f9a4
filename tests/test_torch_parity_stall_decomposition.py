"""The async take's stall decomposition over the port, against
``tests/test_stall_decomposition.py``: the phases are recorded, non-negative
and cover the stall; the steady-state stall of a 32 MiB state stays within
the JAX test's budget; a sync take records its phases; the drain stats of
an async and of a sync take carry the JAX package's keys and invariants.

The port names its phases its own way (a listed difference, ROADMAP
"Ported surface", PR 7): ``PHASE_OF`` maps each phase the JAX test
requires to the port's phase that does that work. The same numpy state
goes through both packages."""

import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu.snapshot as jsnapshot
import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.snapshot as tsnapshot
from torchsnapshot_tpu_torch.convert import from_numpy_tree

# JAX phase -> the port's phase doing that work.
PHASE_OF = {
    "gather_keys_and_flatten": "flatten",
    "prepare_write": "prepare",
    "partition": "plan",
    "manifest_gather": "plan",
    "memory_budget": "plan",
    "capture": "capture",
}
STEADY_STALL_BUDGET_S = 5.0
DRAIN_KEYS = {"wall_s", "stage_busy_s", "io_busy_s", "overlap_s", "idle_s", "stage_d2h_s", "stage_serialize_s", "stage_hash_s"}


def _tree():
    rng = np.random.default_rng(0)
    return {
        "train": {"params": rng.standard_normal((1024, 4096)).astype(np.float32), "mu": np.zeros((1024, 4096), np.float32), "step": 3},
        "progress": {"epoch": 1},
    }


def _app(pkg, tree):
    if pkg == "jax":
        return {k: jts.StateDict(v) for k, v in tree.items()}
    return {k: tts.StateDict(from_numpy_tree(v, device="cpu")) for k, v in tree.items()}


def _mods(pkg):
    return (jts, jsnapshot) if pkg == "jax" else (tts, tsnapshot)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_phase_timings_recorded_and_cover_the_stall(tmp_path, pkg):
    mod, smod = _mods(pkg)
    app = _app(pkg, _tree())
    mod.Snapshot.async_take(str(tmp_path / "s"), app).wait()
    phases = dict(smod.LAST_TAKE_PHASES)
    want = set(PHASE_OF) if pkg == "jax" else set(PHASE_OF.values())
    assert want <= set(phases), sorted(phases)
    assert all(v >= 0 for v in phases.values())
    t0 = time.perf_counter()
    pending = mod.Snapshot.async_take(str(tmp_path / "s2"), app)
    stall = time.perf_counter() - t0
    pending.wait()
    assert sum(smod.LAST_TAKE_PHASES.values()) >= stall - 0.25


def test_steady_state_stall_within_the_jax_budget(tmp_path):
    app = _app("port", _tree())
    tts.Snapshot.async_take(str(tmp_path / "warm"), app).wait()
    stalls = []
    for i in range(2):
        t0 = time.perf_counter()
        pending = tts.Snapshot.async_take(str(tmp_path / f"s{i}"), app)
        stalls.append(time.perf_counter() - t0)
        pending.wait()
    assert min(stalls) < STEADY_STALL_BUDGET_S, stalls


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sync_take_also_records_phases(tmp_path, pkg):
    mod, smod = _mods(pkg)
    mod.Snapshot.take(str(tmp_path / "s"), _app(pkg, {"s": {"x": np.arange(64, dtype=np.float32)}}))
    names = ("prepare_write", "capture") if pkg == "jax" else (PHASE_OF["prepare_write"], PHASE_OF["capture"])
    assert set(names) <= set(smod.LAST_TAKE_PHASES)


def _check_drain(stats):
    assert DRAIN_KEYS <= set(stats), sorted(stats)
    assert all(stats[k] >= 0 for k in DRAIN_KEYS)
    assert stats["overlap_s"] <= stats["stage_busy_s"] + 1e-6
    assert stats["overlap_s"] <= stats["io_busy_s"] + 1e-6
    assert stats["stage_busy_s"] + stats["io_busy_s"] - stats["overlap_s"] <= stats["wall_s"] + 1e-6


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_drain_stats_recorded(tmp_path, pkg):
    mod, _ = _mods(pkg)
    pending = mod.Snapshot.async_take(str(tmp_path / "s"), _app(pkg, _tree()))
    snap = pending.wait()
    _check_drain(pending.drain_stats)
    assert snap.verify() == {}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sync_take_drain_stats_cover_staging(tmp_path, pkg):
    """A sync take stages everything before its drain loop; the stats
    still attribute that staging."""
    mod, smod = _mods(pkg)
    rng = np.random.default_rng(1)
    tree = {"m": {f"a{i}": rng.standard_normal((256, 256)).astype(np.float32) for i in range(4)}}
    mod.Snapshot.take(str(tmp_path / "ckpt"), _app(pkg, tree))
    stats = dict(smod.LAST_SYNC_DRAIN_STATS)
    _check_drain(stats)
    assert stats["stage_busy_s"] > 0
    assert stats["wall_s"] >= stats["stage_busy_s"] - 1e-6


def test_the_same_state_decomposes_alike_in_both_packages(tmp_path):
    """Both packages' drains of one state report the same stream keys."""
    tree = _tree()
    keys = {}
    for pkg in ("jax", "port"):
        mod, _ = _mods(pkg)
        pending = mod.Snapshot.async_take(str(tmp_path / pkg), _app(pkg, tree))
        pending.wait()
        keys[pkg] = {k for k in pending.drain_stats if k.endswith("_s")}
    assert keys["port"] == keys["jax"] == DRAIN_KEYS
    # Both snapshots restore through the other package.
    out = tts.StateDict(params=torch.zeros(1024, 4096), mu=torch.ones(1024, 4096), step=-1)
    tts.Snapshot(str(tmp_path / "jax")).restore({"train": out}, device="cpu")
    assert out["params"].numpy().tobytes() == tree["train"]["params"].tobytes() and out["step"] == 3
    jout = jts.StateDict(params=np.zeros((1024, 4096), np.float32), mu=np.ones((1024, 4096), np.float32), step=-1)
    jts.Snapshot(str(tmp_path / "port")).restore({"train": jout})
    assert np.asarray(jout["mu"]).tobytes() == tree["train"]["mu"].tobytes() and jout["step"] == 3

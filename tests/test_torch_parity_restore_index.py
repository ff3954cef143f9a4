"""Restore planning over the port against ``tests/test_restore_index.py``:
the per-rank manifest is iterated once per restore, whatever the number
of app-state keys, and a key holding '/' still restores; in both
directions between the packages. Also: a two-rank restore in which one
rank holds fewer keys than the other, with broadcast restore on and off,
has the JAX package's outcome."""

import json

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu.snapshot as jsnapshot
import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.snapshot as tsnapshot
from torchsnapshot_tpu_torch.convert import from_numpy_tree

N_KEYS = 50


def _values(i):
    return {"a": np.arange(4, dtype=np.float32) + i, "b": i}


def _jax_app(n, filled):
    return {
        f"k{i:04d}": jts.StateDict(**(_values(i) if filled else {"a": np.zeros(4, np.float32), "b": -1}))
        for i in range(n)
    }


def _port_app(n, filled):
    return {
        f"k{i:04d}": tts.StateDict(
            **(from_numpy_tree(_values(i), device="cpu") if filled else {"a": torch.zeros(4), "b": -1})
        )
        for i in range(n)
    }


class _CountingManifest(dict):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.items_calls = 0

    def items(self):
        self.items_calls += 1
        return super().items()


def _count_scans(monkeypatch, mod):
    seen = {}
    orig = mod.get_manifest_for_rank

    def wrapped(metadata, rank):
        seen["m"] = _CountingManifest(orig(metadata, rank))
        return seen["m"]

    monkeypatch.setattr(mod, "get_manifest_for_rank", wrapped)
    return seen


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restore_scans_manifest_once_in_both_packages(tmp_path, monkeypatch, writer):
    path = str(tmp_path / "s")
    if writer == "jax":
        jts.Snapshot.take(path, _jax_app(N_KEYS, True))
    else:
        tts.Snapshot.take(path, _port_app(N_KEYS, True))
    port_seen = _count_scans(monkeypatch, tsnapshot)
    jax_seen = _count_scans(monkeypatch, jsnapshot)
    ttgt, jtgt = _port_app(N_KEYS, False), _jax_app(N_KEYS, False)
    tts.Snapshot(path).restore(ttgt, device="cpu")
    jts.Snapshot(path).restore(jtgt)
    assert port_seen["m"].items_calls == jax_seen["m"].items_calls == 1
    for i in range(N_KEYS):
        key = f"k{i:04d}"
        assert ttgt[key]["b"] == jtgt[key]["b"] == i
        assert ttgt[key]["a"].numpy().tobytes() == np.asarray(jtgt[key]["a"]).tobytes() == _values(i)["a"].tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_app_key_containing_slash_restores_in_both_packages(tmp_path, writer):
    tree = {"opt/adam": {"m": np.arange(3, dtype=np.float32), "step": 9}, "opt/sgd": {"v": np.arange(5, dtype=np.float32)}}
    path = str(tmp_path / "s")
    if writer == "jax":
        jts.Snapshot.take(path, {k: jts.StateDict(**v) for k, v in tree.items()})
    else:
        tts.Snapshot.take(path, {k: tts.StateDict(**from_numpy_tree(v, device="cpu")) for k, v in tree.items()})
    ttgt = {"opt/adam": tts.StateDict(m=torch.zeros(3), step=-1), "opt/sgd": tts.StateDict(v=torch.zeros(5))}
    jtgt = {"opt/adam": jts.StateDict(m=np.zeros(3, np.float32), step=-1), "opt/sgd": jts.StateDict(v=np.zeros(5, np.float32))}
    tts.Snapshot(path).restore(ttgt, device="cpu")
    jts.Snapshot(path).restore(jtgt)
    assert ttgt["opt/adam"]["step"] == jtgt["opt/adam"]["step"] == 9
    assert np.array_equal(ttgt["opt/adam"]["m"].numpy(), tree["opt/adam"]["m"])
    assert np.array_equal(np.asarray(jtgt["opt/adam"]["m"]), tree["opt/adam"]["m"])
    assert np.array_equal(ttgt["opt/sgd"]["v"].numpy(), tree["opt/sgd"]["v"])
    assert np.array_equal(np.asarray(jtgt["opt/sgd"]["v"]), tree["opt/sgd"]["v"])


# ---------------------------------------------------------------------------
# Ranks with different key sets
# ---------------------------------------------------------------------------

_KEYS = ("a", "b", "c")


def _key_tree(key):
    rng = np.random.default_rng(ord(key))
    return {"w": rng.standard_normal(64).astype(np.float32), "n": ord(key)}


def _outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 - the kind of failure is compared
        return type(e).__name__


def _bcast_record(rec):
    return {
        "origin_reads": sorted(rec.get("origin_reads", [])),
        "received": sorted(rec.get("received", [])),
        "reelections": rec.get("reelections", 0),
        "direct_fallbacks": rec.get("direct_fallbacks", 0),
    }


def _port_keys_worker(rank, world_size, root, bcast):
    import os as _os

    _os.environ["TSS_TORCH_BCAST_RESTORE"] = "1" if bcast else "0"
    _os.environ["TSS_TORCH_BCAST_READER_DEADLINE_S"] = "0.5"
    _os.environ["TSS_TORCH_BARRIER_TIMEOUT_S"] = "60"
    path = _os.path.join(root, "port")
    tts.Snapshot.take(
        path, {k: tts.StateDict(**from_numpy_tree(_key_tree(k), device="cpu")) for k in _KEYS}, replicated=["**"]
    )
    mine = _KEYS if rank == 0 else ("a", "c")
    target = {k: tts.StateDict(w=torch.zeros(64), n=-1) for k in mine}
    out = {"outcome": _outcome(lambda: tts.Snapshot(path).restore(target, device="cpu"))}
    out["restored"] = sorted(
        k for k in mine if target[k]["n"] == ord(k) and np.array_equal(target[k]["w"].numpy(), _key_tree(k)["w"])
    )
    from torchsnapshot_tpu_torch import bcast as bcast_mod

    out["bcast"] = _bcast_record(bcast_mod.LAST_RESTORE_BCAST)
    with open(_os.path.join(root, f"port_{int(bcast)}_{rank}.json"), "w") as f:
        json.dump(out, f)


def _jax_keys_worker(rank, world_size, root, bcast):
    import os as _os

    _os.environ["TORCHSNAPSHOT_TPU_BCAST_RESTORE"] = "1" if bcast else "0"
    _os.environ["TORCHSNAPSHOT_TPU_BCAST_READER_DEADLINE_S"] = "0.5"
    _os.environ["TORCHSNAPSHOT_TPU_BARRIER_TIMEOUT_S"] = "60"
    path = _os.path.join(root, "jax")
    jts.Snapshot.take(path, {k: jts.StateDict(**_key_tree(k)) for k in _KEYS}, replicated=["**"])
    mine = _KEYS if rank == 0 else ("a", "c")
    target = {k: jts.StateDict(w=np.zeros(64, np.float32), n=-1) for k in mine}
    out = {"outcome": _outcome(lambda: jts.Snapshot(path).restore(target))}
    out["restored"] = sorted(
        k for k in mine if target[k]["n"] == ord(k) and np.array_equal(np.asarray(target[k]["w"]), _key_tree(k)["w"])
    )
    from torchsnapshot_tpu import bcast as bcast_mod

    out["bcast"] = _bcast_record(bcast_mod.LAST_RESTORE_BCAST)
    with open(_os.path.join(root, f"jax_{int(bcast)}_{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.mark.parametrize("bcast", [True, False], ids=["bcast_on", "bcast_off"])
def test_ranks_with_unequal_key_sets_restore_as_in_the_jax_package(tmp_path, bcast):
    """Rank 1 restores keys ``a`` and ``c`` of a snapshot of ``a``, ``b``
    and ``c``; rank 0 all three. Each package restores every key its rank
    holds, bit-exact, with broadcast restore on and off. With it on, both
    packages' per-key broadcast phases fall out of step at the key rank 1
    lacks, and each waits out one reader deadline before it re-elects (the
    JAX package's union-of-keys order does not change that: a rank still
    skips the keys it does not hold); the port does exactly what the JAX
    package does, election for election."""
    from torchsnapshot_tpu.test_utils import run_with_processes as jax_run
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_port_keys_worker, 2, args=(str(tmp_path), bcast), process_group=True, timeout_s=240)
    jax_run(_jax_keys_worker, 2, args=(str(tmp_path), bcast))
    port = [json.load(open(tmp_path / f"port_{int(bcast)}_{r}.json")) for r in range(2)]
    jax_ = [json.load(open(tmp_path / f"jax_{int(bcast)}_{r}.json")) for r in range(2)]
    assert port == jax_
    assert [{k: v for k, v in r.items() if k != "bcast"} for r in port] == [
        {"outcome": "ok", "restored": ["a", "b", "c"]},
        {"outcome": "ok", "restored": ["a", "c"]},
    ]
    assert sum(r["bcast"]["reelections"] for r in port) == (2 if bcast else 0)

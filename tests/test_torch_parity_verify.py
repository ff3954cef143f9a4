"""``Snapshot.verify()`` of both packages on the same snapshots, the
counterparts of ``tests/test_verify.py``: clean sync, async and batched
takes; a flipped byte; a missing object; no sidecar; an object no sidecar
covers; an all-primitive snapshot; re-takes that must clear a stale
sidecar; an unreadable sidecar; an object that cannot be read. Each case
is made once by each package, and each package's ``verify()`` of either
package's snapshot gives the same report."""

import glob
import json
import os

import ml_dtypes
import numpy as np
import pytest

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.utils import knobs as jknobs
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.utils import knobs as tknobs


def _tree():
    return {
        "dev": np.arange(64, dtype=np.float32).reshape(8, 8).astype(ml_dtypes.bfloat16),
        "host": np.arange(100, dtype=np.float32),
        "obj": {"nested": [1, 2, 3]},
    }


def _take(pkg, path, tree=None, checksums=True, asynchronous=False, batched=False):
    tree = _tree() if tree is None else tree
    knobs = jknobs if pkg == "jax" else tknobs
    with knobs.override_checksums(checksums), knobs.override_batching_enabled(batched), knobs.override_slab_size_threshold_bytes(10**6):
        if pkg == "jax":
            app = {"m": jts.StateDict(tree)}
            if asynchronous:
                jts.Snapshot.async_take(path, app).wait()
            else:
                jts.Snapshot.take(path, app)
        else:
            app = {"m": tts.StateDict(from_numpy_tree(tree, device="cpu"))}
            if asynchronous:
                tts.Snapshot.async_take(path, app).wait()
            else:
                tts.Snapshot.take(path, app)


def _data_files(path):
    return sorted(
        p for p in glob.glob(os.path.join(path, "**", "*"), recursive=True)
        if os.path.isfile(p) and not os.path.basename(p).startswith(".")
    )


def _flip_first(path):
    victim = _data_files(path)[0]
    data = bytearray(open(victim, "rb").read())
    data[0] ^= 0xFF
    open(victim, "wb").write(bytes(data))


def _remove_last(path):
    os.remove(_data_files(path)[-1])


def _drop_first_record(path):
    sidecar = os.path.join(path, ".checksums.0")
    recorded = json.loads(open(sidecar).read())
    del recorded[sorted(recorded)[0]]
    open(sidecar, "w").write(json.dumps(recorded))


def _garble_sidecar(path):
    open(os.path.join(path, ".checksums.0"), "w").write("{ not json")


def _directory_for_first(path):
    victim = _data_files(path)[0]
    os.remove(victim)
    os.makedirs(victim)


# case -> (take keywords, what then happens to the snapshot)
CASES = {
    "clean": ({}, None),
    "clean_async_batched": ({"asynchronous": True, "batched": True}, None),
    "corrupt": ({}, _flip_first),
    "missing": ({}, _remove_last),
    "no_sidecar": ({"checksums": False}, None),
    "uncovered": ({}, _drop_first_record),
    "all_primitive": ({"tree": {"lr": 0.1, "name": "adam", "step": 3}}, None),
    "retake_checksums_off": ({}, "retake_off"),
    "retake_primitive_only": ({}, "retake_primitive"),
    "unreadable_sidecar": ({}, _garble_sidecar),
    "unreadable_object": ({}, _directory_for_first),
}


def _make(pkg, path, case):
    kw, then = CASES[case]
    _take(pkg, path, **kw)
    if then == "retake_off":
        _take(pkg, path, tree={"other": np.ones(7)}, checksums=False)
    elif then == "retake_primitive":
        _take(pkg, path, tree={"lr": 0.1, "step": 2})
    elif then is not None:
        then(path)


def _verify(pkg, path):
    try:
        return ("ok", (jts if pkg == "jax" else tts).Snapshot(path).verify())
    except RuntimeError as e:
        return ("raises", str(e).split(":")[0][:40])


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_reports_as_the_jax_package(tmp_path, case):
    for writer in ("jax", "port"):
        _make(writer, str(tmp_path / writer), case)
    reports = {
        (writer, reader): _verify(reader, str(tmp_path / writer)) for writer in ("jax", "port") for reader in ("jax", "port")
    }
    assert len({json.dumps(r, sort_keys=True) for r in reports.values()}) == 1, reports
    kind, report = reports[("port", "port")]
    if case in ("clean", "clean_async_batched", "all_primitive", "retake_primitive_only"):
        assert (kind, report) == ("ok", {})
        assert not (case == "retake_primitive_only" and os.path.exists(tmp_path / "port" / ".checksums.0"))
    elif case in ("no_sidecar", "retake_checksums_off"):
        assert kind == "raises" and "no checksum sidecars" in report
        assert not os.path.exists(tmp_path / "port" / ".checksums.0")
    elif case == "corrupt":
        assert len(report) == 1 and "crc mismatch" in next(iter(report.values()))
    elif case == "missing":
        assert list(report.values()) == ["missing"]
    elif case == "uncovered":
        assert list(report.values()) == ["unverified (no checksum recorded)"]
    elif case == "unreadable_sidecar":
        assert "sidecar unreadable" in report[".checksums.0"]
        assert all("no checksum recorded" not in msg for msg in report.values())
    elif case == "unreadable_object":
        assert len(report) == 1 and "unreadable" in next(iter(report.values()))

"""The public error contract of the port, held against the JAX package.

- A failed sync take or restore raises ``CheckpointAbortedError`` (rank,
  phase, and the root error as its ``__cause__``) at every world size,
  world 1 included, as the JAX package does.
- What the JAX package keeps raw stays raw: an application's own
  ``load_state_dict`` error and an error raised before the operation
  starts (a non-Stateful value's ``TypeError``).
- In a two-rank restore, the rank whose ``load_state_dict`` raises gets
  that error itself; its peer gets ``CheckpointAbortedError`` naming it.
- The port's top level exports every name the JAX package's does.
"""

import json
import os

import numpy as np
import pytest

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.test_utils import run_with_processes as jrun_with_processes

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.test_utils import run_with_processes as trun_with_processes

PKGS = ("jax", "torch")
_PREFIX = {"jax": "TORCHSNAPSHOT_TPU_", "torch": "TSS_TORCH_"}


def _state():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal(64).astype(np.float32), "y": np.arange(8, dtype=np.int32)}


def _app(pkg, state):
    if pkg == "jax":
        return jts.StateDict(**{k: v.copy() for k, v in state.items()})
    return tts.StateDict(from_numpy_tree(dict(state), device="cpu"))


def _take(pkg, path, app):
    (jts if pkg == "jax" else tts).Snapshot.take(path, app)


def _restore(pkg, path, app_state):
    if pkg == "jax":
        jts.Snapshot(path).restore(app_state)
    else:
        tts.Snapshot(path).restore(app_state, device="cpu")


def _taken(pkg, tmp_path):
    path = str(tmp_path / pkg / "s")
    _take(pkg, path, {"m": _app(pkg, _state())})
    return path


def _case_take_write_fault(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv(_PREFIX[pkg] + "FAULTS", "op=write,at=0,kind=fail")
    path = str(tmp_path / pkg / "w")
    try:
        _take(pkg, path, {"m": _app(pkg, _state())})
    finally:
        assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


def _case_restore_persistent_rot(pkg, tmp_path, monkeypatch):
    path = _taken(pkg, tmp_path)
    monkeypatch.setenv(_PREFIX[pkg] + "VERIFY_READS", "all")
    monkeypatch.setenv(_PREFIX[pkg] + "FAULTS", "op=read,after=0,kind=corrupt,path=0/m/x")
    _restore(pkg, path, {"m": _app(pkg, _state())})


def _case_restore_missing_key(pkg, tmp_path, monkeypatch):
    path = _taken(pkg, tmp_path)
    _restore(pkg, path, {"other": (jts if pkg == "jax" else tts).StateDict()})


def _case_restore_missing_path(pkg, tmp_path, monkeypatch):
    _restore(pkg, str(tmp_path / pkg / "never"), {"m": _app(pkg, _state())})


# (case, rank, phase, root class): the JAX package's outcome.
WRAPPED = [
    (_case_take_write_fault, 0, "write", "InjectedFault"),
    (_case_restore_persistent_rot, 0, "restore.read", "ReadVerificationError"),
    (_case_restore_missing_key, 0, "restore.read", "KeyError"),
    (_case_restore_missing_path, 0, "restore.plan", "FileNotFoundError"),
]


def _abort_of(pkg, fn):
    aborted = jts.CheckpointAbortedError if pkg == "jax" else tts.CheckpointAbortedError
    with pytest.raises(aborted) as info:
        fn()
    e = info.value
    return (type(e).__name__, e.rank, e.phase, type(e.__cause__).__name__)


@pytest.mark.parametrize(
    "case, rank, phase, root", WRAPPED, ids=[c[0].__name__[len("_case_"):] for c in WRAPPED]
)
def test_world_one_failure_is_wrapped_as_in_the_jax_package(case, rank, phase, root, tmp_path, monkeypatch):
    outcomes = {}
    for pkg in PKGS:
        with monkeypatch.context() as m:
            outcomes[pkg] = _abort_of(pkg, lambda: case(pkg, tmp_path, m))
    assert outcomes["jax"] == outcomes["torch"] == ("CheckpointAbortedError", rank, phase, root), outcomes


class _JaxHookRaises(jts.StateDict):
    def load_state_dict(self, state_dict):
        raise KeyError("hook")


class _TorchHookRaises(tts.StateDict):
    def load_state_dict(self, state_dict):
        raise KeyError("hook")


def _case_app_hook_key_error(pkg, tmp_path):
    path = _taken(pkg, tmp_path)
    hook = _JaxHookRaises if pkg == "jax" else _TorchHookRaises
    _restore(pkg, path, {"m": hook(**{k: v for k, v in _app(pkg, _state()).items()})})


def _case_non_stateful_take(pkg, tmp_path):
    _take(pkg, str(tmp_path / pkg / "n"), {"m": object()})


@pytest.mark.parametrize(
    "case, error",
    [(_case_app_hook_key_error, KeyError), (_case_non_stateful_take, TypeError)],
    ids=["app_hook_key_error", "non_stateful_take"],
)
def test_world_one_error_stays_raw_as_in_the_jax_package(case, error, tmp_path):
    for pkg in PKGS:
        with pytest.raises(error) as info:
            case(pkg, tmp_path)
        assert type(info.value) is error, (pkg, info.value)
        assert not isinstance(info.value, (jts.CheckpointAbortedError, tts.CheckpointAbortedError))


def _jworker_hook_raises_on_rank1(rank, world_size, shared):
    from torchsnapshot_tpu import CheckpointAbortedError as Aborted, Snapshot as Snap, StateDict as SD

    os.environ["TORCHSNAPSHOT_TPU_BARRIER_TIMEOUT_S"] = "20"
    path = os.path.join(shared, "s")
    Snap.take(path, {"s": SD(v=np.full(64, rank, np.float32))})

    class Hook(SD):
        def load_state_dict(self, state_dict):
            if rank == 1:
                raise KeyError("rank 1's own hook")
            super().load_state_dict(state_dict)

    _record_restore(shared, rank, Aborted, lambda: Snap(path).restore({"s": Hook(v=np.zeros(64, np.float32))}))


def _tworker_hook_raises_on_rank1(rank, world_size, shared):
    import torch

    from torchsnapshot_tpu_torch import CheckpointAbortedError as Aborted, Snapshot as Snap, StateDict as SD

    os.environ["TSS_TORCH_BARRIER_TIMEOUT_S"] = "20"
    path = os.path.join(shared, "s")
    Snap.take(path, {"s": SD(v=torch.full((64,), float(rank)))})

    class Hook(SD):
        def load_state_dict(self, state_dict):
            if rank == 1:
                raise KeyError("rank 1's own hook")
            super().load_state_dict(state_dict)

    _record_restore(
        shared, rank, Aborted, lambda: Snap(path).restore({"s": Hook(v=torch.zeros(64))}, device="cpu")
    )


def _record_restore(shared, rank, aborted, restore):
    try:
        restore()
        out = ["commit"]
    except aborted as e:
        out = [type(e).__name__, e.rank, e.phase]
    except KeyError as e:
        out = [type(e).__name__, str(e)]
    with open(os.path.join(shared, f"restore_{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.mark.multiprocess
def test_two_rank_restore_keeps_the_applications_error(tmp_path):
    """Rank 1's ``load_state_dict`` raises ``KeyError``: rank 1 gets the
    ``KeyError``, rank 0 ``CheckpointAbortedError`` naming rank 1 in
    ``restore.read``, in both packages."""
    for pkg in PKGS:
        os.makedirs(tmp_path / pkg)
    jrun_with_processes(_jworker_hook_raises_on_rank1, nproc=2, args=(str(tmp_path / "jax"),))
    trun_with_processes(
        _tworker_hook_raises_on_rank1, 2, args=(str(tmp_path / "torch"),), process_group=True, timeout_s=120
    )
    for pkg in PKGS:
        got = [json.load(open(tmp_path / pkg / f"restore_{r}.json")) for r in range(2)]
        assert got == [["CheckpointAbortedError", 1, "restore.read"], ["KeyError", "\"rank 1's own hook\""]], (pkg, got)


def test_top_level_exports_cover_the_jax_package():
    assert set(jts.__all__) <= set(tts.__all__), sorted(set(jts.__all__) - set(tts.__all__))
    for name in jts.__all__:
        assert hasattr(tts, name), name
    from torchsnapshot_tpu_torch import CheckpointAbortedError, ReadVerificationError, StoragePlugin
    from torchsnapshot_tpu_torch.io_types import StoragePlugin as plugin_base
    from torchsnapshot_tpu_torch.scheduler import ReadVerificationError as read_error
    from torchsnapshot_tpu_torch.snapshot import CheckpointAbortedError as aborted

    assert (CheckpointAbortedError, ReadVerificationError, StoragePlugin) == (aborted, read_error, plugin_base)

"""``async_take``'s fork under device-memory pressure, over the port,
against ``tests/test_async_oom.py``: the simulated limit
(``TSS_TORCH_ASYNC_FORK_HBM_LIMIT_BYTES``) and an out-of-memory error
raised by the fork itself both degrade the take (what fits stays forked,
the rest is captured through host RAM before ``async_take`` returns)
instead of failing it; the snapshot survives in-place updates right after
the return, restores bit-exact and has the layout of a normal take; any
other fork error propagates; degraded captures still join compressed
slabs; ranks under different pressure compose one snapshot.

On the CPU a tensor stands in for a CUDA one: ``io_preparer.cuda_source``
accepts it, the streams and events are stand-ins, K2 runs its plain
version and the host capture is a clone. The JAX package runs the same
numpy values through its own fork on its CPU devices. Its last case, an
array sharded over one process's local devices, has no torch
counterpart: a torch process holds one device per tensor.
"""

import logging
import os
import re

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu.io_preparer as jio
import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.io_preparer as tio
from torchsnapshot_tpu.manifest import entry_to_dict as jentry_to_dict
from torchsnapshot_tpu.utils import knobs as jknobs
from torchsnapshot_tpu_torch import kernels
from torchsnapshot_tpu_torch.io_preparers.sharded_array import DTensorLeaf
from torchsnapshot_tpu_torch.manifest import entry_to_dict as tentry_to_dict
from torchsnapshot_tpu_torch.utils import knobs as tknobs

_CAPTURED = re.compile(r"(\d+) of (\d+) (?:leaves|tensors) \(")


@pytest.fixture(autouse=True)
def _no_prepared_cache(monkeypatch):
    # A prepared take of an earlier case with other knobs would re-prepare
    # (and, in the JAX package, capture twice): each case plans afresh.
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_PREPARED_CACHE", "0")
    monkeypatch.setenv("TSS_TORCH_PREPARED_CACHE", "0")


class _FakeStream:
    def wait_stream(self, other):
        pass

    def wait_event(self, ev):
        pass

    def synchronize(self):
        pass


class _FakeEvent:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass

    def query(self):
        return True


def _stand_in(monkeypatch):
    """CPU tensors take the CUDA capture path."""

    def source(v):
        t = v.local if isinstance(v, DTensorLeaf) else v
        return t if isinstance(t, torch.Tensor) else None

    monkeypatch.setattr(tio, "cuda_source", source)
    monkeypatch.setattr(tio, "_host_capture_group", lambda g, stream: [t.clone() for t in g])
    monkeypatch.setattr(tio.d2h, "side_stream", lambda device, role: _FakeStream())
    monkeypatch.setattr(tio.d2h, "ready_event", lambda device: None)
    monkeypatch.setattr(tio.torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(tio.torch.cuda, "Event", _FakeEvent)


def _captured_counts(caplog, logger):
    msgs = [r.getMessage() for r in caplog.records if r.name == logger and "captured through host RAM" in r.getMessage()]
    return [tuple(int(x) for x in _CAPTURED.search(m).groups()) for m in msgs]


def _jax_leaves(values):
    import jax

    dev = jax.devices()[0]
    return {k: jax.device_put(v, dev) for k, v in values.items()}


def _values(n=4, size=256):
    return {f"a{i}": np.full(size, i, dtype=np.float32) + np.arange(size, dtype=np.float32) for i in range(n)}


def _restore_port(path, values):
    tgt = tts.StateDict(**{k: torch.zeros(v.shape, dtype=torch.float32) for k, v in values.items()})
    tts.Snapshot(path).restore({"s": tgt}, device="cpu")
    return {k: tgt[k].numpy() for k in values}


def _restore_jax(path, values):
    tgt = jts.StateDict(**{k: np.zeros_like(v) for k, v in values.items()})
    jts.Snapshot(path).restore({"s": tgt})
    return {k: np.asarray(tgt[k]) for k in values}


@pytest.mark.parametrize("limit", [0, 2560], ids=["nothing_fits", "half_fits"])
def test_limit_degrades_the_capture_as_in_the_jax_package(tmp_path, monkeypatch, caplog, limit):
    """Four 1 KiB leaves: a limit of 0 captures all four through host RAM,
    2.5 KiB keeps two forked. The same counts in both packages' warnings,
    and both snapshots restore the values from before the in-place
    updates that follow the return (or, in JAX, their deletion)."""
    values = _values()
    _stand_in(monkeypatch)
    jleaves = _jax_leaves(values)
    with jknobs.override_async_fork_hbm_limit_bytes(limit), caplog.at_level(logging.WARNING):
        jpending = jts.Snapshot.async_take(str(tmp_path / "j"), {"s": jts.StateDict(**jleaves)})
    for a in jleaves.values():
        a.delete()
    jpending.wait()
    tleaves = {k: torch.from_numpy(v.copy()) for k, v in values.items()}
    with tknobs.override_async_fork_hbm_limit_bytes(limit), caplog.at_level(logging.WARNING):
        tpending = tts.Snapshot.async_take(str(tmp_path / "t"), {"s": tts.StateDict(**tleaves)})
    for t in tleaves.values():
        t.add_(1000.0)
    tpending.wait()
    jcounts = _captured_counts(caplog, "torchsnapshot_tpu.io_preparer")
    tcounts = _captured_counts(caplog, "torchsnapshot_tpu_torch.io_preparer")
    assert tcounts == jcounts == [(4 if limit == 0 else 2, 4)]
    for path in (str(tmp_path / "j"), str(tmp_path / "t")):
        for got in (_restore_port(path, values), _restore_jax(path, values)):
            for k, v in values.items():
                assert got[k].tobytes() == v.tobytes(), (path, k)


def test_degraded_take_has_the_layout_of_a_normal_take(tmp_path, monkeypatch):
    """A degraded capture changes the data path, never the plan: the port's
    normal sync take and its degraded async take have one manifest, which
    is also the JAX package's degraded take's."""
    values = _values(3, 64)
    values["step"] = np.int32(3)
    _stand_in(monkeypatch)
    state = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in values.items()}
    tts.Snapshot.take(str(tmp_path / "normal"), {"s": tts.StateDict(**state)})
    with tknobs.override_async_fork_hbm_limit_bytes(0):
        tts.Snapshot.async_take(str(tmp_path / "degraded"), {"s": tts.StateDict(**state)}).wait()
    with jknobs.override_async_fork_hbm_limit_bytes(0):
        jts.Snapshot.async_take(str(tmp_path / "jax"), {"s": jts.StateDict(**_jax_leaves(values))}).wait()

    def layout(path, pkg):
        snap = (jts if pkg == "jax" else tts).Snapshot(path)
        to_dict = jentry_to_dict if pkg == "jax" else tentry_to_dict
        return {p: to_dict(e) for p, e in snap.get_manifest().items()}

    normal = layout(str(tmp_path / "normal"), "port")
    assert layout(str(tmp_path / "degraded"), "port") == normal
    assert layout(str(tmp_path / "jax"), "jax") == normal


def test_out_of_memory_from_the_fork_degrades_as_in_the_jax_package(tmp_path, monkeypatch, caplog):
    """The fork itself runs out of memory (not the simulated limit): every
    leaf is captured through host RAM and the take commits bit-exact."""
    values = _values(2, 64)
    _stand_in(monkeypatch)

    def exploding_copy_fn(shardings):
        def fn(xs):
            raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate 1234 bytes")

        return fn

    def exploding_fork(tensors, stream=None):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1234 bytes")

    monkeypatch.setattr(jio, "_batch_copy_fn", exploding_copy_fn)
    monkeypatch.setattr(kernels, "fork_copy", exploding_fork)
    jleaves = _jax_leaves(values)
    with caplog.at_level(logging.WARNING):
        jpending = jts.Snapshot.async_take(str(tmp_path / "j"), {"s": jts.StateDict(**jleaves)})
        for a in jleaves.values():
            a.delete()
        jpending.wait()
        tleaves = {k: torch.from_numpy(v.copy()) for k, v in values.items()}
        tpending = tts.Snapshot.async_take(str(tmp_path / "t"), {"s": tts.StateDict(**tleaves)})
        for t in tleaves.values():
            t.zero_()
        tpending.wait()
    assert _captured_counts(caplog, "torchsnapshot_tpu_torch.io_preparer") == _captured_counts(
        caplog, "torchsnapshot_tpu.io_preparer"
    ) == [(2, 2)]
    for path in (str(tmp_path / "j"), str(tmp_path / "t")):
        got = _restore_port(path, values)
        assert all(got[k].tobytes() == v.tobytes() for k, v in values.items())


def test_other_fork_errors_propagate_as_in_the_jax_package(tmp_path, monkeypatch):
    """Degradation is for running out of memory only."""
    values = _values(1, 16)
    _stand_in(monkeypatch)

    def broken_copy_fn(shardings):
        def fn(xs):
            raise ValueError("not an allocation failure")

        return fn

    def broken_fork(tensors, stream=None):
        raise ValueError("not an allocation failure")

    monkeypatch.setattr(jio, "_batch_copy_fn", broken_copy_fn)
    monkeypatch.setattr(kernels, "fork_copy", broken_fork)
    with pytest.raises(ValueError, match="not an allocation failure"):
        jts.Snapshot.async_take(str(tmp_path / "j"), {"s": jts.StateDict(**_jax_leaves(values))})
    with pytest.raises(ValueError, match="not an allocation failure"):
        tts.Snapshot.async_take(str(tmp_path / "t"), {"s": tts.StateDict(a0=torch.from_numpy(values["a0"].copy()))})
    assert not os.path.exists(str(tmp_path / "t" / ".snapshot_metadata"))


def test_degraded_captures_join_compressed_slabs_as_in_the_jax_package(tmp_path, monkeypatch, caplog):
    """Host-captured leaves still pack into member-framed compressed slabs:
    four batched entries with raw ranges in both packages, bit-exact."""
    pytest.importorskip("zstandard")
    values = _values(4, 256)
    _stand_in(monkeypatch)
    for prefix in ("TORCHSNAPSHOT_TPU_", "TSS_TORCH_"):
        monkeypatch.setenv(prefix + "ASYNC_FORK_HBM_LIMIT_BYTES", "0")
        monkeypatch.setenv(prefix + "ENABLE_BATCHING", "1")
        monkeypatch.setenv(prefix + "COMPRESSION", "zstd")
    jleaves = _jax_leaves(values)
    tleaves = {k: torch.from_numpy(v.copy()) for k, v in values.items()}
    with caplog.at_level(logging.WARNING):
        jpending = jts.Snapshot.async_take(str(tmp_path / "j"), {"s": jts.StateDict(**jleaves)})
        for a in jleaves.values():
            a.delete()
        jpending.wait()
        tpending = tts.Snapshot.async_take(str(tmp_path / "t"), {"s": tts.StateDict(**tleaves)})
        for t in tleaves.values():
            t.add_(1.0)
        tpending.wait()
    assert _captured_counts(caplog, "torchsnapshot_tpu_torch.io_preparer") == [(4, 4)]
    for path, mod in ((str(tmp_path / "j"), jts), (str(tmp_path / "t"), tts)):
        batched = [e for e in mod.Snapshot(path).get_manifest().values() if getattr(e, "location", "").startswith("batched/")]
        assert len(batched) == 4 and all(e.raw_range is not None for e in batched), path
        for got in (_restore_port(path, values), _restore_jax(path, values)):
            assert all(got[k].tobytes() == v.tobytes() for k, v in values.items()), path


def _mixed_pressure_worker(rank, world_size, root):
    """Rank 1 forks nothing (limit 0), rank 0 forks everything: one
    snapshot, restored bit-exact on both."""
    import os as _os

    import pytest as _pytest
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    if rank == 1:
        _os.environ["TSS_TORCH_ASYNC_FORK_HBM_LIMIT_BYTES"] = "0"
    mp = _pytest.MonkeyPatch()
    _stand_in(mp)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("torchsnapshot_tpu_torch.io_preparer").addHandler(handler)
    mesh = DeviceMesh("cpu", list(range(world_size)))
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    w = dtensor_from_numpy(full, mesh, [Shard(0)])
    pending = tts.Snapshot.async_take(_os.path.join(root, "ckpt"), {"s": tts.StateDict(w=w)})
    w.to_local().add_(1.0)
    pending.wait()
    mp.undo()
    tgt = tts.StateDict(w=dtensor_from_numpy(np.zeros_like(full), mesh, [Shard(0)]))
    tts.Snapshot(_os.path.join(root, "ckpt")).restore({"s": tgt}, device="cpu")
    want = dtensor_from_numpy(full, mesh, [Shard(0)]).to_local()
    assert torch.equal(tgt["w"].to_local(), want)
    warned = [r for r in records if "captured through host RAM" in r.getMessage()]
    assert len(warned) == (1 if rank == 1 else 0), rank


def test_ranks_under_different_pressure_compose_one_snapshot(tmp_path):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_mixed_pressure_worker, 2, args=(str(tmp_path),), process_group=True)

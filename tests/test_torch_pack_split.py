"""K1 over a slab too large for device memory
(``batcher.DeviceBatchedBufferStager``, ``batcher._pack_groups``).

A slab pack that raises ``torch.cuda.OutOfMemoryError`` is packed in
halves, recursively, each group one K1 call whose bytes land at its offset
of the host slab: the take commits, the slab's bytes equal the JAX
package's slab of the same numpy members, and one warning is logged. A
member that alone does not fit, and any other pack failure, aborts the
take. Nothing is remembered between takes. The pack is patched to raise
here; ``tests/test_torch_cuda.py`` runs the real out-of-memory case on the
card.
"""

import logging
import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import batcher, kernels
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.utils import knobs as tknobs


def _members():
    rng = np.random.default_rng(3)
    return {
        "a": rng.standard_normal((7, 5)).astype(np.float32),
        "b": rng.integers(-100, 100, 13).astype(np.int64),
        "c": rng.standard_normal(3).astype(np.float16),
        "d": rng.integers(0, 2, 9).astype(np.bool_),
    }


def _nbytes(members):
    return sum(t.numel() * t.element_size() for t in members)


@pytest.fixture
def pack_fits(monkeypatch):
    """Patch K1's wrapper: a group for which ``fits`` is false raises
    ``error``, another packs (the plain version). Returns the member counts
    of the calls."""
    calls = []

    def patch(fits, error=None):
        def pack(members, stream=None):
            calls.append(len(members))
            if not fits(members):
                raise error or torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.00 MiB")
            return kernels.pack_slab_plain(members)

        monkeypatch.setattr(kernels, "pack_slab", pack)
        return calls

    return patch


def _alone(members):
    return len(members) == 1


def _slabs(path):
    root = os.path.join(path, "batched")
    return sorted(open(os.path.join(root, f), "rb").read() for f in os.listdir(root) if "." not in f)


def _take_torch(path):
    with tknobs.override_batching_enabled(True):
        return tts.Snapshot.take(path, {"m": tts.StateDict(from_numpy_tree(_members(), device="cpu"))})


def _restore_exact(path):
    target = tts.StateDict({k: torch.zeros_like(v) for k, v in from_numpy_tree(_members(), device="cpu").items()})
    tts.Snapshot(path).restore({"m": target}, device="cpu")
    for k, v in _members().items():
        assert np.array_equal(target[k].numpy().view(np.uint8), v.view(np.uint8)), k


def _warnings(caplog):
    return [r.getMessage() for r in caplog.records if r.name == "torchsnapshot_tpu_torch.batcher"]


def test_out_of_memory_slab_is_packed_in_groups(tmp_path, pack_fits, caplog):
    calls = pack_fits(_alone)
    path = str(tmp_path / "t")
    with caplog.at_level(logging.WARNING, logger="torchsnapshot_tpu_torch.batcher"):
        _take_torch(path)
    assert calls == [4, 2, 1, 1, 2, 1, 1]
    warnings = _warnings(caplog)
    assert len(warnings) == 1 and "4 members" in warnings[0] and "4 groups" in warnings[0], warnings
    assert tts.Snapshot(path).verify() == {}
    _restore_exact(path)

    jpath = str(tmp_path / "jax")
    with jknobs.override_batching_enabled(True):
        jts.Snapshot.take(jpath, {"m": jts.StateDict(**_members())})
    assert _slabs(path) == _slabs(jpath) and len(_slabs(path)) == 1


def test_every_take_tries_the_whole_slab_first(tmp_path, pack_fits):
    calls = pack_fits(_alone)
    _take_torch(str(tmp_path / "t1"))
    _take_torch(str(tmp_path / "t2"))
    assert calls == [4, 2, 1, 1, 2, 1, 1] * 2
    assert _slabs(str(tmp_path / "t1")) == _slabs(str(tmp_path / "t2"))
    _restore_exact(str(tmp_path / "t2"))


@pytest.mark.parametrize(
    "error",
    [torch.cuda.OutOfMemoryError("CUDA out of memory"), RuntimeError("launch failed")],
    ids=["member_alone_does_not_fit", "other_failure"],
)
def test_failed_pack_aborts_the_take(tmp_path, pack_fits, error):
    calls = pack_fits(lambda members: False, error)
    path = str(tmp_path / "t")
    with pytest.raises(tts.CheckpointAbortedError) as info:
        _take_torch(path)
    assert (info.value.rank, info.value.phase) == (0, "write")
    assert info.value.__cause__ is error
    # Out of memory, the halves go down to the first member; any other
    # error is raised by the whole slab's pack.
    oom = isinstance(error, torch.cuda.OutOfMemoryError)
    assert calls == ([4, 2, 1] if oom else [4])
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


@pytest.mark.parametrize(
    "fits, launches",
    [
        (lambda m: True, 1),
        (lambda m: _nbytes(m) <= 250, 2),  # a, b: 244 bytes; c, d: 15
        (lambda m: _nbytes(m) <= 140, 3),  # a alone (140), b alone, then c, d
        (_alone, 4),
    ],
    ids=["whole", "halves", "mixed", "members"],
)
def test_groups_land_at_their_offsets(pack_fits, fits, launches):
    """Whatever the groups, the host slab is K1's whole-slab bytes."""
    calls = pack_fits(fits)
    members = list(from_numpy_tree(_members(), device="cpu").values())
    host = torch.full((_nbytes(members),), 0xAB, dtype=torch.uint8)
    assert batcher._pack_groups(host, members, None) == launches
    assert torch.equal(host, kernels.pack_slab_plain(members))
    assert calls[0] == 4

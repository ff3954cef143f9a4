"""Tests of the torch port that need an NVIDIA GPU (marker ``cuda``).

They skip on a host without CUDA. This file imports neither JAX nor the
JAX package, so it also runs on a GPU host that has only PyTorch; there,
skip the JAX-importing ``tests/conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import io_preparer, kernels
from torchsnapshot_tpu_torch.utils import knobs

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _members(dtype, device, seed):
    """0-dim, empty, one-element, odd-sized members, a matrix and its
    transposed view; the odd sizes put later members at unaligned slab
    offsets."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape in [(), (0, 3), (1,), (7,), (3, 5), (1001,)]:
        if dtype == torch.bool:
            t = torch.randint(0, 2, shape, generator=g, device=device).bool()
        elif dtype.is_floating_point:
            t = torch.randn(shape, generator=g, device=device).to(dtype)
        else:
            t = torch.randint(0, 100, shape, generator=g, device=device).to(dtype)
        out.append(t)
    out.append(out[4].t())
    return out


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dtype", sorted(kernels.PACKABLE_DTYPES, key=str), ids=str)
def test_pack_slab_kernel_matches_plain(device, dtype):
    members = _members(dtype, device, 1)
    base = torch.arange(300, dtype=torch.uint8, device=device)
    members.append(base[1:200])  # source at an odd address
    before = kernels.LAUNCHES["pack_slab"]
    got = kernels.pack_slab(members)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pack_slab"] == before + 1
    assert torch.equal(got, kernels.pack_slab_plain(members))


@pytest.mark.parametrize("dtype", sorted(kernels.PACKABLE_DTYPES, key=str), ids=str)
def test_fork_copy_kernel_matches_plain(device, dtype):
    members = _members(dtype, device, 2)
    before = kernels.LAUNCHES["fork_copy"]
    copies = kernels.fork_copy(members)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fork_copy"] == before + 1
    for t, c in zip(members, copies):
        assert c.dtype == t.dtype and c.shape == t.shape and c.device == t.device
        if t.numel() > 1:
            assert c.stride() == t.stride() and c.data_ptr() != t.data_ptr()
        assert torch.equal(_bytes(c), _bytes(t))


def test_kernels_on_a_large_member(device):
    big = torch.randn(25_000_000, device=device).to(torch.bfloat16)
    small = torch.arange(3, dtype=torch.int16, device=device)
    assert torch.equal(kernels.pack_slab([small, big]), kernels.pack_slab_plain([small, big]))
    assert torch.equal(kernels.fork_copy([big])[0], big)


@pytest.mark.parametrize("batching", [False, True], ids=["plain", "batched"])
def test_cuda_take_restore_and_async_mutation(device, tmp_path, batching):
    g = torch.Generator(device=device).manual_seed(0)
    state = {
        "w": torch.randn(256, 96, generator=g, device=device).to(torch.bfloat16),
        "wt": torch.randn(64, 32, generator=g, device=device).t(),
        "b": torch.randn(96, generator=g, device=device),
        "step": torch.tensor(3, device=device),
        "cpu": torch.arange(10),
        "n": 5,
    }
    with knobs.override_batching_enabled(batching), knobs.override_max_chunk_size_bytes(16384):
        kernels.reset_launch_counts()
        tts.Snapshot.take(str(tmp_path / "s"), {"m": tts.StateDict(state)})
        if batching:
            assert kernels.LAUNCHES["pack_slab"] >= 1
        assert tts.Snapshot(str(tmp_path / "s")).verify() == {}
        target = tts.StateDict({k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else None for k, v in state.items()})
        tts.Snapshot(str(tmp_path / "s")).restore({"m": target})
        for k, v in state.items():
            if isinstance(v, torch.Tensor):
                assert target[k].device == v.device and torch.equal(_bytes(target[k]), _bytes(v)), k
        got = tts.Snapshot(str(tmp_path / "s")).read_object("0/m/w")
        assert got.is_cuda and torch.equal(got, state["w"])

        before = {k: v.clone() for k, v in state.items() if isinstance(v, torch.Tensor)}
        captured = io_preparer.HOST_CAPTURED["leaves"]
        kernels.reset_launch_counts()
        pending = tts.Snapshot.async_take(str(tmp_path / "a"), {"m": tts.StateDict(state)})
        for v in before:
            state[v].add_(1)
        pending.wait()
        assert kernels.LAUNCHES["fork_copy"] == 1
        assert io_preparer.HOST_CAPTURED["leaves"] == captured
        target = tts.StateDict()
        tts.Snapshot(str(tmp_path / "a")).restore({"m": target})
        for k, v in before.items():
            assert torch.equal(_bytes(target[k].cpu()), _bytes(v.cpu())), k

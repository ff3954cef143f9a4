"""The port's kernels K1 (pack_slab) and K2 (fork_copy).

On the CPU the wrappers run their plain PyTorch versions, which are held
here against the JAX package: K1's bytes must equal
``torchsnapshot_tpu.batcher._pack_to_device_bytes`` run on JAX CPU arrays
of the same values. The CUDA kernels themselves are held against the plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from torchsnapshot_tpu import batcher as jbatcher

from torchsnapshot_tpu_torch import io_preparer, kernels
from torchsnapshot_tpu_torch.convert import from_numpy_tree

# Every K1 dtype torch has, as (torch dtype, numpy dtype).
_PACKABLE = [
    (torch.bool, np.bool_),
    (torch.int8, np.int8),
    (torch.int16, np.int16),
    (torch.int32, np.int32),
    (torch.int64, np.int64),
    (torch.uint8, np.uint8),
    (torch.uint16, np.uint16),
    (torch.uint32, np.uint32),
    (torch.uint64, np.uint64),
    (torch.float16, np.float16),
    (torch.float32, np.float32),
    (torch.float64, np.float64),
    (torch.bfloat16, ml_dtypes.bfloat16),
    (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
    (torch.float8_e5m2, ml_dtypes.float8_e5m2),
    (torch.float8_e4m3fnuz, ml_dtypes.float8_e4m3fnuz),
    (torch.float8_e5m2fnuz, ml_dtypes.float8_e5m2fnuz),
]
assert {t for t, _ in _PACKABLE} == kernels.PACKABLE_DTYPES


def _values(np_dtype, shape, rng):
    if np.dtype(np_dtype) == np.bool_:
        return rng.integers(0, 2, shape).astype(np.bool_)
    if np.dtype(np_dtype).kind in "iu":
        info = np.iinfo(np_dtype)
        return rng.integers(max(info.min, -1000), min(info.max, 1000), shape).astype(np_dtype)
    return rng.standard_normal(shape).astype(np_dtype)


def _members(np_dtype, seed):
    """0-dim, 0-size, odd counts (unaligned slab offsets) and a matrix."""
    rng = np.random.default_rng(seed)
    return [
        _values(np_dtype, (), rng),
        _values(np_dtype, (0, 3), rng),
        _values(np_dtype, (7,), rng),
        _values(np_dtype, (3, 5), rng),
        _values(np_dtype, (1,), rng),
    ]


def _reference_pack(arrays):
    with jax.enable_x64(True):
        arrs = tuple(jax.device_put(a) for a in arrays)
        packed = jbatcher._pack_to_device_bytes(jbatcher._pack_key(arrs), arrs)
        return np.asarray(packed)


@pytest.mark.parametrize("dtype", [t for t, _ in _PACKABLE], ids=str)
def test_pack_slab_plain_matches_reference(dtype):
    np_dtype = dict(_PACKABLE)[dtype]
    arrays = _members(np_dtype, seed=3)
    tensors = from_numpy_tree(arrays)
    assert all(t.dtype == dtype for t in tensors)
    got = kernels.pack_slab_plain(tensors)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _reference_pack(arrays))


def test_pack_slab_transposed_view_is_c_order():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    t = torch.from_numpy(a.copy()).t()  # a non-contiguous view
    assert not t.is_contiguous()
    got = kernels.pack_slab_plain([t, torch.tensor([True, False])])
    np.testing.assert_array_equal(got.numpy(), _reference_pack([a.T, np.array([True, False])]))


def test_pack_slab_wrapper_on_cpu_runs_the_plain_version():
    kernels.reset_launch_counts()
    ts = [torch.arange(5, dtype=torch.int16), torch.ones(2, 3).t()]
    assert torch.equal(kernels.pack_slab(ts), kernels.pack_slab_plain(ts))
    assert kernels.LAUNCHES["pack_slab"] == 0


def test_pack_slab_refuses_unpackable_dtype():
    with pytest.raises(TypeError):
        kernels.pack_slab([torch.zeros(2, dtype=torch.complex64)])


@pytest.mark.parametrize("dtype", [t for t, _ in _PACKABLE], ids=str)
def test_fork_copy_plain_is_bitwise_and_unaliased(dtype):
    tensors = from_numpy_tree(_members(dict(_PACKABLE)[dtype], seed=4))
    tensors.append(tensors[3].t())  # strided view
    copies = kernels.fork_copy(tensors)
    assert kernels.LAUNCHES["fork_copy"] == 0
    for t, c in zip(tensors, copies):
        assert c.dtype == t.dtype and c.shape == t.shape
        if t.numel():
            assert c.data_ptr() != t.data_ptr()
        assert torch.equal(
            c.contiguous().reshape(-1).view(torch.uint8),
            t.contiguous().reshape(-1).view(torch.uint8),
        )


def test_dense_precondition():
    m = torch.zeros(4, 6)
    assert kernels._is_dense(m.t())
    assert not kernels._is_dense(m[:, :3])
    assert kernels._is_dense(torch.zeros(0, 3).t())


def test_fork_bisects_on_out_of_memory_then_host_captures():
    """The reference's bisection: a group whose fork fails is split in two
    (depth 2); a quarter that still fails is captured through the host."""
    group = [torch.full((n,), float(n)) for n in (1, 2, 3, 4, 5, 6, 7, 8)]
    calls = []

    def fork(g):
        calls.append(len(g))
        if sum(t.numel() for t in g) > 10:
            raise torch.cuda.OutOfMemoryError("simulated")
        return [t.clone() for t in g]

    captured = []
    out = io_preparer._fork_or_capture(group, fork, lambda g: [t.clone() for t in g], captured)
    assert [torch.equal(a, b) for a, b in zip(out, group)] == [True] * 8
    # [1..4] fits at depth 1; [5..8] fails and splits; its halves [5,6]
    # and [7,8] still fail at depth 2 and are captured.
    assert calls == [8, 4, 4, 2, 2]
    assert captured == group[4:]

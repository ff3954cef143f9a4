"""The port's shipped test utilities (``torchsnapshot_tpu_torch.test_utils``)
against the cases of ``tests/test_test_utils.py``, and ``rand_array``'s
bytes against the JAX package's for every dtype torch holds."""

import numpy as np
import pytest
import torch

from torchsnapshot_tpu.serialization import SUPPORTED_DTYPES
from torchsnapshot_tpu.test_utils import rand_array as jrand_array

from torchsnapshot_tpu_torch.serialization import BYTE_VIEW_DTYPES, string_to_dtype
from torchsnapshot_tpu_torch.test_utils import assert_state_dict_eq, check_state_dict_eq, rand_array


def _state():
    return {
        "w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.ones(4, dtype=torch.bfloat16), "n": np.ones(3), "s": "str", "i": 3},
        "lst": [1, np.float64(2.5), (3, 4)],
    }


def test_equal_nested_state_dicts():
    assert check_state_dict_eq(_state(), _state())
    assert_state_dict_eq(_state(), _state())
    assert_state_dict_eq(object(), _state(), _state())  # (test_case, a, b)


@pytest.mark.parametrize(
    "a, b",
    [
        ({"k": torch.ones(3)}, {"k": torch.ones(4)}),  # shape
        ({"k": torch.ones(3)}, {"k": torch.ones(3, dtype=torch.float64)}),  # dtype
        ({"k": torch.ones(3)}, {"k": torch.zeros(3)}),  # values
        ({"k": 1}, {"j": 1}),  # keys
        ({"k": [1, 2]}, {"k": [1, 2, 3]}),  # list length
        ({"k": torch.ones(3)}, {"k": "ones"}),  # array vs non-array
        ({"k": 1}, {"k": 2}),  # scalars
        ({"k": np.ones(3, np.float32)}, {"k": torch.ones(3, dtype=torch.float64)}),  # numpy vs torch dtype
    ],
)
def test_unequal_state_dicts(a, b):
    assert not check_state_dict_eq(a, b)
    with pytest.raises(AssertionError):
        assert_state_dict_eq(a, b)


def test_numpy_and_torch_leaves_compare_by_bytes():
    w = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    assert check_state_dict_eq({"w": w}, {"w": torch.from_numpy(w.copy())})
    assert check_state_dict_eq({"s": np.float64(2.5)}, {"s": torch.tensor(2.5, dtype=torch.float64)})


def test_nan_bitwise_equality():
    a = torch.tensor([float("nan"), 1.0], dtype=torch.float64)
    b = a.clone()
    assert check_state_dict_eq({"k": a}, {"k": b}, exact=True)
    # Flip one mantissa bit inside the NaN.
    c = a.clone()
    c.view(torch.int64)[0] ^= 1
    assert not check_state_dict_eq({"k": a}, {"k": c}, exact=True)
    # allclose mode: NaNs never compare equal.
    assert not check_state_dict_eq({"k": a}, {"k": b}, exact=False)


def test_inexact_mode_tolerates_rounding():
    a = {"k": torch.tensor([1.0, 2.0], dtype=torch.float64)}
    b = {"k": torch.tensor([1.0 + 1e-12, 2.0], dtype=torch.float64)}
    assert check_state_dict_eq(a, b, exact=False)
    assert not check_state_dict_eq(a, b, exact=True)


def test_dtensor_leaf_compares_its_full_tensor():
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch.convert import dtensor_from_tensor
    from torchsnapshot_tpu_torch.parallel.store import free_port

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        full = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        assert check_state_dict_eq({"t": dtensor_from_tensor(full, mesh, [Shard(0)])}, {"t": full})
        assert check_state_dict_eq(
            {"t": dtensor_from_tensor(full, mesh, [Shard(0)])}, {"t": dtensor_from_tensor(full, mesh, [Replicate()])}
        )
        assert not check_state_dict_eq({"t": dtensor_from_tensor(full, mesh, [Shard(1)])}, {"t": full + 1})
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", sorted(SUPPORTED_DTYPES))
def test_rand_array_bytes_match_the_jax_package(dtype):
    if dtype in BYTE_VIEW_DTYPES:
        with pytest.raises(TypeError):
            rand_array((4, 5), dtype, seed=0, device="cpu")
        return
    arr = rand_array((4, 5), dtype, seed=0, device="cpu")
    assert arr.shape == (4, 5) and arr.dtype == string_to_dtype(dtype) and arr.device.type == "cpu"
    want = jrand_array((4, 5), dtype, seed=0)
    assert arr.contiguous().view(-1).view(torch.uint8).numpy().tobytes() == want.tobytes()
    # Deterministic under a fixed seed, and a torch dtype names the same.
    again = rand_array((4, 5), arr.dtype, seed=0, device="cpu")
    assert check_state_dict_eq({"a": arr}, {"a": again})


def test_rand_array_is_nonconstant_and_defaults_to_the_card():
    arr = rand_array((64,), "float32", seed=1, device="cpu")
    assert len(torch.unique(arr)) > 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rand_array((4,), "float32", seed=1)

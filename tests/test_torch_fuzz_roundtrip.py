"""Seeded random round trips across the packages: the counterpart of
``tests/test_fuzz_roundtrip.py``.

The same generator (a copy, in numpy) makes an arbitrary nested state from
each of 18 seeds, under the same knob grid set on both packages: batching
and a 64-byte chunk size on odd seeds, the codec ``none``/``zstd``/``zlib``
by ``seed % 3``, and 48-byte compression frames below seed 12. Each seed
runs three legs, each bit-exact against the generated state:

- ``port``: the port takes and restores, ``verify() == {}``, and a
  budgeted ``read_object`` of one array leaf reads it back;
- ``port_to_jax``: the port takes and the JAX package restores;
- ``jax_to_port``: the JAX package takes and the port restores.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from torchsnapshot_tpu_torch.utils import knobs as tknobs

_DTYPES = [
    np.float32,
    np.float64,
    np.float16,
    np.int8,
    np.int32,
    np.int64,
    np.uint8,
    np.bool_,
]


def _random_value(rng: np.random.Generator, depth: int):
    roll = rng.integers(0, 10 if depth < 3 else 6)
    if roll < 2:  # primitive
        return rng.choice(
            [int(rng.integers(-1000, 1000)), float(rng.standard_normal()), "s", None, True]
        )
    if roll < 5:  # array
        shape = tuple(int(s) for s in rng.integers(1, 6, size=rng.integers(0, 4)))
        dtype = _DTYPES[rng.integers(0, len(_DTYPES))]
        if dtype is np.bool_:
            return rng.integers(0, 2, size=shape).astype(dtype)
        return (rng.standard_normal(shape) * 100).astype(dtype)
    if roll < 6:  # arbitrary pickled object
        return {"tuple": (1, 2), "set_like": [3, 4]}
    if roll < 8:  # nested dict with adversarial keys
        keys = ["plain", "with/slash", "with%percent", "", "0", "nested"]
        return {
            keys[int(i)]: _random_value(rng, depth + 1)
            for i in rng.integers(0, len(keys), size=rng.integers(1, 4))
        }
    # nested list
    return [_random_value(rng, depth + 1) for _ in range(rng.integers(1, 4))]


def _state(seed):
    """The generated state and the rng, positioned as the JAX test's is
    after it built its StateDict."""
    rng = np.random.default_rng(seed)
    state = {f"k{i}": _random_value(rng, 0) for i in range(int(rng.integers(1, 8)))}
    return state, rng


@contextlib.contextmanager
def _grid(knobs, seed):
    """The JAX test's knob grid for ``seed``, through one package's knobs."""
    with contextlib.ExitStack() as stack:
        if seed % 2:
            stack.enter_context(knobs.override_batching_enabled(True))
            stack.enter_context(knobs.override_max_chunk_size_bytes(64))
        codec = ("none", "zstd", "zlib")[seed % 3]
        if codec == "zstd":
            pytest.importorskip("zstandard", reason="zstd seeds need the zstandard package")
        if codec != "none":
            stack.enter_context(knobs.override_compression(codec))
            if seed < 12:
                stack.enter_context(knobs.override_compression_frame_bytes(48))
        yield


def _as_numpy(value):
    if isinstance(value, torch.Tensor):
        return to_numpy_tree(value)
    if not isinstance(value, (np.ndarray, np.generic)) and hasattr(value, "__array__"):
        return np.asarray(value)  # a JAX array
    return value


def _assert_same(expected, got, where="s"):
    """Bit-exact: arrays by dtype, shape and bytes; containers by type and
    keys; every other leaf by type and value."""
    got = _as_numpy(got)
    if isinstance(expected, np.ndarray):
        assert isinstance(got, np.ndarray), (where, type(got))
        assert (got.dtype, got.shape) == (expected.dtype, expected.shape), where
        assert got.tobytes() == expected.tobytes(), where
    elif isinstance(expected, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(expected), (where, got)
        for k in expected:
            _assert_same(expected[k], got[k], f"{where}/{k}")
    elif isinstance(expected, (list, tuple)):
        assert type(got) is type(expected) and len(got) == len(expected), (where, got)
        for i, (e, g) in enumerate(zip(expected, got)):
            _assert_same(e, g, f"{where}/{i}")
    else:
        assert type(got) is type(expected) and got == expected, (where, expected, got)


def _port_take(path, state, seed):
    with _grid(tknobs, seed):
        tts.Snapshot.take(path, {"s": tts.StateDict(from_numpy_tree(copy.deepcopy(state), device="cpu"))})


def _port_restore(path):
    out = tts.StateDict()
    tts.Snapshot(path).restore({"s": out}, device="cpu")
    return dict(out)


LEGS = ("port", "port_to_jax", "jax_to_port")


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("seed", range(18))
def test_random_state_roundtrip_across_packages(tmp_path, seed, leg):
    state, rng = _state(seed)
    expected = copy.deepcopy(state)
    path = str(tmp_path / "ckpt")
    if leg == "jax_to_port":
        with _grid(jknobs, seed):
            jts.Snapshot.take(path, {"s": jts.StateDict(**copy.deepcopy(state))})
    else:
        _port_take(path, state, seed)
    if leg == "port_to_jax":
        out = jts.StateDict()
        jts.Snapshot(path).restore({"s": out})
        _assert_same(expected, dict(out))
        return
    _assert_same(expected, _port_restore(path))
    if leg == "jax_to_port":
        return
    assert tts.Snapshot(path).verify() == {}
    # Budgeted random access of one array leaf, chosen as the JAX test does.
    array_keys = [k for k, v in expected.items() if isinstance(v, np.ndarray)]
    if array_keys:
        k = array_keys[int(rng.integers(0, len(array_keys)))]
        got = tts.Snapshot(path).read_object(f"0/s/{k}", device="cpu", memory_budget_bytes=64)
        _assert_same(expected[k], got, k)

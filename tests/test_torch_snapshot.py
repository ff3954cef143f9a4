"""Snapshots across the two packages, and the port's own API contracts.

A snapshot written by the JAX package restores bit-exactly through the
port and the other way round, with batching on and off, forced chunking,
objects and primitives. Bits are compared through integer views, never
through a wider float.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from torchsnapshot_tpu_torch.utils import knobs as tknobs

from test_torch_format import make_tree


@pytest.fixture(autouse=True)
def _pin_digests(monkeypatch):
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")


def _bits(x):
    """A comparable, bit-exact form of a leaf."""
    if isinstance(x, torch.Tensor):
        x = to_numpy_tree(x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.dtype.name, x.shape, np.ascontiguousarray(x).view(np.uint8).tobytes())
    return x


def _assert_tree_bits_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict)), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_bits_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_bits_equal(x, y)
    else:
        assert _bits(a) == _bits(b)


def _knobs(batching, chunk):
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(jknobs.override_batching_enabled(batching))
    stack.enter_context(tknobs.override_batching_enabled(batching))
    if chunk:
        stack.enter_context(jknobs.override_max_chunk_size_bytes(chunk))
        stack.enter_context(tknobs.override_max_chunk_size_bytes(chunk))
    return stack


_MODES = pytest.mark.parametrize(
    "batching,chunk",
    [(False, None), (True, None), (False, 200), (True, 200)],
    ids=["plain", "batched", "chunked", "batched-chunked"],
)


@_MODES
def test_jax_writes_port_restores(tmp_path, batching, chunk):
    tree = make_tree(10)
    # A device leaf on the JAX side too (bf16 jax.Array).
    tree["dev"] = jax.device_put(np.arange(12, dtype=np.float32).reshape(3, 4))
    path = str(tmp_path / "ckpt")
    with _knobs(batching, chunk):
        jts.Snapshot.take(path, {"m": jts.StateDict(tree)})
    expected = dict(tree)
    expected["dev"] = np.asarray(tree["dev"])
    # Live targets: zeroed tensors for half of the leaves (in-place path),
    # nothing for the rest (fresh tensors on the CPU).
    live = {k: torch.zeros_like(v) for k, v in from_numpy_tree(expected).items()
            if isinstance(v, torch.Tensor) and k in ("w", "b", "i64", "flag", "dev")}
    live_ids = {k: id(v) for k, v in live.items()}
    target = tts.StateDict(live)
    tts.Snapshot(path).restore({"m": target}, device="cpu")
    _assert_tree_bits_equal(dict(target), from_numpy_tree(expected))
    for k, i in live_ids.items():
        assert id(target[k]) == i, f"{k} was not restored in place"


@_MODES
def test_port_writes_jax_restores(tmp_path, batching, chunk):
    tree = make_tree(11)
    path = str(tmp_path / "ckpt")
    with _knobs(batching, chunk):
        tts.Snapshot.take(path, {"m": tts.StateDict(from_numpy_tree(tree))})
    target = jts.StateDict()
    jts.Snapshot(path).restore({"m": target})
    _assert_tree_bits_equal(dict(target), tree)
    assert jts.Snapshot(path).verify() == {}


@_MODES
def test_port_round_trip_and_verify(tmp_path, batching, chunk):
    tree = from_numpy_tree(make_tree(12))
    tree["view"] = torch.arange(30, dtype=torch.float32).reshape(5, 6).t()  # non-contiguous
    tree["param"] = torch.nn.Parameter(torch.ones(4, 2))
    path = str(tmp_path / "ckpt")
    with _knobs(batching, chunk):
        snap = tts.Snapshot.take(path, {"m": tts.StateDict(tree)})
    assert snap.verify() == {}
    target = tts.StateDict()
    tts.Snapshot(path).restore({"m": target}, device="cpu")
    expected = dict(tree)
    expected["param"] = tree["param"].detach()
    _assert_tree_bits_equal(dict(target), expected)
    got = tts.Snapshot(path).read_object("0/m/w", device="cpu")
    _assert_tree_bits_equal(got, tree["w"])
    sub = tts.Snapshot(path).read_object("0/m/nested", device="cpu")
    _assert_tree_bits_equal(sub, tree["nested"])
    assert tts.Snapshot(path).read_object("0/m/step", device="cpu") == 7


def test_read_object_in_place_and_budgeted(tmp_path):
    x = torch.arange(1000, dtype=torch.float32)
    path = str(tmp_path / "ckpt")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=x)})
    out = torch.zeros(1000)
    got = tts.Snapshot(path).read_object("0/m/x", obj_out=out, memory_budget_bytes=128)
    assert got is out and torch.equal(out, x)


def test_verify_detects_corruption(tmp_path):
    path = str(tmp_path / "ckpt")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=torch.arange(64, dtype=torch.int32))})
    with open(os.path.join(path, "0", "m", "x"), "r+b") as f:
        f.seek(3)
        f.write(b"\xff")
    problems = tts.Snapshot(path).verify()
    assert list(problems) == ["0/m/x"] and "crc mismatch" in problems["0/m/x"]
    os.remove(os.path.join(path, "0", "m", "x"))
    assert tts.Snapshot(path).verify() == {"0/m/x": "missing"}


def test_metadata_and_manifest(tmp_path):
    path = str(tmp_path / "ckpt")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=torch.ones(2), n=3)})
    snap = tts.Snapshot(path)
    assert snap.metadata.world_size == 1
    assert set(snap.get_manifest()) == {"0/m", "0/m/x", "0/m/n"}


def test_error_contracts(tmp_path):
    path = str(tmp_path / "ckpt")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=torch.ones(2))})
    with pytest.raises(KeyError):
        tts.Snapshot(path).read_object("0/m/nope", device="cpu")
    with pytest.raises(TypeError):
        tts.Snapshot.take(str(tmp_path / "bad"), {"m": object()})
    with pytest.raises(FileNotFoundError):
        tts.Snapshot(str(tmp_path / "never")).restore({"m": tts.StateDict()}, device="cpu")
    with pytest.raises(KeyError):
        tts.Snapshot(path).restore({"other": tts.StateDict()}, device="cpu")


def test_compressed_entry_refused(tmp_path):
    """A compressed entry is no longer refused: the port decodes the JAX
    package's zstd payload (tests/test_torch_compression.py covers the
    codecs in depth)."""
    pytest.importorskip("zstandard")
    path = str(tmp_path / "ckpt")
    with jknobs.override_compression("zstd"):
        jts.Snapshot.take(path, {"m": jts.StateDict(x=np.arange(64, dtype=np.float32))})
    target = tts.StateDict(x=torch.zeros(64))
    tts.Snapshot(path).restore({"m": target}, device="cpu")
    assert torch.equal(target["x"], torch.arange(64, dtype=torch.float32))


@pytest.mark.parametrize("batching", [False, True], ids=["plain", "batched"])
def test_async_take_snapshot_survives_in_place_mutation(tmp_path, batching):
    """CPU tensors mutated in place right after async_take returns do not
    change the snapshot (the optimizer-step hazard)."""
    tree = {f"p{i}": torch.randn(50, 7, generator=torch.Generator().manual_seed(i)) for i in range(6)}
    tree["step"] = torch.tensor(5)
    before = {k: v.clone() for k, v in tree.items()}
    path = str(tmp_path / "ckpt")
    with _knobs(batching, None):
        pending = tts.Snapshot.async_take(path, {"m": tts.StateDict(tree)})
    for v in tree.values():
        v.add_(1)
    pending.wait()
    assert pending.done()
    target = tts.StateDict()
    tts.Snapshot(path).restore({"m": target}, device="cpu")
    _assert_tree_bits_equal(dict(target), before)


def test_module_and_optimizer_are_stateful(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.LayerNorm(4))
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.randn(3, 6)).sum().backward()
    opt.step()
    path = str(tmp_path / "ckpt")
    tts.Snapshot.take(path, {"model": model, "optim": opt})
    want_model = {k: v.clone() for k, v in model.state_dict().items()}
    want_exp_avg = opt.state_dict()["state"][0]["exp_avg"].clone()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    opt2 = torch.optim.Adam(model.parameters(), lr=0.5)
    tts.Snapshot(path).restore({"model": model, "optim": opt2}, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_model[k]), k
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"], want_exp_avg)
    assert opt2.param_groups[0]["lr"] == 0.1


def test_rng_state_is_captured_at_take_start(tmp_path):
    path = str(tmp_path / "ckpt")
    rng = tts.RNGState()
    torch.manual_seed(1)
    np.random.seed(1)
    tts.Snapshot.take(path, {"rng": rng})
    a = (torch.rand(3), np.random.rand(2))
    tts.Snapshot(path).restore({"rng": rng}, device="cpu")
    b = (torch.rand(3), np.random.rand(2))
    assert torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_coordinator_is_the_third_positional_argument(tmp_path):
    """``take``/``async_take`` take ``(path, app_state, coordinator,
    replicated)`` in the JAX package's order, so a positional coordinator
    is not read as a list of globs."""
    import inspect

    from torchsnapshot_tpu_torch.parallel.coordinator import Coordinator
    from torchsnapshot_tpu_torch.parallel.store import LocalStore

    for name in ("take", "async_take"):
        port = list(inspect.signature(getattr(tts.Snapshot, name)).parameters)[:4]
        ref = list(inspect.signature(getattr(jts.Snapshot, name)).parameters)[:4]
        assert port == ref == ["path", "app_state", "coordinator", "replicated"], name
    coord = Coordinator(LocalStore(), 0, 1)
    app = {"m": tts.StateDict(x=torch.arange(4), y=torch.ones(2))}
    tts.Snapshot.take(str(tmp_path / "a"), app, coord)
    tts.Snapshot.async_take(str(tmp_path / "b"), app, coord, ["m/x"]).wait()
    manifest = tts.Snapshot(str(tmp_path / "b")).get_manifest()
    assert manifest["0/m/x"].replicated and not manifest["0/m/y"].replicated
    for path in ("a", "b"):
        got = tts.StateDict(x=torch.zeros(4, dtype=torch.int64), y=torch.zeros(2))
        tts.Snapshot(str(tmp_path / path), coord).restore({"m": got}, device="cpu")
        assert torch.equal(got["x"], app["m"]["x"]) and torch.equal(got["y"], app["m"]["y"])

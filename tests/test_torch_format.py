"""Format parity of the torch port with the JAX package.

The same inputs, made from a numpy seed, go through both packages: dtype
strings, flatten, the committed manifest, the object files and the
``.checksums.0`` sidecars must agree exactly (apart from the version
string, and the random ``batched/<uuid>`` slab names).
"""

import json
import os
from collections import OrderedDict
from fractions import Fraction

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import flatten as jflatten
from torchsnapshot_tpu import serialization as jser
from torchsnapshot_tpu.manifest import entry_to_dict as jentry_to_dict
from torchsnapshot_tpu.memoryview_stream import MemoryviewStream as JStream
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import flatten as tflatten
from torchsnapshot_tpu_torch import serialization as tser
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.manifest import entry_to_dict as tentry_to_dict
from torchsnapshot_tpu_torch.memoryview_stream import MemoryviewStream as TStream
from torchsnapshot_tpu_torch.utils import knobs as tknobs


@pytest.fixture(autouse=True)
def _pin_digests(monkeypatch):
    # tests/conftest.py pins the reference's sha256 digests on; pin the
    # port's knob the same way so the sidecars are comparable.
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")


@pytest.mark.parametrize("name", sorted(jser.SUPPORTED_DTYPES))
def test_dtype_string_parity(name):
    np_dtype = jser.SUPPORTED_DTYPES[name]
    t_dtype = tser.string_to_dtype(name)
    if name in tser.BYTE_VIEW_DTYPES:
        # No torch dtype: one stored byte per element, restored as uint8.
        assert np_dtype.itemsize == 1
        assert t_dtype == torch.uint8
        return
    assert tser.dtype_to_string(t_dtype) == name
    assert t_dtype.itemsize == np_dtype.itemsize


@pytest.mark.parametrize(
    "dtype", [torch.int4, torch.uint4, torch.float4_e2m1fn_x2], ids=str
)
def test_torch_sub_byte_dtypes_refused(dtype):
    with pytest.raises(TypeError):
        tser.dtype_to_string(dtype)


def _nested():
    return {
        "a": {"b": [1, 2, {"c": "x"}], "d%/e": 3.5},
        "od": OrderedDict([("z", 1), ("y", [None, b"q"])]),
        "ints": {1: "one", 2: "two"},
        "opaque": {1: "a", "1": "b"},  # colliding keys stay a leaf
        "empty": {},
        "lst": [],
    }


@pytest.mark.parametrize("prefix", ["", "app", "a/b"])
def test_flatten_parity(prefix):
    jm, jf = jflatten.flatten(_nested(), prefix=prefix)
    tm, tf = tflatten.flatten(_nested(), prefix=prefix)
    assert {k: jentry_to_dict(v) for k, v in jm.items()} == {
        k: tentry_to_dict(v) for k, v in tm.items()
    }
    assert list(jf) == list(tf) and jf == tf
    assert tflatten.inflate(tm, tf, prefix=prefix) == jflatten.inflate(jm, jf, prefix=prefix)


def make_tree(seed: int):
    """A state of every kind of leaf, as numpy (the JAX package's host
    form); the port gets the same values through ``from_numpy_tree``."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((48, 20)).astype(ml_dtypes.bfloat16),
        "b": rng.standard_normal(20).astype(np.float32),
        "f64": rng.standard_normal((3, 5)),
        "f16": rng.standard_normal(7).astype(np.float16),
        "i8": rng.integers(-100, 100, 13).astype(np.int8),
        "u16": rng.integers(0, 60000, (2, 3)).astype(np.uint16),
        "i64": rng.integers(-(2**40), 2**40, 4).astype(np.int64),
        "u64": rng.integers(0, 2**62, 3).astype(np.uint64),
        "flag": rng.integers(0, 2, 9).astype(bool),
        "f8": rng.standard_normal(11).astype(ml_dtypes.float8_e4m3fn),
        "f8b": rng.standard_normal(6).astype(ml_dtypes.float8_e5m2),
        "c64": (rng.standard_normal(4) + 1j * rng.standard_normal(4)).astype(np.complex64),
        "scalar": np.array(3, dtype=np.int32),
        "empty": np.zeros((0, 4), dtype=np.float32),
        "nested": {"x": rng.standard_normal((6, 2)).astype(np.float32), "lst": [np.arange(5, dtype=np.int16), 4]},
        "step": 7,
        "lr": 0.125,
        "name": "run",
        "on": True,
        "nothing": None,
        "blob": b"\x00\x01",
        "obj": (1, "a", 2.5),
        "frac": Fraction(1, 3),
    }


def take_both(tmp_path, tree, *, batching=False, chunk=None, grain=None):
    """Take ``tree`` with the JAX package (numpy leaves) and with the port
    (torch leaves); returns the two snapshot directories."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    env = {
        "TORCHSNAPSHOT_TPU_ENABLE_BATCHING": "1" if batching else "0",
        "TSS_TORCH_ENABLE_BATCHING": "1" if batching else "0",
    }
    if chunk is not None:
        env["TORCHSNAPSHOT_TPU_MAX_CHUNK_SIZE_BYTES"] = str(chunk)
        env["TSS_TORCH_MAX_CHUNK_SIZE_BYTES"] = str(chunk)
    if grain is not None:
        env["TORCHSNAPSHOT_TPU_HASH_CHUNK_BYTES"] = str(grain)
        env["TSS_TORCH_HASH_CHUNK_BYTES"] = str(grain)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jts.Snapshot.take(jdir, {"m": jts.StateDict(tree)})
        tts.Snapshot.take(tdir, {"m": tts.StateDict(from_numpy_tree(tree, device="cpu"))})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return jdir, tdir


def _metadata(d):
    with open(os.path.join(d, ".snapshot_metadata")) as f:
        md = json.load(f)
    md.pop("version")
    return md


def _array_entries(manifest):
    """(key, array-entry dict) for every array entry, chunks included."""
    for key, e in manifest.items():
        if e["type"] == "array":
            yield key, e
        for i, c in enumerate(e.get("chunks", [])):
            yield f"{key}#{i}", c["tensor"]


def _normalized(md):
    """Rename each batched/<uuid> slab after its first member."""
    members = {}
    for key, e in _array_entries(md["manifest"]):
        if e["location"].startswith("batched/"):
            members.setdefault(e["location"], []).append(key)
    names = {loc: "batched/" + min(keys) for loc, keys in members.items()}
    for _key, e in _array_entries(md["manifest"]):
        e["location"] = names.get(e["location"], e["location"])
    return md, names


def _files(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.relpath(os.path.join(root, f), d)
            with open(os.path.join(root, f), "rb") as fh:
                out[p] = fh.read()
    return out


@pytest.mark.parametrize("batching", [False, True], ids=["plain", "batched"])
@pytest.mark.parametrize("chunk", [None, 200], ids=["whole", "chunked"])
def test_same_tree_same_manifest_and_objects(tmp_path, batching, chunk):
    tree = make_tree(0)
    if not batching:
        # A dtype with no raw form: pickled whole, or per chunk when
        # chunked. (With batching on the JAX package's batcher cannot size
        # such an entry and aborts the take: ROADMAP section C.)
        tree["strs"] = np.array([f"s{i}" for i in range(64)])
    jdir, tdir = take_both(tmp_path, tree, batching=batching, chunk=chunk)
    jmd, jnames = _normalized(_metadata(jdir))
    tmd, tnames = _normalized(_metadata(tdir))
    assert jmd == tmd
    strs = tmd["manifest"].get("0/m/strs")
    if strs is None:
        assert batching
    elif chunk is None:
        assert (strs["type"], strs["serializer"], strs["dtype"], strs["shape"]) == ("array", "pickle", "<U3", [64])
    else:
        assert strs["type"] == "chunked_array" and strs["dtype"] == "<U3"
        assert {c["tensor"]["serializer"] for c in strs["chunks"]} == {"pickle"}
    # Object files byte-identical, slab files matched through their members.
    jfiles = {jnames.get(p, p): b for p, b in _files(jdir).items()}
    tfiles = {tnames.get(p, p): b for p, b in _files(tdir).items()}
    for files in (jfiles, tfiles):
        files.pop(".snapshot_metadata")
        files.pop(".checksums.0")
        for p in [p for p in files if p.startswith(".telemetry")]:
            files.pop(p)
    assert jfiles == tfiles
    if chunk is not None:
        assert any(e["type"] == "chunked_array" for e in tmd["manifest"].values())
    if batching:
        assert any(p.startswith("batched/") for p in tfiles)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_chunked_pickled_array_restores_across_packages(tmp_path, writer):
    """A ``<U3`` array above the chunk size is 13 pickled chunks; both
    ``restore`` and ``read_object`` give it back exactly, whichever package
    wrote it."""
    arr = np.array([f"s{i}" for i in range(64)])
    path = str(tmp_path / "s")
    if writer == "jax":
        with jknobs.override_max_chunk_size_bytes(64):
            jts.Snapshot.take(path, {"m": jts.StateDict(s=arr)})
    else:
        with tknobs.override_max_chunk_size_bytes(64):
            tts.Snapshot.take(path, {"m": tts.StateDict(from_numpy_tree({"s": arr}, device="cpu"))})
    entry = _metadata(path)["manifest"]["0/m/s"]
    assert entry["type"] == "chunked_array" and len(entry["chunks"]) == 13
    assert {c["tensor"]["serializer"] for c in entry["chunks"]} == {"pickle"}
    out = tts.StateDict(s=None)
    tts.Snapshot(path).restore({"m": out}, device="cpu")
    assert out["s"].dtype == arr.dtype and out["s"].tobytes() == arr.tobytes()
    got = tts.Snapshot(path).read_object("0/m/s", device="cpu")
    assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()
    live = np.empty_like(arr)
    out = tts.StateDict(s=live)
    tts.Snapshot(path).restore({"m": out}, device="cpu")
    assert out["s"] is live and live.tobytes() == arr.tobytes()
    jout = jts.StateDict(s=None)
    jts.Snapshot(path).restore({"m": jout})
    assert np.asarray(jout["s"]).tobytes() == arr.tobytes()


def test_pickled_array_stays_out_of_slabs(tmp_path):
    """With batching on, the port writes a ``<U3`` leaf as its own pickled
    object beside the slabs (the JAX package's batcher aborts such a take),
    and the JAX package restores it."""
    tree = make_tree(3)
    tree["strs"] = np.array([f"s{i}" for i in range(64)])
    path = str(tmp_path / "s")
    with tknobs.override_batching_enabled(True):
        tts.Snapshot.take(path, {"m": tts.StateDict(from_numpy_tree(tree, device="cpu"))})
    manifest = _metadata(path)["manifest"]
    assert manifest["0/m/strs"]["location"] == "0/m/strs" and manifest["0/m/strs"]["serializer"] == "pickle"
    assert any(e.get("location", "").startswith("batched/") for e in manifest.values())
    jout = jts.StateDict(strs=None)
    jts.Snapshot(path).restore({"m": jout})
    assert np.asarray(jout["strs"]).tobytes() == tree["strs"].tobytes()


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_pickled_array_on_a_prepared_hit(tmp_path, chunk):
    """A second take of the same structure rebinds the pickled array's
    stagers (whole, or one per chunk) to the new values."""
    from torchsnapshot_tpu_torch import prepare_cache
    from torchsnapshot_tpu_torch import snapshot as tsnapshot
    from torchsnapshot_tpu_torch.parallel.coordinator import get_coordinator

    prepare_cache.reset(get_coordinator())
    env = {} if chunk is None else {"TSS_TORCH_MAX_CHUNK_SIZE_BYTES": str(chunk)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for i in range(2):
            arr = np.array([f"v{i}{j}" for j in range(64)])
            path = str(tmp_path / f"s{i}")
            tts.Snapshot.async_take(path, {"m": tts.StateDict(s=arr, x=torch.ones(3))}).wait()
            assert tsnapshot.LAST_TAKE_CACHE["prepared_cache_hit"] == (i == 1)
            got = tts.Snapshot(path).read_object("0/m/s", device="cpu")
            assert got.tobytes() == arr.tobytes()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("grain", [0, 1 << 20, 64], ids=["serial", "single_chunk", "many_chunks"])
def test_same_tree_same_sidecar(tmp_path, grain):
    jdir, tdir = take_both(tmp_path, make_tree(1), grain=grain)
    with open(os.path.join(jdir, ".checksums.0"), "rb") as f:
        jside = f.read()
    with open(os.path.join(tdir, ".checksums.0"), "rb") as f:
        tside = f.read()
    assert jside == tside
    records = json.loads(tside).values()
    if grain == 64:
        assert any(isinstance(r, dict) and r["v"] == 2 for r in records)
    else:
        assert all(isinstance(r, list) and r[2] for r in records)


def test_streamed_object_sidecar_matches_whole_object(tmp_path):
    """A tensor of several stream chunks is written by the streaming path;
    its record equals the whole-buffer digest the reference writes."""
    tree = {"big": np.random.default_rng(2).standard_normal((64, 16)).astype(np.float32)}
    with tknobs.override_stream_chunk_bytes(1024), tknobs.override_hash_chunk_bytes(512):
        with jknobs.override_hash_chunk_bytes(512):
            jdir, tdir = take_both(tmp_path, tree)
    for name in (".checksums.0", "0/m/big"):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_memoryview_stream_parity():
    data = memoryview(bytes(range(200)))
    results = []
    for cls in (JStream, TStream):
        s = cls(data)
        out = [s.read(10), s.seek(-5, 2), s.read(), s.seek(3), s.tell()]
        buf = bytearray(7)
        out += [s.readinto(buf), bytes(buf), s.read(-1)[:4]]
        results.append(out)
    assert results[0] == results[1]

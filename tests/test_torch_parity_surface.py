"""The port's small public surface on the JAX test modules' own cases, each
fed to both packages: flatten and inflate with adversarial keys
(``tests/test_flatten.py``), the manifest's JSON and per-rank projection
(``tests/test_manifest.py``), URL dispatch and the fs and ``memory://``
plugins (``tests/test_storage_plugin.py``), the raw codec over every
dtype string (``tests/test_serialization.py``), replication globs and the
take's preflight round (``tests/test_replication_glob.py``), and value
routing and chunk math (``tests/test_io_preparer.py``)."""

import asyncio
import json
from collections import OrderedDict

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import flatten as jflatten, manifest as jmanifest, serialization as jser
from torchsnapshot_tpu.io_types import ReadIO as JReadIO, WriteIO as JWriteIO
from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin as jurl
from torchsnapshot_tpu.test_utils import rand_array
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import flatten as tflatten, manifest as tmanifest, serialization as tser
from torchsnapshot_tpu_torch.io_types import ReadIO as TReadIO, WriteIO as TWriteIO
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin as turl

# ---------------------------------------------------------------------------
# flatten / inflate
# ---------------------------------------------------------------------------

FLATTEN_CASES = {
    "nested": {"model": {"w": 1.5, "b": 2}, "steps": [1, 2, {"nested": "x"}], "od": OrderedDict([("z", 1), ("a", 2)])},
    "adversarial": {"a/b": 1, "a%2Fb": 2, "a": {"b": 3}, "%": {"%%": 4}},
    "int_keys": {1: "one", "1x": "strtwo", "d": {0: [10, 20]}},
    "colliding": {"outer": {1: "int_one", "1": "str_one"}},
    "non_str_keys": {"outer": {(1, 2): "tuple_key"}, "ok": 5},
    "empty": {"e1": {}, "e2": [], "e3": OrderedDict()},
    "empty_key": {"outer": {"": 3, "ok": 1}},
    "dot_key": {"outer": {".": 4, "ok": 1}},
    "dotdot_key": {"outer": {"..": 4, "ok": 1}},
}


def _entries(manifest, to_dict):
    return {p: to_dict(e) for p, e in manifest.items()}


@pytest.mark.parametrize("prefix", ["", "app"])
@pytest.mark.parametrize("case", sorted(FLATTEN_CASES))
def test_flatten_as_the_jax_package(case, prefix):
    obj = FLATTEN_CASES[case]
    jm, jf = jflatten.flatten(obj, prefix=prefix)
    tm, tf = tflatten.flatten(obj, prefix=prefix)
    assert _entries(tm, tmanifest.entry_to_dict) == _entries(jm, jmanifest.entry_to_dict)
    assert tf == jf
    out = tflatten.inflate(tm, tf, prefix=prefix)
    assert out == obj and type(out) is type(obj)
    if case == "empty":
        assert isinstance(out["e3"], OrderedDict)


def test_a_leaf_at_the_root_as_the_jax_package():
    assert tflatten.flatten(42, prefix="x") == jflatten.flatten(42, prefix="x") == ({}, {"x": 42})
    assert tflatten.inflate({}, {"x": 42}, prefix="x") == 42


@pytest.mark.parametrize("key", ["", ".", ".."])
def test_opaque_dicts_round_trip_across_the_packages(tmp_path, key):
    """Keys that would make an empty or collapsing path segment keep their
    dict one opaque leaf; either package restores the other's take."""
    state = {"outer": {key: np.arange(4), "ok": 1}}
    jts.Snapshot.take(str(tmp_path / "j"), {"s": jts.StateDict(**state)})
    tts.Snapshot.take(str(tmp_path / "t"), {"s": tts.StateDict(**state)})
    out = tts.StateDict()
    tts.Snapshot(str(tmp_path / "j")).restore({"s": out}, device="cpu")
    jout = jts.StateDict()
    jts.Snapshot(str(tmp_path / "t")).restore({"s": jout})
    for got in (out, jout):
        assert np.array_equal(np.asarray(got["outer"][key]), np.arange(4)) and got["outer"]["ok"] == 1


# ---------------------------------------------------------------------------
# The manifest
# ---------------------------------------------------------------------------


def _two_rank_metadata(m):
    def shard(path, off, sz):
        return m.Shard(offsets=off, sizes=sz, tensor=m.ArrayEntry(path, "raw", "float32", sz))

    manifest = {
        "0/app": m.DictEntry(keys=["per_rank", "repl", "shard", "obj"]),
        "1/app": m.DictEntry(keys=["per_rank", "repl", "shard"]),
        "0/app/per_rank": m.ArrayEntry("0/app/per_rank", "raw", "float32", [4]),
        "1/app/per_rank": m.ArrayEntry("1/app/per_rank", "raw", "float32", [4]),
        "0/app/repl": m.ArrayEntry("replicated/app/repl", "raw", "int64", [2], True),
        "1/app/repl": m.ArrayEntry("replicated/app/repl", "raw", "int64", [2], True),
        "0/app/shard": m.ShardedArrayEntry("float32", [8, 4], [shard("sharded/app/shard.0_0", [0, 0], [4, 4])]),
        "1/app/shard": m.ShardedArrayEntry("float32", [8, 4], [shard("sharded/app/shard.4_0", [4, 0], [4, 4])]),
        "0/app/obj": m.ObjectEntry("0/app/obj"),
        "0/prim": m.PrimitiveEntry.from_value(42),
        "0/x": m.ChunkedArrayEntry(
            "bfloat16", [10, 4],
            [m.Shard([0, 0], [5, 4], m.ArrayEntry("0/x.chunk_0", "raw", "bfloat16", [5, 4])),
             m.Shard([5, 0], [5, 4], m.ArrayEntry("0/x.chunk_5", "raw", "bfloat16", [5, 4]))],
            replicated=True,
        ),
        "0/l": m.ListEntry(),
        "0/od": m.OrderedDictEntry(keys=["b", "a"]),
        "0/d": m.DictEntry(keys=[1, "x"]),
    }
    return m.SnapshotMetadata(version="0", world_size=2, manifest=manifest)


def test_metadata_json_is_the_jax_package_json():
    jmd, tmd = _two_rank_metadata(jmanifest), _two_rank_metadata(tmanifest)
    assert json.loads(tmd.to_json()) == json.loads(jmd.to_json())
    back = tmanifest.SnapshotMetadata.from_json(jmd.to_json())
    assert _entries(back.manifest, tmanifest.entry_to_dict) == _entries(jmd.manifest, jmanifest.entry_to_dict)


@pytest.mark.parametrize("rank", [0, 1, 5])
def test_per_rank_projection_as_the_jax_package(rank):
    jm = jmanifest.get_manifest_for_rank(_two_rank_metadata(jmanifest), rank)
    tm = tmanifest.get_manifest_for_rank(_two_rank_metadata(tmanifest), rank)
    assert _entries(tm, tmanifest.entry_to_dict) == _entries(jm, jmanifest.entry_to_dict)
    assert len(tm["app/shard"].shards) == 2 and tm["app/repl"].replicated
    assert ("app/per_rank" in tm) == (rank < 2) and ("prim" in tm) == (rank == 0)


@pytest.mark.parametrize("value", [0, -3, 1.5, float("inf"), 0.1, True, False, "hi", b"\x00\xff", 1 + 2j, None])
def test_primitives_round_trip_as_the_jax_package(value):
    for m in (jmanifest, tmanifest):
        md = m.SnapshotMetadata(version="0", world_size=1, manifest={"0/x": m.PrimitiveEntry.from_value(value)})
        out = tmanifest.SnapshotMetadata.from_json(md.to_json()).manifest["0/x"].get_value()
        assert out == value and type(out) is type(value)


# ---------------------------------------------------------------------------
# URL dispatch and the fs and memory:// plugins
# ---------------------------------------------------------------------------


def test_url_dispatch_as_the_jax_package(tmp_path):
    from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JFS
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin as TFS
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin as TMem

    assert isinstance(turl(str(tmp_path)), TFS) and isinstance(jurl(str(tmp_path)), JFS)
    assert isinstance(turl(f"fs://{tmp_path}"), TFS)
    a, b, c = turl("memory://bucket1"), turl("memory://bucket1"), turl("memory://bucket2")
    assert isinstance(a, TMem) and a is b and a is not c
    for url, match in (("carrierpigeon://coop", "Unsupported protocol"), ("://nothing", "")):
        with pytest.raises(RuntimeError, match=match):
            jurl(url)
        with pytest.raises(RuntimeError, match=match):
            turl(url)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _plugins(tmp_path, kind):
    from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JFS
    from torchsnapshot_tpu.storage_plugins.memory import MemoryStoragePlugin as JMem
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin as TFS
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin as TMem

    if kind == "fs":
        return (JFS(root=str(tmp_path / "j")), JWriteIO, JReadIO), (TFS(root=str(tmp_path / "t")), TWriteIO, TReadIO)
    return (JMem(root=f"{tmp_path}-j"), JWriteIO, JReadIO), (TMem(root=f"{tmp_path}-t"), TWriteIO, TReadIO)


def _payload(read_io):
    buf = read_io.buf
    return buf.getvalue() if hasattr(buf, "getvalue") else bytes(buf)


@pytest.mark.parametrize("kind", ["fs", "memory"])
def test_plugin_writes_reads_ranges_and_deletes_as_the_jax_package(tmp_path, kind):
    payload = bytes(range(256)) * 16
    results = []
    for plugin, WriteIO, ReadIO in _plugins(tmp_path, kind):
        async def go(plugin=plugin, WriteIO=WriteIO, ReadIO=ReadIO):
            await plugin.write(WriteIO(path="deep/nested/blob", buf=payload))
            await plugin.write(WriteIO(path="mv", buf=memoryview(b"zero-copy payload")))
            out = []
            for rng in (None, (0, 10), (100, 356), (1000, 1024), (0, 4096)):
                rio = ReadIO(path="deep/nested/blob", byte_range=rng)
                await plugin.read(rio)
                out.append(_payload(rio))
            rio = ReadIO(path="mv")
            await plugin.read(rio)
            out.append(_payload(rio))
            await plugin.delete(path="mv")
            with pytest.raises(FileNotFoundError):
                await plugin.read(ReadIO(path="mv"))
            await plugin.close()
            return out

        results.append(_run(go()))
    assert results[0] == results[1]
    assert results[1][0] == payload and results[1][2] == payload[100:356] and results[1][-1] == b"zero-copy payload"


# ---------------------------------------------------------------------------
# The raw codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(jser.SUPPORTED_DTYPES))
def test_raw_codec_over_every_dtype_string(dtype):
    arr = rand_array((16, 9), dtype=dtype, seed=42)
    raw = bytes(jser.array_as_bytes_view(arr))
    assert len(raw) == tser.array_nbytes(arr.shape, dtype) == jser.array_nbytes(arr.shape, dtype)
    t = tser.array_from_bytes(raw, dtype, arr.shape)
    assert t.shape == torch.Size(arr.shape) and t.dtype == tser.string_to_dtype(dtype)
    assert bytes(tser.array_as_bytes_view(t)) == raw
    assert tser.is_raw_serializable(tser.string_to_dtype(dtype))
    if dtype not in tser.BYTE_VIEW_DTYPES:
        assert tser.dtype_to_string(t.dtype) == dtype


def test_raw_views_alias_their_buffers():
    t = torch.arange(100, dtype=torch.float32)
    view = tser.array_as_bytes_view(t)
    t[0] = 42.0
    assert tser.array_from_bytes(view, "float32", (100,))[0] == 42.0
    buf = bytearray(8)
    out = tser.array_from_bytes(buf, "float32", (2,))
    out[1] = 1.0
    assert bytes(buf[4:]) == np.float32(1.0).tobytes()


@pytest.mark.parametrize("arr", [np.float32(3.5).reshape(()), np.empty((0, 4), dtype=np.int64), np.arange(100, dtype=np.int32).reshape(10, 10).T])
def test_zero_dim_empty_and_strided_as_the_jax_package(arr):
    name = jser.dtype_to_string(arr.dtype)
    raw = bytes(jser.array_as_bytes_view(arr))
    assert bytes(tser.array_as_bytes_view(arr)) == raw
    assert bytes(tser.array_as_bytes_view(torch.from_numpy(np.ascontiguousarray(arr)))) == raw
    assert tser.array_from_bytes(raw, name, arr.shape).numpy().tobytes() == np.ascontiguousarray(arr).tobytes()
    with pytest.raises(ValueError):
        tser.array_from_bytes(b"\x00" * 7, "float32", (2,))


# ---------------------------------------------------------------------------
# Replication globs (tests/test_replication_glob.py)
# ---------------------------------------------------------------------------

GLOB_TREE = {
    "model": {"layer1": {"weight": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}, "layer2": {"weight": np.ones(2, np.float32)}},
    "optim": {"state": {"0": {"exp_avg": np.ones(3, np.float32)}}},
    "progress": {"epoch": np.arange(2)},
}


@pytest.mark.parametrize(
    "globs",
    [[], ["**"], ["model/**"], ["model/layer1/*"], ["*/epoch"], ["nomatch/**"], ["model/*/weight", "optim/**"]],
    ids=["none", "all", "model", "layer1", "epoch", "nomatch", "two"],
)
def test_replication_globs_select_as_in_the_jax_package(tmp_path, globs):
    """The same globs replicate the same entries, under ``replicated/``,
    and the snapshots cross-restore."""
    app_j = {k: jts.StateDict(v) for k, v in GLOB_TREE.items()}
    app_t = {k: tts.StateDict(v) for k, v in GLOB_TREE.items()}
    jts.Snapshot.take(str(tmp_path / "j"), app_j, replicated=globs)
    tts.Snapshot.take(str(tmp_path / "t"), app_t, replicated=globs)

    def replicated(path):
        man = json.load(open(tmp_path / path / ".snapshot_metadata"))["manifest"]
        return sorted((p, e["location"]) for p, e in man.items() if e.get("replicated"))

    assert replicated("t") == replicated("j")
    assert all(loc.startswith("replicated/") for _, loc in replicated("t") if loc)
    out = {"model": tts.StateDict()}
    tts.Snapshot(str(tmp_path / "j")).restore(out, device="cpu")
    assert np.array_equal(out["model"]["layer1"]["weight"].numpy(), GLOB_TREE["model"]["layer1"]["weight"])


class _FakeCoordinator:
    """Rank 0's view of the preflight round: ``gather_object`` hands back the
    canned payloads of the other ranks beside this rank's own."""

    def __init__(self, world_size, gathered):
        self._world = world_size
        self._gathered = gathered

    def get_rank(self):
        return 0

    def get_world_size(self):
        return self._world

    def gather_object(self, obj, dst=0):
        out = list(self._gathered)
        out[0] = obj
        return out

    def broadcast_object(self, obj, src=0):
        return obj

    def barrier(self):
        pass


@pytest.mark.parametrize(
    "case",
    [
        ("single", 1, None, ("/tmp/snap", ["b/**", "a/**", "a/**"], None)),
        ("asymmetric", 2, [None, ("/tmp/snap", None, ["b/**", "c/**"], None, None)], ("/tmp/snap", ["a/**", "b/**"], None)),
        ("divergent_path", 2, [None, ("/snap/rank1", None, [], 5, None)], ("/snap/rank0", [], 5)),
        ("token_divergence", 2, [None, ("/snap", None, [], 4, None)], ("/snap", [], 5)),
        ("missing_plan", 2, [None, ("/snap", None, [], None, None)], ("/snap", [], 5)),
        ("missing_own_plan", 2, [None, ("/snap", None, [], 5, None)], ("/snap", [], None)),
    ],
    ids=lambda c: c[0],
)
def test_preflight_decides_as_in_the_jax_package(case, caplog):
    """Globs are deduplicated and sorted; only those every rank passes are
    honoured (a warning names the rest); rank 0's path wins (a warning names
    the divergence); a plan-cache hit needs every rank's plan from the same
    take."""
    import logging

    from torchsnapshot_tpu.take_plan import preflight as jpreflight
    from torchsnapshot_tpu_torch.take_plan import preflight as tpreflight

    _, world, gathered, (path, globs, token) = case
    results = []
    for preflight in (jpreflight, tpreflight):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            pf = preflight(_FakeCoordinator(world, gathered), path, None, globs, token)
        warned = " ".join(r.getMessage().lower() for r in caplog.records)
        results.append((pf.hit, pf.path, pf.replicated_globs, "rank-asymmetric" in warned, "divergent" in warned))
    assert results[1] == results[0]


# ---------------------------------------------------------------------------
# Value routing and chunk math (tests/test_io_preparer.py)
# ---------------------------------------------------------------------------


def test_storage_paths_as_in_the_jax_package():
    from torchsnapshot_tpu.io_preparer import get_storage_path as jpath
    from torchsnapshot_tpu_torch.io_preparer import get_storage_path as tpath

    for replicated in (False, True):
        assert tpath("model/w", rank=3, replicated=replicated) == jpath("model/w", rank=3, replicated=replicated)


@pytest.mark.parametrize(
    "value", [1, 1.5, True, "s", b"b", None, np.ones((2, 2)), {"not": "stateful"}, [1, 2, 3], np.float32(1.5)],
    ids=["int", "float", "bool", "str", "bytes", "none", "ndarray", "dict", "list", "np_scalar"],
)
def test_values_route_as_in_the_jax_package(value):
    from torchsnapshot_tpu.io_preparer import classify as jclassify
    from torchsnapshot_tpu_torch.io_preparer import classify as tclassify

    assert tclassify(value, world_size=1) == jclassify(value, world_size=1)
    assert tclassify(torch.ones(2, 2), world_size=1) == "array"


def test_chunking_as_in_the_jax_package():
    from torchsnapshot_tpu.io_preparers.chunked_array import chunk_row_ranges as jranges, should_chunk as jshould
    from torchsnapshot_tpu.utils import knobs as jknobs
    from torchsnapshot_tpu_torch.io_preparers.array import chunk_row_ranges as tranges
    from torchsnapshot_tpu_torch.io_preparers.chunked_array import should_chunk as tshould
    from torchsnapshot_tpu_torch.utils import knobs as tknobs

    for shape in ((8, 1024), (1, 8 * 1024)):
        arr = np.zeros(shape, np.float32)
        assert tshould(torch.from_numpy(arr)) == jshould(arr)
        with jknobs.override_max_chunk_size_bytes(4 * 1024), tknobs.override_max_chunk_size_bytes(4 * 1024):
            assert tshould(torch.from_numpy(arr)) == jshould(arr) == (shape[0] > 1)
    for shape, itemsize, max_bytes in (((100, 7), 4, 280), ((4, 1000), 8, 16), ((33,), 2, 10), ((5, 3), 4, 10**6)):
        assert tranges(shape, itemsize, max_bytes) == jranges(shape, itemsize, max_bytes)

"""Compressed snapshots: the port against the JAX package.

The same numpy inputs, made from a seed, are taken by both packages with
the same codec, level and frame size; the manifests, the payloads and the
``.ftab`` frame tables must be byte-identical, for a single-blob array, a
framed array (also when the port streams it), a member-framed slab and a
chunked array, under zlib and (where ``zstandard`` is installed) zstd. A
compressed snapshot of either package restores bit-exactly through the
other, including ``read_object`` of one slab member and a framed sub-read.
On 2 gloo ranks a compressed JAX snapshot restores into DTensors, and
ranks taking with different codecs fail with ``CheckpointAbortedError``
on every rank. zstd without ``zstandard`` raises at take and at restore.
"""

import builtins
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.convert import from_numpy_tree

try:
    import zstandard  # noqa: F401

    _HAVE_ZSTD = True
except ImportError:
    _HAVE_ZSTD = False

CODECS = [
    "zlib",
    pytest.param("zstd", marks=pytest.mark.skipif(not _HAVE_ZSTD, reason="zstandard is not installed")),
]

_ENV = {"TSS_TORCH_DEDUP_DIGESTS": "1", "TORCHSNAPSHOT_TPU_DEDUP_DIGESTS": "1"}

# Knob settings per layout, in the JAX package's names (the port's are the
# same after the prefix).
LAYOUTS = {
    "blob": {"COMPRESSION_FRAME_BYTES": "0"},
    "framed": {"COMPRESSION_FRAME_BYTES": "512"},
    "slab": {"ENABLE_BATCHING": "1"},
    "chunked": {"MAX_CHUNK_SIZE_BYTES": "256"},
}


@pytest.fixture(autouse=True)
def _pin_digests(monkeypatch):
    for k, v in _ENV.items():
        monkeypatch.setenv(k, v)


def make_tree(seed: int):
    """Compressible arrays of several dtypes and sizes, and primitives."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.integers(-8, 8, (40, 24)).astype(np.float32),
        "emb": rng.integers(-3, 3, (64, 16)).astype(ml_dtypes.bfloat16),
        "b": rng.standard_normal(20).astype(np.float32),
        "i8": rng.integers(-100, 100, 13).astype(np.int8),
        "flag": rng.integers(0, 2, 9).astype(bool),
        "scalar": np.array(3, dtype=np.int32),
        "nested": {"x": rng.integers(0, 4, (6, 2)).astype(np.float64), "n": 4},
        "step": 7,
    }


def _set_env(monkeypatch, codec, layout, extra=None):
    settings = {"COMPRESSION": codec, **LAYOUTS[layout], **(extra or {})}
    for k, v in settings.items():
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_" + k, v)
        monkeypatch.setenv("TSS_TORCH_" + k, v)


def _array_entries(manifest):
    for key, e in manifest.items():
        if e["type"] == "array":
            yield key, e
        for i, c in enumerate(e.get("chunks", []) + e.get("shards", [])):
            yield f"{key}#{i}", c["tensor"]


def _normalized_dir(d):
    """(metadata without version, {path: bytes}, {sidecar: records}), with
    each batched/<uuid> slab and its .ftab renamed after its first member."""
    with open(os.path.join(d, ".snapshot_metadata")) as f:
        md = json.load(f)
    md.pop("version")
    members = {}
    for key, e in _array_entries(md["manifest"]):
        if e["location"].startswith("batched/"):
            members.setdefault(e["location"], []).append(key)
    names = {loc: "batched/" + min(keys) for loc, keys in members.items()}
    names.update({loc + ".ftab": new + ".ftab" for loc, new in list(names.items())})
    for _key, e in _array_entries(md["manifest"]):
        e["location"] = names.get(e["location"], e["location"])
    files = {}
    for root, _, fs in os.walk(d):
        for f in fs:
            rel = os.path.relpath(os.path.join(root, f), d)
            if rel == ".snapshot_metadata" or rel.startswith(".telemetry"):
                continue
            with open(os.path.join(root, f), "rb") as fh:
                files[names.get(rel, rel)] = fh.read()
    sidecars = {}
    for f in [f for f in files if f.startswith(".checksums.")]:
        records = json.loads(files.pop(f))
        sidecars[f] = {names.get(k, k): v for k, v in records.items()}
    return md, files, sidecars


def _take_both(tmp_path, tree):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jts.Snapshot.take(jdir, {"m": jts.StateDict(tree)})
    tts.Snapshot.take(tdir, {"m": tts.StateDict(from_numpy_tree(tree))})
    return jdir, tdir


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("codec", CODECS)
def test_same_compressed_payloads_tables_and_manifest(tmp_path, monkeypatch, codec, layout):
    _set_env(monkeypatch, codec, layout)
    jdir, tdir = _take_both(tmp_path, make_tree(0))
    jmd, jfiles, jside = _normalized_dir(jdir)
    tmd, tfiles, tside = _normalized_dir(tdir)
    assert tmd == jmd
    assert tfiles == jfiles
    assert tside == jside
    entries = [e for _k, e in _array_entries(tmd["manifest"])]
    assert {e["serializer"] for e in entries} == {f"raw_{codec}"}
    assert tmd["codec_versions"][codec]
    ftabs = [p for p in tfiles if p.endswith(".ftab")]
    if layout == "framed":
        assert ftabs and all("frame_bytes" in json.loads(tfiles[p]) for p in ftabs)
        assert any(e.get("frame_bytes") == 512 for e in entries)
    elif layout == "slab":
        assert ftabs and all(json.loads(tfiles[p])["member_framed"] for p in ftabs)
        assert any(e.get("raw_range") for e in entries)
    elif layout == "chunked":
        assert any(e["type"] == "chunked_array" for e in tmd["manifest"].values())
    else:
        assert not ftabs


@pytest.mark.parametrize("codec", CODECS)
def test_streamed_framed_payload_equals_the_whole_one(tmp_path, monkeypatch, codec):
    """The port streams a framed array (row blocks not aligned to frames);
    the frames and the .ftab equal the JAX package's unstreamed ones."""
    _set_env(monkeypatch, codec, "framed", {"COMPRESSION_FRAME_BYTES": "1000"})
    monkeypatch.setenv("TSS_TORCH_STREAM_CHUNK_BYTES", "700")
    monkeypatch.setenv("TSS_TORCH_STREAM_WRITES", "on")
    tree = {"big": np.random.default_rng(3).integers(0, 9, (97, 33)).astype(np.float32)}
    jdir, tdir = _take_both(tmp_path, tree)
    for name in ("0/m/big", "0/m/big.ftab"):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name


def _np_bytes(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _t_bytes(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def _zeros_tree(tree, torch_side):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _zeros_tree(v, torch_side)
        elif isinstance(v, np.ndarray):
            z = np.zeros_like(v)
            out[k] = from_numpy_tree({"z": z})["z"] if torch_side else z
        else:
            out[k] = None
    return out


def _assert_tree_equal(got, want):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree_equal(got[k], v)
        elif isinstance(v, np.ndarray):
            g = got[k]
            gb = _t_bytes(g) if isinstance(g, torch.Tensor) else _np_bytes(np.asarray(g))
            assert np.array_equal(gb, _np_bytes(v)), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("codec", CODECS)
def test_compressed_snapshots_restore_across_packages(tmp_path, monkeypatch, codec, direction):
    """Slab members, framed arrays and blobs in one snapshot; restored whole,
    one slab member by ``read_object``, and a framed array by budgeted
    sub-reads (``memory_budget_bytes`` below its size)."""
    _set_env(monkeypatch, codec, "slab", {"COMPRESSION_FRAME_BYTES": "512"})
    tree = make_tree(1)
    path = str(tmp_path / "snap")
    if direction == "jax_to_port":
        jts.Snapshot.take(path, {"m": jts.StateDict(tree)})
        target = tts.StateDict(_zeros_tree(tree, True))
        tts.Snapshot(path).restore({"m": target}, device="cpu")
        member = tts.Snapshot(path).read_object("0/m/b", device="cpu")
        framed = tts.Snapshot(path).read_object("0/m/emb", device="cpu", memory_budget_bytes=600)
    else:
        tts.Snapshot.take(path, {"m": tts.StateDict(from_numpy_tree(tree))})
        target = jts.StateDict(_zeros_tree(tree, False))
        jts.Snapshot(path).restore({"m": target})
        member = jts.Snapshot(path).read_object("0/m/b")
        framed = jts.Snapshot(path).read_object("0/m/emb", memory_budget_bytes=600)
    _assert_tree_equal(dict(target), tree)
    _assert_tree_equal({"b": member, "emb": framed}, {"b": tree["b"], "emb": tree["emb"]})
    md = json.load(open(os.path.join(path, ".snapshot_metadata")))["manifest"]
    assert md["0/m/b"]["raw_range"] and md["0/m/emb"]["frame_bytes"] == 512
    assert tts.Snapshot(path).verify() == {}


def test_framed_sub_read_decodes_only_covering_frames(tmp_path, monkeypatch):
    """A budgeted read of a framed object plans one ranged read per frame
    group, each a frame-aligned superset of its raw bytes."""
    from torchsnapshot_tpu_torch.io_preparers.array import FramedSliceConsumer, plan_frame_groups

    _set_env(monkeypatch, "zlib", "framed", {"COMPRESSION_FRAME_BYTES": "100"})
    x = np.random.default_rng(4).integers(0, 5, 1000).astype(np.float32)  # 4000 bytes, 40 frames
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=torch.from_numpy(x))})
    table = json.load(open(os.path.join(path, "0/m/x.ftab")))
    groups = plan_frame_groups(table["sizes"], 100, 0, 4000, 350)
    assert [(g[2], g[3]) for g in groups] == [(0, 300), (300, 600), (600, 900), (900, 1200)] + [
        (b, min(b + 300, 4000)) for b in range(1200, 4000, 300)
    ]
    target = np.zeros(4000, dtype=np.uint8)
    entry = tts.Snapshot(path).get_manifest()["0/m/x"]
    from torchsnapshot_tpu_torch.io_preparers.array import ArrayIOPreparer

    reqs = ArrayIOPreparer.prepare_read(entry, target, 0, 350, table["sizes"])
    assert len(reqs) == len(groups)
    assert all(isinstance(r.buffer_consumer, FramedSliceConsumer) for r in reqs)
    got = tts.Snapshot(path).read_object("0/m/x", device="cpu", memory_budget_bytes=350)
    assert np.array_equal(got.numpy(), x)


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------


def _dtensor_restore_worker(rank, world_size, path, budget):
    os.environ.update(_ENV)
    os.environ["TSS_TORCH_PER_RANK_MEMORY_BUDGET_BYTES"] = str(budget)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy
    from torchsnapshot_tpu_torch.io_preparers import sharded_array

    framed_reads = []
    plain = sharded_array._framed_shard_reads

    def counting(*args, **kwargs):
        reqs = plain(*args, **kwargs)
        framed_reads.extend(reqs)
        return reqs

    sharded_array._framed_shard_reads = counting
    g = _sharded_globals()
    mesh = DeviceMesh("cpu", list(range(world_size)))
    placements = {"a": [Shard(1)], "b": [Shard(0)], "small": [Replicate()], "small2": [Shard(0)]}

    def check(snapshot_path, names, pl):
        tgt = {k: dtensor_from_numpy(np.zeros_like(g[k]), mesh, pl[k]) for k in names}
        restored = tts.StateDict(tgt)
        tts.Snapshot(snapshot_path).restore({"m": restored}, device="cpu")
        for k in names:
            want = dtensor_from_numpy(g[k], mesh, pl[k]).to_local()
            assert torch.equal(_tt(restored[k].to_local()), _tt(want)), k

    check(path, list(g), placements)
    # The port's own 2-rank zlib take: framed shards, and replicated plain
    # tensors, which the partitioner spreads over the ranks and each rank's
    # batcher packs into a member-framed slab, restored into DTensors.
    os.environ.update(
        {"TSS_TORCH_COMPRESSION": "zlib", "TSS_TORCH_COMPRESSION_FRAME_BYTES": "96", "TSS_TORCH_ENABLE_BATCHING": "1"}
    )
    saved = {"a": [Shard(0)], "b": [Shard(1)]}
    state = {k: dtensor_from_numpy(g[k], mesh, saved[k]) for k in saved}
    reps = {f"r{i}": (np.arange(4 + i) * (i + 1)).astype(np.float32) for i in range(6)}
    state.update({k: torch.from_numpy(v) for k, v in reps.items()})
    port_path = path + "_port"
    tts.Snapshot.take(port_path, {"m": tts.StateDict(state)}, replicated=["m/r*"])
    manifest = tts.Snapshot(port_path).get_manifest()
    assert all(manifest[f"{rank}/m/{k}"].raw_range is not None for k in reps)
    assert all(s.tensor.frame_bytes == 96 for s in manifest[f"{rank}/m/a"].shards)
    g.update(reps)
    placements.update({k: [Replicate()] for k in reps})
    check(port_path, ["a", "b"] + list(reps), placements)
    # Only shards above the budget are read by frame groups.
    assert bool(framed_reads) == (budget < 1000)


def _tt(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _sharded_globals():
    rng = np.random.default_rng(5)
    return {
        "a": rng.integers(-4, 4, (16, 24)).astype(np.float32),
        "b": rng.integers(-4, 4, (8, 40)).astype(ml_dtypes.bfloat16),
        "small": rng.standard_normal(6).astype(np.float32),
        "small2": rng.integers(0, 9, 10).astype(np.int16),
    }


@pytest.mark.parametrize("budget", [1 << 30, 400], ids=["whole", "frame_groups"])
def test_dtensor_restore_from_compressed_jax_snapshot(tmp_path, monkeypatch, budget):
    """The JAX package's 8-device zlib take (framed shards) restored by 2
    gloo ranks into DTensors of other placements, then the ranks' own zlib
    take (framed shards, a member-framed slab of replicated tensors)
    likewise. With a small budget each shard's overlap is read frame group
    by frame group: frame-aligned supersets of the rows a rank needs."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    _set_env(monkeypatch, "zlib", "slab", {"COMPRESSION_FRAME_BYTES": "96"})
    g = _sharded_globals()
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    arrays = {
        "a": jax.device_put(g["a"], NamedSharding(mesh, P("x"))),
        "b": jax.device_put(g["b"], NamedSharding(mesh, P(None, "x"))),
        # Replicated over the devices: every rank sees them.
        "small": jax.device_put(g["small"], NamedSharding(mesh, P())),
        "small2": jax.device_put(g["small2"], NamedSharding(mesh, P())),
    }
    path = str(tmp_path / "jax_zlib")
    jts.Snapshot.take(path, {"m": jts.StateDict(arrays)})
    md = json.load(open(os.path.join(path, ".snapshot_metadata")))["manifest"]
    shards = md["0/m/a"]["shards"]
    assert all(s["tensor"]["serializer"] == "raw_zlib" and s["tensor"]["frame_bytes"] == 96 for s in shards)
    run_with_processes(_dtensor_restore_worker, 2, args=(path, budget), process_group=True, timeout_s=180)


def _divergent_codec_worker(rank, world_size, path):
    os.environ.update(_ENV)
    os.environ["TSS_TORCH_COMPRESSION"] = "zlib" if rank == 0 else "none"
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.snapshot import CheckpointAbortedError

    state = tts.StateDict(w=torch.arange(512, dtype=torch.float32))
    with pytest.raises(CheckpointAbortedError) as info:
        tts.Snapshot.take(path, {"m": state}, replicated=["m/*"])
    e = info.value
    assert (e.rank, e.phase) == (1, "plan"), (e.rank, e.phase)
    assert "TSS_TORCH_COMPRESSION differs" in str(e)
    if rank == 1:
        assert isinstance(e.__cause__, ValueError)
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))
    # The ranks still agree afterwards: a take with one codec commits.
    os.environ["TSS_TORCH_COMPRESSION"] = "zlib"
    tts.Snapshot.take(path + "_ok", {"m": state}, replicated=["m/*"])


def test_divergent_codecs_abort_on_every_rank(tmp_path):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    path = str(tmp_path / "ckpt")
    run_with_processes(_divergent_codec_worker, 2, args=(path,), timeout_s=120)
    assert os.path.exists(os.path.join(path + "_ok", ".snapshot_metadata"))


# ---------------------------------------------------------------------------
# Without zstandard
# ---------------------------------------------------------------------------


@pytest.fixture
def no_zstandard(monkeypatch):
    real_import = builtins.__import__

    def no_zstd(name, *args, **kwargs):
        if name == "zstandard":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_zstd)


def test_zstd_take_without_zstandard_raises(tmp_path, monkeypatch, no_zstandard):
    monkeypatch.setenv("TSS_TORCH_COMPRESSION", "zstd")
    path = str(tmp_path / "s")
    with pytest.raises(RuntimeError, match="zstandard"):
        tts.Snapshot.take(path, {"m": tts.StateDict(x=torch.ones(8))})
    with pytest.raises(RuntimeError, match="zstandard"):
        tts.Snapshot.async_take(path, {"m": tts.StateDict(x=torch.ones(8))})
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


@pytest.mark.skipif(not _HAVE_ZSTD, reason="zstandard is not installed")
def test_zstd_restore_without_zstandard_raises_at_planning(tmp_path, monkeypatch):
    path = str(tmp_path / "s")
    with jknobs.override_compression("zstd"):
        jts.Snapshot.take(path, {"m": jts.StateDict(x=np.arange(64, dtype=np.float32))})
    real_import = builtins.__import__

    def no_zstd(name, *args, **kwargs):
        if name == "zstandard":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_zstd)
    with pytest.raises(RuntimeError, match="zstandard"):
        tts.Snapshot(path).restore({"m": tts.StateDict(x=torch.zeros(64))}, device="cpu")

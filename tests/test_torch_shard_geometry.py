"""The port's shard geometry and replicated-write partitioner against the
JAX package's, on the same inputs: equal outputs required.

Covers ``subdivide``, ``overlap``, ``overlap_row_intervals``,
``record_grain_for``, ``shard_read_intervals``, the DTensor placements'
offsets against the JAX ``index_to_offsets_sizes`` of the equivalent
``NamedSharding`` (and against torch's own DTensor geometry for uneven
shapes, which a ``NamedSharding`` refuses), and the greedy assignment of
replicated writes for the same loads under a stub coordinator.
"""

import itertools

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard as DShard
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

from torchsnapshot_tpu import io_types as jio_types
from torchsnapshot_tpu import manifest as jmanifest
from torchsnapshot_tpu import partitioner as jpartitioner
from torchsnapshot_tpu.io_preparers import sharded_array as jsa

from torchsnapshot_tpu_torch import io_types as tio_types
from torchsnapshot_tpu_torch import manifest as tmanifest
from torchsnapshot_tpu_torch import partitioner as tpartitioner
from torchsnapshot_tpu_torch.io_preparers import sharded_array as tsa

_RNG_SEEDS = range(12)


def _rect(rng, shape):
    off = [int(rng.integers(0, n)) for n in shape]
    sz = [int(rng.integers(1, n - o + 1)) for o, n in zip(off, shape)]
    return off, sz


@pytest.mark.parametrize("seed", _RNG_SEEDS)
def test_subdivide_matches(seed):
    rng = np.random.default_rng(seed)
    nd = int(rng.integers(0, 4))
    sizes = [int(rng.integers(1, 40)) for _ in range(nd)]
    offsets = [int(rng.integers(0, 100)) for _ in range(nd)]
    itemsize = int(rng.choice([1, 2, 4, 8]))
    for max_bytes in (1, 7, 64, 1000, 10**9):
        for dim in [None] + list(range(nd)):
            assert tsa.subdivide(offsets, sizes, itemsize, max_bytes, dim) == jsa.subdivide(
                offsets, sizes, itemsize, max_bytes, dim
            )


@pytest.mark.parametrize("seed", _RNG_SEEDS)
def test_overlap_and_row_intervals_match(seed):
    rng = np.random.default_rng(seed)
    shape = [int(rng.integers(1, 12)) for _ in range(int(rng.integers(1, 4)))]
    src = _rect(rng, shape)
    targets = [_rect(rng, shape) for _ in range(int(rng.integers(0, 5)))]
    for dst in targets:
        assert tsa.overlap(*src, *dst) == jsa.overlap(*src, *dst)
    assert tsa.overlap_row_intervals(*src, targets) == jsa.overlap_row_intervals(*src, targets)


def _shards(off, sz, dtype, byte_range):
    tentry = tmanifest.ArrayEntry("sharded/p.x", "raw", dtype, sz, byte_range=byte_range)
    jentry = jmanifest.ArrayEntry("sharded/p.x", "raw", dtype, sz, byte_range=byte_range)
    return tmanifest.Shard(off, sz, tentry), jmanifest.Shard(off, sz, jentry)


@pytest.mark.parametrize("seed", _RNG_SEEDS)
def test_shard_read_intervals_match(seed):
    rng = np.random.default_rng(seed)
    shape = [int(rng.integers(2, 30)) for _ in range(int(rng.integers(1, 4)))]
    off, sz = _rect(rng, shape)
    dtype = str(rng.choice(["bfloat16", "float32", "int8", "float64"]))
    base = int(rng.integers(0, 300)) if seed % 2 else None
    tshard, jshard = _shards(off, sz, dtype, None if base is None else [base, base + 10**6])
    targets = [_rect(rng, shape) for _ in range(int(rng.integers(0, 4)))]
    for limit, grain, gap in itertools.product((None, 1, 100, 10**9), (None, 64, 1000), (0, 16)):
        assert tsa.shard_read_intervals(tshard, targets, limit, grain, gap) == jsa.shard_read_intervals(
            jshard, targets, limit, grain, gap
        ), (limit, grain, gap)


def test_record_grain_for_matches():
    v2 = {"v": 2, "crc": 1, "size": 300, "grain": 128, "crcs": [1, 2, 3]}
    bad_v2 = {"v": 2, "crc": 1, "size": 300, "grain": 128, "crcs": [1]}
    digests = {"a": v2, "b": [5, 10, None], "c": 7, "d": bad_v2}
    for loc in ("a", "b", "c", "d", "missing"):
        assert tsa.record_grain_for(digests, loc) == jsa.record_grain_for(digests, loc)
    assert tsa.record_grain_for(None, "a") == jsa.record_grain_for(None, "a") is None
    assert tsa.record_grain_for(digests, "a") == 128


# DTensor placements -> the equivalent PartitionSpec over a mesh of axes
# ("x", "y"): each Shard(d) of mesh dim i puts axis i on tensor dim d.
_AXES = ("x", "y")


def _spec(placements, ndim):
    dims = [[] for _ in range(ndim)]
    for i, p in enumerate(placements):
        if isinstance(p, DShard):
            dims[p.dim].append(_AXES[i])
    return P(*[None if not a else (a[0] if len(a) == 1 else tuple(a)) for a in dims])


_PLACEMENT_CASES = [
    ((2,), (DShard(0),), (8, 6)),
    ((2,), (DShard(1),), (8, 6)),
    ((2,), (Replicate(),), (8, 6)),
    ((4,), (DShard(0),), (8,)),
    ((2, 2), (DShard(0), DShard(1)), (4, 6)),
    ((2, 2), (DShard(1), DShard(0)), (4, 6)),
    ((2, 2), (DShard(1), Replicate()), (4, 6)),
    ((2, 2), (Replicate(), DShard(0)), (4, 6)),
    ((2, 2), (DShard(0), DShard(0)), (8, 3)),
    ((2, 4), (DShard(2), DShard(0)), (8, 2, 6)),
]


@pytest.mark.parametrize("mesh_shape,placements,shape", _PLACEMENT_CASES, ids=str)
def test_placement_offsets_match_named_sharding(mesh_shape, placements, shape):
    n = int(np.prod(mesh_shape))
    devices = np.array(jax.devices()[:n]).reshape(mesh_shape)
    mesh = Mesh(devices, _AXES[: len(mesh_shape)])
    index_map = NamedSharding(mesh, _spec(placements, len(shape))).devices_indices_map(shape)
    for coordinate in np.ndindex(*mesh_shape):
        want = jsa.index_to_offsets_sizes(index_map[devices[coordinate]], shape)
        got = tsa.placement_offsets_sizes(shape, mesh_shape, placements, coordinate)
        assert got == (list(want[0]), list(want[1])), coordinate


@pytest.mark.parametrize(
    "mesh_shape,placements,shape",
    [
        ((2,), (DShard(0),), (7, 5)),
        ((3,), (DShard(1),), (4, 7)),
        ((3,), (DShard(0),), (1, 3)),
        ((3,), (DShard(0),), (2,)),
        ((2, 3), (DShard(0), DShard(0)), (5, 2)),
        ((2, 3), (DShard(1), DShard(0)), (7, 3)),
        ((3, 2), (Replicate(), DShard(1)), (2, 3)),
    ],
    ids=str,
)
def test_uneven_placement_offsets_match_dtensor(mesh_shape, placements, shape):
    for coordinate in np.ndindex(*mesh_shape):
        sizes, offsets = _compute_local_shape_and_global_offset(
            shape, mesh_shape, list(coordinate), placements
        )
        got = tsa.placement_offsets_sizes(shape, mesh_shape, placements, coordinate)
        assert got[1] == list(sizes), coordinate
        nonempty = [d for d, s in enumerate(sizes) if s]
        assert [got[0][d] for d in nonempty] == [offsets[d] for d in nonempty], coordinate


def test_process_shard_map_covers_the_array_once():
    shape, mesh_shape = (7, 6), (2, 3)
    placements = (DShard(1), DShard(0))
    by_rank = tsa.process_shard_map(shape, mesh_shape, placements, list(range(6)))
    seen = np.zeros(shape, dtype=int)
    for rects in by_rank.values():
        for off, sz in rects:
            seen[tuple(slice(o, o + s) for o, s in zip(off, sz))] += 1
    assert (seen == 1).all()
    assert tsa.is_fully_replicated_sharding((Replicate(), Replicate()))
    assert not tsa.is_fully_replicated_sharding(placements)


# ---------------------------------------------------------------------------
# The partitioner's greedy assignment
# ---------------------------------------------------------------------------


class _Stager:
    def __init__(self, n):
        self.n = n

    def get_staging_cost_bytes(self):
        return self.n


class _StubCoordinator:
    """Rank ``rank`` of a world whose ranks reported ``loads``."""

    def __init__(self, rank, loads):
        self.rank, self.loads = rank, loads

    def get_rank(self):
        return self.rank

    def get_world_size(self):
        return len(self.loads)

    def all_gather_object(self, obj):
        # Both packages gather (load, codec) pairs.
        return [(l, "none") for l in self.loads]


def _plan(pkg, sizes, n_local, seed):
    mf, io = (jmanifest, jio_types) if pkg == "jax" else (tmanifest, tio_types)
    rng = np.random.default_rng(seed)
    manifest, reqs = {}, []
    for i, size in enumerate(sizes):
        path = f"replicated/m/p{i}"
        manifest[f"m/p{i}"] = mf.ArrayEntry(path, "raw", "uint8", [size], replicated=True)
        reqs.append(io.WriteReq(path=path, buffer_stager=_Stager(size)))
    for i in range(n_local):
        path = f"0/m/l{i}"
        manifest[f"m/l{i}"] = mf.ArrayEntry(path, "raw", "uint8", [1])
        reqs.append(io.WriteReq(path=path, buffer_stager=_Stager(int(rng.integers(1, 100)))))
    return manifest, reqs


@pytest.mark.parametrize("seed", range(8))
def test_partitioner_assignment_matches(seed):
    rng = np.random.default_rng(seed)
    world = int(rng.integers(2, 6))
    sizes = [int(s) for s in rng.integers(1, 1000, int(rng.integers(1, 30)))]
    sizes += sizes[:3]  # equal sizes: ties broken by path
    loads = [int(l) for l in rng.integers(0, 3000, world)]
    for rank in range(world):
        jm, jr = _plan("jax", sizes, 3, seed)
        tm, tr = _plan("torch", sizes, 3, seed)
        jkeep, jassign = jpartitioner.partition_write_reqs_with_assignment(
            jm, jr, _StubCoordinator(rank, loads)
        )
        tkeep, tassign = tpartitioner.partition_write_reqs_with_assignment(
            tm, tr, _StubCoordinator(rank, loads)
        )
        assert tassign == jassign
        assert [r.path for r in tkeep] == [r.path for r in jkeep]


def test_consolidate_replicated_entries_matches():
    def manifest(mf):
        moved = mf.ArrayEntry("batched/u", "raw", "float32", [2], replicated=True, byte_range=[8, 16])
        return {
            "0/m/w": mf.ArrayEntry("replicated/m/w", "raw", "float32", [2], replicated=True),
            "1/m/w": moved,
            "0/m/own": mf.ArrayEntry("0/m/own", "raw", "float32", [2]),
        }

    jm, tm = manifest(jmanifest), manifest(tmanifest)
    jpartitioner.consolidate_replicated_entries(jm)
    tpartitioner.consolidate_replicated_entries(tm)
    assert {k: tmanifest.entry_to_dict(v) for k, v in tm.items()} == {
        k: jmanifest.entry_to_dict(v) for k, v in jm.items()
    }

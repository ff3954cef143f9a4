"""Sequence-parallel state over the port, against
``tests/test_sequence_parallel.py``: a KV cache ``[batch, heads, seq,
head_dim]`` sharded on its sequence axis and ring-attention activations
sharded on theirs restore bit-exactly at another context-parallel degree,
a sequence-sharded array reads back whole, and a state of thousands of
small leaves plans, saves and restores (with batching, in a handful of
slab objects).

The JAX package writes on the 8 CPU devices of ``tests/conftest.py``
(context-parallel degree 8); four gloo ranks of the port restore at degree
2 on a ``(dp, cp)`` mesh and at degree 4, and take at degree 4 for the JAX
package to restore at degree 2 on a ``(4, 2)`` mesh. The same numpy
values go through both packages."""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.utils import knobs as jknobs
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.utils import knobs as tknobs

KV_SHAPE = (4, 8, 128, 16)
ACTS_SHAPE = (2, 256, 64)
X_SHAPE = (8, 32)


def _values():
    rng = np.random.default_rng(0)
    return {
        "k": rng.standard_normal(KV_SHAPE).astype(ml_dtypes.bfloat16),
        "v": rng.standard_normal(KV_SHAPE).astype(ml_dtypes.bfloat16),
        "resid": rng.standard_normal(ACTS_SHAPE).astype(np.float32),
        "x": np.arange(int(np.prod(X_SHAPE)), dtype=np.int32).reshape(X_SHAPE),
    }


def _bytes(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).tobytes()


def _mesh(shape, axes):
    return Mesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape), axes)


def _place(x, mesh, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _port_worker(rank, world_size, root):
    """Restores the JAX package's degree-8 snapshots at degrees 2 and 4,
    reads a sequence-sharded array whole, and takes the same state at
    degree 4."""
    import os as _os

    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    vals = _values()
    dp_cp = DeviceMesh("cpu", [[0, 1], [2, 3]], mesh_dim_names=("dp", "cp"))
    cache = tts.StateDict(
        k=dtensor_from_numpy(np.zeros_like(vals["k"]), dp_cp, [Shard(0), Shard(2)]),
        v=dtensor_from_numpy(np.zeros_like(vals["v"]), dp_cp, [Shard(0), Shard(2)]),
    )
    tts.Snapshot(_os.path.join(root, "jax_kv")).restore({"cache": cache}, device="cpu")
    for name in ("k", "v"):
        want = dtensor_from_numpy(vals[name], dp_cp, [Shard(0), Shard(2)]).to_local()
        assert torch.equal(cache[name].to_local().view(torch.int16), want.view(torch.int16)), name

    seq = DeviceMesh("cpu", list(range(world_size)), mesh_dim_names=("seq",))
    acts = tts.StateDict(resid=dtensor_from_numpy(np.zeros_like(vals["resid"]), seq, [Shard(1)]))
    tts.Snapshot(_os.path.join(root, "jax_acts")).restore({"a": acts}, device="cpu")
    assert torch.equal(acts["resid"].to_local(), dtensor_from_numpy(vals["resid"], seq, [Shard(1)]).to_local())

    x = tts.Snapshot(_os.path.join(root, "jax_x")).read_object("0/a/x", device="cpu")
    assert x.numpy().tobytes() == vals["x"].tobytes()

    cp4 = DeviceMesh("cpu", list(range(world_size)), mesh_dim_names=("cp",))
    tts.Snapshot.take(
        _os.path.join(root, "port_kv"),
        {"cache": tts.StateDict(k=dtensor_from_numpy(vals["k"], cp4, [Shard(2)]), v=dtensor_from_numpy(vals["v"], cp4, [Shard(2)]))},
    )
    tts.Snapshot.take(_os.path.join(root, "port_acts"), {"a": tts.StateDict(resid=dtensor_from_numpy(vals["resid"], cp4, [Shard(1)]))})
    tts.Snapshot.take(_os.path.join(root, "port_x"), {"a": tts.StateDict(x=dtensor_from_numpy(vals["x"], cp4, [Shard(1)]))})
    # The degree-4 take restores in the port too, replicated.
    whole = tts.StateDict(k=dtensor_from_numpy(np.zeros_like(vals["k"]), cp4, [Replicate()]))
    tts.Snapshot(_os.path.join(root, "port_kv")).restore({"cache": whole}, device="cpu")
    assert whole["k"].to_local().view(torch.int16).numpy().view(np.uint8).tobytes() == _bytes(vals["k"])
    with open(_os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump({"ok": True}, f)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The JAX package's degree-8 snapshots, then the port's four ranks."""
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    root = str(tmp_path_factory.mktemp("seqpar"))
    vals = _values()
    cp8 = _mesh((8,), ("cp",))
    jts.Snapshot.take(
        os.path.join(root, "jax_kv"),
        {"cache": jts.StateDict(k=_place(vals["k"], cp8, P(None, None, "cp", None)), v=_place(vals["v"], cp8, P(None, None, "cp", None)))},
    )
    sp8 = _mesh((8,), ("sp",))
    jts.Snapshot.take(os.path.join(root, "jax_acts"), {"a": jts.StateDict(resid=_place(vals["resid"], sp8, P(None, "sp", None)))})
    jts.Snapshot.take(os.path.join(root, "jax_x"), {"a": jts.StateDict(x=_place(vals["x"], sp8, P(None, "sp")))})
    run_with_processes(_port_worker, 4, args=(root,), process_group=True, timeout_s=240)
    return root


def test_kv_cache_restores_at_another_context_parallel_degree(fleet):
    """The port restored the degree-8 cache at degree 2 with the freed axis
    used for data parallelism (its ranks checked each local shard); the
    JAX package restores the port's degree-4 cache at degree 2 the same
    way."""
    assert all(json.load(open(os.path.join(fleet, f"rank{r}.json")))["ok"] for r in range(4))
    vals = _values()
    dp_cp = _mesh((4, 2), ("dp", "cp"))
    dst = jts.StateDict(
        k=_place(np.zeros_like(vals["k"]), dp_cp, P("dp", None, "cp", None)),
        v=_place(np.zeros_like(vals["v"]), dp_cp, P("dp", None, "cp", None)),
    )
    jts.Snapshot(os.path.join(fleet, "port_kv")).restore({"cache": dst})
    for name in ("k", "v"):
        assert _bytes(dst[name]) == _bytes(vals[name]), name


def test_ring_attention_activations_restore_at_another_degree(fleet):
    vals = _values()
    sp4 = _mesh((4, 2), ("seq", "rep"))
    dst = jts.StateDict(resid=_place(np.zeros_like(vals["resid"]), sp4, P(None, "seq", None)))
    jts.Snapshot(os.path.join(fleet, "port_acts")).restore({"a": dst})
    assert _bytes(dst["resid"]) == _bytes(vals["resid"])


def test_sequence_sharded_read_object_is_whole_in_both_directions(fleet):
    got = jts.Snapshot(os.path.join(fleet, "port_x")).read_object("0/a/x")
    assert _bytes(got) == _bytes(_values()["x"])
    got = tts.Snapshot(os.path.join(fleet, "jax_x")).read_object("0/a/x", device="cpu")
    assert got.numpy().tobytes() == _values()["x"].tobytes()


@pytest.mark.parametrize("batching", [False, True], ids=["plain", "batched"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_many_small_params_plan_and_cross_restore(tmp_path, writer, batching):
    """2000 leaves: with batching, a handful of slab objects; the other
    package restores every leaf."""
    n = 2000
    tree = {f"p{i}": np.full((4,), i, dtype=np.float32) for i in range(n)}
    path = str(tmp_path / "many")
    if writer == "jax":
        with jknobs.override_batching_enabled(batching):
            jts.Snapshot.take(path, {"m": jts.StateDict(**tree)})
    else:
        with tknobs.override_batching_enabled(batching):
            tts.Snapshot.take(path, {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))})
    if batching:
        assert 0 < len(os.listdir(os.path.join(path, "batched"))) < 10
    if writer == "jax":
        out = tts.StateDict()
        tts.Snapshot(path).restore({"m": out}, device="cpu")
        got = {k: v.numpy() for k, v in out.items()}
    else:
        out = jts.StateDict()
        jts.Snapshot(path).restore({"m": out})
        got = {k: np.asarray(v) for k, v in out.items()}
    assert len(got) == n
    assert all(got[k].tobytes() == v.tobytes() for k, v in tree.items())

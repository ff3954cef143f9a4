"""The width of a take's hash pool (``knobs.get_hash_workers``, chosen in
``Snapshot._take_impl``): a take whose caller waits for the commit hashes
on the usable CPUs over the ranks sharing the host, less two, and at least
the staging width; an async take's drain, which races the caller's steps,
keeps the staging width; ``TSS_TORCH_HASH_WORKERS`` wins in both. The
chunk jobs in flight follow the pipeline's width. The sidecars do not
depend on it, and match the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.utils import knobs as jknobs
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import hashing, scheduler
from torchsnapshot_tpu_torch import snapshot as tsnap
from torchsnapshot_tpu_torch.utils import knobs

GRAIN = 4096


def _state():
    """Objects over the grain (chunk-hashed, v2) and within it (v1)."""
    rng = np.random.default_rng(21)
    out = {f"w{i}": rng.integers(0, 255, size=(16 * 1024,), dtype=np.uint8).view(np.float32).copy() for i in range(3)}
    out["b"] = rng.standard_normal(64).astype(np.float32)
    return out


def _app(state):
    return {"m": tts.StateDict(**{k: torch.from_numpy(v.copy()) for k, v in state.items()})}


@pytest.fixture
def host(monkeypatch):
    """``host(cpus, local_world)`` makes the take see that many usable CPUs
    and ranks on its host; records each hash pool's width and each
    chunk hasher's jobs in flight."""
    monkeypatch.delenv("TSS_TORCH_HASH_WORKERS", raising=False)
    seen = {"pools": [], "inflight": []}
    real_pool, real_hasher = scheduler.ThreadPoolExecutor, hashing.ChunkHasher

    def pool(max_workers=None, thread_name_prefix="", **kw):
        if thread_name_prefix == "tss-hash":
            seen["pools"].append(max_workers)
        return real_pool(max_workers, thread_name_prefix=thread_name_prefix, **kw)

    class Hasher(real_hasher):
        def __init__(self, grain, want_sha, loop, executor, max_inflight=None, **kw):
            seen["inflight"].append(max_inflight)
            super().__init__(grain, want_sha, loop, executor, max_inflight, **kw)

    monkeypatch.setattr(scheduler, "ThreadPoolExecutor", pool)
    monkeypatch.setattr(hashing, "ChunkHasher", Hasher)

    def set_host(cpus, local_world=1):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)))
        monkeypatch.setattr(knobs, "_local_world_size", local_world)
        return seen

    return set_host


def _take(kind, path):
    with knobs.override_hash_chunk_bytes(GRAIN):
        if kind == "take":
            tts.Snapshot.take(path, _app(_state()))
            return tsnap.LAST_SYNC_DRAIN_STATS["hash_workers"]
        pending = tts.Snapshot.async_take(path, _app(_state()))
        pending.wait()
        return pending.drain_stats["hash_workers"]


@pytest.mark.parametrize(
    "cpus,local_world,width",
    [(8, 1, 6), (16, 1, 14), (16, 2, 6), (6, 1, 4), (8, 4, 4), (1, 1, 4)],
)
def test_a_take_whose_caller_waits_hashes_on_the_cores_it_leaves(tmp_path, host, cpus, local_world, width):
    seen = host(cpus, local_world)
    assert knobs.get_hash_workers(caller_waits=True) == width
    assert _take("take", str(tmp_path / "s")) == width
    assert seen["pools"] == [width]
    assert seen["inflight"] and set(seen["inflight"]) == {2 * width}


@pytest.mark.parametrize("cpus", [8, 16])
def test_a_drain_that_races_the_caller_keeps_the_staging_width(tmp_path, host, cpus):
    seen = host(cpus)
    assert _take("async_take", str(tmp_path / "s")) == 4
    assert seen["pools"] == [4] and set(seen["inflight"]) == {8}
    # The default the JAX package shares: the staging width.
    assert knobs.get_hash_workers() == jknobs.get_hash_workers() == knobs.get_staging_threads()


@pytest.mark.parametrize("kind", ["take", "async_take"])
def test_the_environment_wins(tmp_path, host, kind):
    seen = host(16)
    with knobs.override_hash_workers(3):
        assert _take(kind, str(tmp_path / "s")) == 3
    assert seen["pools"] == [3] and set(seen["inflight"]) == {6}
    with knobs.override_staging_threads(9):
        # The staging width floors a waiting caller's width and is a
        # racing drain's.
        assert knobs.get_hash_workers(caller_waits=True) == 14
        assert knobs.get_hash_workers() == 9
        host(8)
        assert knobs.get_hash_workers(caller_waits=True) == 9


def _sidecar(path):
    with open(os.path.join(path, ".checksums.0"), "rb") as f:
        return f.read()


def test_sidecars_do_not_depend_on_the_width(tmp_path):
    state = _state()
    sidecars = {}
    for width in (1, 4, 6):
        path = str(tmp_path / f"w{width}")
        with knobs.override_hash_workers(width), knobs.override_hash_chunk_bytes(GRAIN), knobs.override_dedup_digests(True):
            tts.Snapshot.take(path, _app(state))
        sidecars[width] = _sidecar(path)
    assert sidecars[1] == sidecars[4] == sidecars[6]
    records = json.loads(sidecars[6])
    assert any(isinstance(r, dict) and r["v"] == 2 for r in records.values())
    assert any(isinstance(r, list) for r in records.values())
    # The JAX package records the same digests, and each package restores
    # the other's snapshot byte for byte.
    jpath = str(tmp_path / "jax")
    with jknobs.override_hash_chunk_bytes(GRAIN), jknobs.override_dedup_digests(True):
        jts.Snapshot.take(jpath, {"m": jts.StateDict(**state)})
    assert json.loads(_sidecar(jpath)) == records
    jout = jts.StateDict(**{k: np.zeros_like(v) for k, v in state.items()})
    jts.Snapshot(str(tmp_path / "w6")).restore({"m": jout})
    tout = tts.StateDict(**{k: torch.zeros(v.shape) for k, v in state.items()})
    tts.Snapshot(jpath).restore({"m": tout}, device="cpu")
    for k, v in state.items():
        assert np.asarray(jout[k]).view(np.uint8).tobytes() == v.view(np.uint8).tobytes(), k
        assert tout[k].numpy().view(np.uint8).tobytes() == v.view(np.uint8).tobytes(), k

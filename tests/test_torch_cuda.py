"""Tests of the torch port that need an NVIDIA GPU (marker ``cuda``).

They skip on a host without CUDA. This file imports neither JAX nor the
JAX package, so it also runs on a GPU host that has only PyTorch; there,
skip the JAX-importing ``tests/conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math
import os

import pytest
import torch

# The trainer test runs cuBLAS deterministically, which needs this before
# CUDA starts.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import io_preparer, kernels
from torchsnapshot_tpu_torch.utils import knobs

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _members(dtype, device, seed):
    """0-dim, empty, one-element, odd-sized members, a matrix and its
    transposed view; the odd sizes put later members at unaligned slab
    offsets."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape in [(), (0, 3), (1,), (7,), (3, 5), (1001,)]:
        if dtype == torch.bool:
            t = torch.randint(0, 2, shape, generator=g, device=device).bool()
        elif dtype.is_floating_point:
            t = torch.randn(shape, generator=g, device=device).to(dtype)
        else:
            t = torch.randint(0, 100, shape, generator=g, device=device).to(dtype)
        out.append(t)
    out.append(out[4].t())
    return out


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dtype", sorted(kernels.PACKABLE_DTYPES, key=str), ids=str)
def test_pack_slab_kernel_matches_plain(device, dtype):
    members = _members(dtype, device, 1)
    base = torch.arange(300, dtype=torch.uint8, device=device)
    members.append(base[1:200])  # source at an odd address
    before = kernels.LAUNCHES["pack_slab"]
    got = kernels.pack_slab(members)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pack_slab"] == before + 1
    assert torch.equal(got, kernels.pack_slab_plain(members))


@pytest.mark.parametrize("dtype", sorted(kernels.PACKABLE_DTYPES, key=str), ids=str)
def test_fork_copy_kernel_matches_plain(device, dtype):
    members = _members(dtype, device, 2)
    before = kernels.LAUNCHES["fork_copy"]
    copies = kernels.fork_copy(members)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fork_copy"] == before + 1
    for t, c in zip(members, copies):
        assert c.dtype == t.dtype and c.shape == t.shape and c.device == t.device
        if t.numel() > 1:
            assert c.stride() == t.stride() and c.data_ptr() != t.data_ptr()
        assert torch.equal(_bytes(c), _bytes(t))


def test_kernels_on_a_large_member(device):
    big = torch.randn(25_000_000, device=device).to(torch.bfloat16)
    small = torch.arange(3, dtype=torch.int16, device=device)
    assert torch.equal(kernels.pack_slab([small, big]), kernels.pack_slab_plain([small, big]))
    assert torch.equal(kernels.fork_copy([big])[0], big)


@pytest.mark.parametrize("batching", [False, True], ids=["plain", "batched"])
def test_cuda_take_restore_and_async_mutation(device, tmp_path, batching):
    g = torch.Generator(device=device).manual_seed(0)
    state = {
        "w": torch.randn(256, 96, generator=g, device=device).to(torch.bfloat16),
        "wt": torch.randn(64, 32, generator=g, device=device).t(),
        "b": torch.randn(96, generator=g, device=device),
        "step": torch.tensor(3, device=device),
        "cpu": torch.arange(10),
        "n": 5,
    }
    with knobs.override_batching_enabled(batching), knobs.override_max_chunk_size_bytes(16384):
        kernels.reset_launch_counts()
        tts.Snapshot.take(str(tmp_path / "s"), {"m": tts.StateDict(state)})
        if batching:
            assert kernels.LAUNCHES["pack_slab"] >= 1
        assert tts.Snapshot(str(tmp_path / "s")).verify() == {}
        target = tts.StateDict({k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else None for k, v in state.items()})
        tts.Snapshot(str(tmp_path / "s")).restore({"m": target})
        for k, v in state.items():
            if isinstance(v, torch.Tensor):
                assert target[k].device == v.device and torch.equal(_bytes(target[k]), _bytes(v)), k
        got = tts.Snapshot(str(tmp_path / "s")).read_object("0/m/w")
        assert got.is_cuda and torch.equal(got, state["w"])

        before = {k: v.clone() for k, v in state.items() if isinstance(v, torch.Tensor)}
        captured = io_preparer.HOST_CAPTURED["leaves"]
        kernels.reset_launch_counts()
        pending = tts.Snapshot.async_take(str(tmp_path / "a"), {"m": tts.StateDict(state)})
        for v in before:
            state[v].add_(1)
        pending.wait()
        assert kernels.LAUNCHES["fork_copy"] == 1
        assert io_preparer.HOST_CAPTURED["leaves"] == captured
        target = tts.StateDict()
        tts.Snapshot(str(tmp_path / "a")).restore({"m": target})
        for k, v in before.items():
            assert torch.equal(_bytes(target[k].cpu()), _bytes(v.cpu())), k


def _view_pairs(dtype, device, seed):
    """Strided (source, destination) views: 0-d, empty, odd widths at odd
    addresses, 3-D blocks, a transposed source, a strided last dim and a
    column block of a wide matrix (the reshard restore's rectangle)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        if dtype == torch.bool:
            return torch.randint(0, 2, shape, generator=g, device=device).bool()
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device=device).to(dtype)
        return torch.randint(0, 100, shape, generator=g, device=device).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device).to(dtype)

    a = rand(9, 12, 5)
    wide = rand(64, 96)
    return [
        (rand(), zeros()),
        (a[0:0, :9], zeros(12, 9, 5)[0:0]),
        (rand(37)[1:34], zeros(40)[5:38]),
        (a[2:7, 3:11, 1:4], zeros(12, 9, 5)[4:9, 0:8, 2:5]),
        (a[1:3].transpose(0, 1), zeros(12, 9, 5)[0:12, 4:6, :]),
        (a[1:3, :, 2], zeros(12, 9, 5)[:, 2:4, 1].t()),
        (wide[:, 48:], zeros(64, 96)[:, :48]),
    ]


@pytest.mark.parametrize("dtype", sorted(kernels.PACKABLE_DTYPES, key=str), ids=str)
def test_copy_blocks_kernel_matches_plain(device, dtype):
    pairs = _view_pairs(dtype, device, 3)
    want = [dst.clone() for _, dst in pairs]
    kernels.copy_blocks_plain([(s, w) for (s, _), w in zip(pairs, want)])
    before = kernels.LAUNCHES["copy_blocks"]
    kernels.copy_blocks(pairs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["copy_blocks"] == before + 1
    for (_, dst), w in zip(pairs, want):
        assert torch.equal(_bytes(dst), _bytes(w))


def test_copy_blocks_main_path_rectangle(device):
    """One reshard rectangle of the main path: 2048x8192 bf16 into the
    right half of 2048x16384 rows (32 KiB destination pitch)."""
    src = torch.randn(2048, 8192, device=device).to(torch.bfloat16)
    dst = torch.zeros(2048, 16384, device=device, dtype=torch.bfloat16)
    kernels.copy_blocks([(src, dst[:, 8192:])])
    torch.cuda.synchronize()
    assert torch.equal(dst[:, 8192:], src) and not dst[:, :8192].any()


def test_gather_makes_strided_views_contiguous(device):
    a = torch.randn(40, 30, device=device)
    g = kernels.gather(a[3:37, 5:21])
    assert g.is_contiguous() and torch.equal(g, a[3:37, 5:21])


def _check_k3(pairs, descriptors=None):
    """K3 on ``pairs`` in one launch, byte-exact against the plain version
    on copies of the destinations' whole allocations."""
    bases = {}
    for _, d in pairs:
        b = d._base if d._base is not None else d
        bases[b.data_ptr()] = b
    want = {k: b.clone() for k, b in bases.items()}
    views = []
    for s_, d in pairs:
        b = d._base if d._base is not None else d
        w = want[b.data_ptr()]
        views.append((s_, w.as_strided(d.shape, d.stride(), d.storage_offset())))
    kernels.copy_blocks_plain(views)
    if descriptors is not None:
        assert len(kernels.rect_table(pairs)[0]) == descriptors
    before = kernels.LAUNCHES["copy_blocks"]
    kernels.copy_blocks(pairs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["copy_blocks"] == before + 1
    for k, b in bases.items():
        assert torch.equal(_bytes(b), _bytes(want[k]))


@pytest.mark.parametrize("strided_last", [False, True], ids=["row", "strided"])
@pytest.mark.parametrize("rank", [4, 5, 6, 7])
def test_copy_blocks_high_rank_views(device, rank, strided_last):
    """A corner of a larger tensor that keeps ``rank`` dims: one
    descriptor up to five dims outside the contiguous row, a sixth cut on
    the outermost dim, a seventh on the two outermost."""
    g = torch.Generator(device=device).manual_seed(rank)
    shape = [3, 5, 4, 6, 7, 9, 33][-rank:]
    big = torch.randn([n + 1 for n in shape], generator=g, device=device)
    src = big[tuple(slice(1, None) for _ in shape)]
    dst = torch.zeros([n + 2 for n in shape], device=device)[tuple(slice(0, n) for n in shape)]
    if strided_last:
        src, dst = src[..., ::2], dst[..., ::2]
    cut = max(0, rank - (0 if strided_last else 1) - kernels.K3_MAX_DIMS)
    _check_k3([(src, dst)], math.prod(src.shape[:cut]))


@pytest.mark.parametrize("units", [33, 300], ids=["narrow", "wide"])
@pytest.mark.parametrize("grain", [1, 2, 4, 8, 16])
def test_copy_blocks_every_grain(device, grain, units):
    """Rows of ``units`` grain units at a ``grain``-byte offset: K3's
    grain is exactly ``grain``; narrow rows take the lane groups, wide
    ones (at least 256 units) the segment walk."""
    row = grain * units
    src = torch.randint(0, 256, (64, row + 64), device=device, dtype=torch.uint8)
    dst = torch.zeros(64, row + 96, device=device, dtype=torch.uint8)
    pairs = [(src[:, grain:grain + row], dst[:, 32:32 + row])]
    table, _ = kernels.rect_table(pairs)
    assert table["grain"][0] == grain
    _check_k3(pairs, 1)


@pytest.mark.parametrize("over", [0, 1], ids=["inline", "uploaded"])
def test_copy_blocks_tables_inline_and_uploaded(device, over):
    """The largest table the kernel takes by value, and one descriptor
    more, which goes through the reused pinned buffer."""
    n = kernels.load_library().tss_copy_blocks_inline_max() + over
    base = torch.randint(-1000, 1000, (n, 4, 24), device=device, dtype=torch.int16)
    out = torch.zeros(n, 4, 40, device=device, dtype=torch.int16)
    _check_k3([(base[i, :, 3:21], out[i, :, 8:26]) for i in range(n)], n)


def test_uploaded_tables_back_to_back_on_two_streams(device):
    """Uploaded tables reuse one pinned buffer: calls queued on two
    streams behind a long copy each still copy their own pairs."""
    n = kernels.load_library().tss_copy_blocks_inline_max() + 5
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    big = torch.randn(64 << 20, device=device)
    sink = torch.empty_like(big)
    outs = []
    for i in range(6):
        stream = streams[i % 2]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            sink.copy_(big)  # keeps the stream busy while the host goes on
            src = torch.full((n, 3, 8), float(i), device=device)
            dst = torch.zeros(n, 3, 16, device=device)
            kernels.copy_blocks([(src[j], dst[j, :, 4:12]) for j in range(n)], stream)
            outs.append((i, dst))
    torch.cuda.synchronize()
    for i, dst in outs:
        assert (dst[:, :, 4:12] == i).all() and not dst[:, :, :4].any() and not dst[:, :, 12:].any()


def test_gather_of_a_permuted_attention_tensor(device):
    """``gather`` of ``x.transpose(1, 2)`` ([batch, seq, heads, head_dim]
    to [batch, heads, seq, head_dim]): one descriptor, one launch."""
    x = torch.randn(2, 64, 8, 128, device=device).to(torch.bfloat16)
    v = x.transpose(1, 2)
    assert len(kernels.rect_table([(v, torch.empty(v.shape, device=device, dtype=v.dtype))])[0]) == 1
    before = kernels.LAUNCHES["copy_blocks"]
    g = kernels.gather(v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["copy_blocks"] == before + 1
    assert g.is_contiguous() and torch.equal(g, v.contiguous())


def _two_rank_reshard(rank, world_size, root):
    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    torch.cuda.set_device(0)
    mesh = DeviceMesh("cuda", list(range(world_size)))
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((16, 96)).astype(np.float32),
         "b": rng.integers(0, 100, (7, 5)).astype(np.int16),
         "r": rng.standard_normal((16,)).astype(np.float32)}
    before = {"a": [Shard(1)], "b": [Shard(0)], "r": [Replicate()]}
    after = {"a": [Shard(0)], "b": [Shard(1)], "r": [Replicate()]}
    state = {k: dtensor_from_numpy(v, mesh, before[k]) for k, v in g.items()}
    state["mine"] = torch.full((3,), float(rank), device="cuda")
    with knobs.override_max_shard_size_bytes(1024):  # pieces cut on dim 1: K3 gathers
        kernels.reset_launch_counts()
        tts.Snapshot.take(os.path.join(root, "s"), {"m": tts.StateDict(state)})
        assert kernels.LAUNCHES["copy_blocks"] >= 1
    assert tts.Snapshot(os.path.join(root, "s")).verify() == {}
    target = {k: dtensor_from_numpy(np.zeros_like(v), mesh, after[k]) for k, v in g.items()}
    ptrs = {k: t.to_local().data_ptr() for k, t in target.items()}
    target["mine"] = torch.zeros(3, device="cuda")
    sd = tts.StateDict(target)
    kernels.reset_launch_counts()
    tts.Snapshot(os.path.join(root, "s")).restore({"m": sd})
    assert kernels.LAUNCHES["copy_blocks"] >= 1
    for k in g:
        want = dtensor_from_numpy(g[k], mesh, after[k]).to_local()
        assert sd[k].to_local().data_ptr() == ptrs[k]
        assert torch.equal(_bytes(sd[k].to_local()), _bytes(want)), k
    assert torch.equal(sd["mine"], torch.full((3,), float(rank), device="cuda"))
    full = tts.Snapshot(os.path.join(root, "s")).read_object("0/m/a")
    assert full.is_cuda and torch.equal(full.cpu(), torch.from_numpy(g["a"]))


def test_two_ranks_on_one_card_reshard(device, tmp_path):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_two_rank_reshard, 2, args=(str(tmp_path),), process_group=True)


def test_small_trainer_async_take_races_adamw_and_resumes(device, tmp_path):
    """``chip_smoke.py``'s phase 4 at a small size: a 2-layer bf16
    transformer with ``foreach`` AdamW; ``async_take`` at step 3 races the
    in-place updates of steps 4-6; a restore into a fresh model and
    optimizer resumes bit-identically; a sync take restores in place."""
    from torchsnapshot_tpu_torch import dryrun
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=1024, d_model=256, n_heads=4, n_layers=2, d_ff=1024, max_seq_len=128)
    captured = io_preparer.HOST_CAPTURED["leaves"]
    with knobs.override_batching_enabled(True):
        kernels.reset_launch_counts()
        out = dryrun.train_checkpoint_resume(cfg, str(tmp_path), device=device, batch=4)
    assert kernels.LAUNCHES["fork_copy"] >= 1 and kernels.LAUNCHES["pack_slab"] >= 1
    assert io_preparer.HOST_CAPTURED["leaves"] == captured
    assert len(out["losses"]) == 6 and out["n_tensors"] == 4 * (12 * cfg.n_layers + 6)


def test_prepare_cache_hit_rebuilds_the_descriptor_table(device, tmp_path, monkeypatch):
    """Two async takes of the same structure, the second a prepared-take
    hit. The first take's forks are kept alive, so the second's are new
    allocations: K1's table on the hit must point into the new forks (it is
    rebuilt at every launch, never cached), and both snapshots restore
    bit-exactly."""
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod

    forks, packed = [], []
    fork_copy, launch = kernels.fork_copy, kernels._launch

    def recording_fork(tensors, stream=None):
        outs = fork_copy(tensors, stream=stream)
        forks.append(outs)
        return outs

    def recording_launch(name, srcs, dst_ptrs, dev, stream):
        if name == "pack_slab":
            packed.append([t.data_ptr() for t in srcs if t.numel()])
        return launch(name, srcs, dst_ptrs, dev, stream)

    monkeypatch.setattr(kernels, "fork_copy", recording_fork)
    monkeypatch.setattr(kernels, "_launch", recording_launch)
    g = torch.Generator(device=device).manual_seed(5)
    state = {f"p{i}": torch.randn(37 + i, 5, generator=g, device=device) for i in range(6)}
    values = []
    with knobs.override_batching_enabled(True):
        for take in range(2):
            values.append({k: v.clone() for k, v in state.items()})
            packed.clear()
            tts.Snapshot.async_take(str(tmp_path / f"s{take}"), {"m": tts.StateDict(state)}).wait()
            assert snapshot_mod.LAST_TAKE_CACHE["prepared_cache_hit"] == (take == 1)
            fork_ptrs = {t.data_ptr() for t in forks[-1]}
            assert packed and all(set(p) <= fork_ptrs for p in packed)
            for v in state.values():
                v.add_(1)
    assert not {t.data_ptr() for t in forks[0]} & {t.data_ptr() for t in forks[1]}
    for take in range(2):
        target = tts.StateDict({k: torch.zeros_like(v) for k, v in state.items()})
        tts.Snapshot(str(tmp_path / f"s{take}")).restore({"m": target})
        for k, v in values[take].items():
            assert torch.equal(_bytes(target[k]), _bytes(v)), (take, k)


def test_compressed_restore_into_cuda_tensors_in_place(device, tmp_path):
    g = torch.Generator(device=device).manual_seed(6)
    state = {
        "w": torch.randint(-8, 8, (300, 64), generator=g, device=device).to(torch.bfloat16),
        "b": torch.randn(64, generator=g, device=device),
        "s": torch.arange(10, device=device),
    }
    with knobs.override_compression("zlib"), knobs.override_compression_frame_bytes(4096), knobs.override_batching_enabled(True):
        kernels.reset_launch_counts()
        tts.Snapshot.take(str(tmp_path / "z"), {"m": tts.StateDict(state)})
        assert kernels.LAUNCHES["pack_slab"] >= 1  # the compressed slab, packed on the card
    manifest = tts.Snapshot(str(tmp_path / "z")).get_manifest()
    assert manifest["0/m/w"].frame_bytes == 4096 and manifest["0/m/b"].raw_range is not None
    target = tts.StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    ptrs = {k: v.data_ptr() for k, v in target.items()}
    tts.Snapshot(str(tmp_path / "z")).restore({"m": target})
    for k, v in state.items():
        assert target[k].data_ptr() == ptrs[k] and torch.equal(_bytes(target[k]), _bytes(v)), k
    member = tts.Snapshot(str(tmp_path / "z")).read_object("0/m/b")
    framed = tts.Snapshot(str(tmp_path / "z")).read_object("0/m/w", memory_budget_bytes=10000)
    assert member.is_cuda and torch.equal(member, state["b"])
    assert framed.is_cuda and torch.equal(_bytes(framed), _bytes(state["w"]))


def _framed_reshard(rank, world_size, root):
    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy
    from torchsnapshot_tpu_torch.io_preparers import sharded_array

    torch.cuda.set_device(0)
    mesh = DeviceMesh("cuda", list(range(world_size)))
    rng = np.random.default_rng(1)
    # 96-byte rows, 100-byte frames: no frame boundary falls on a row
    # boundary, so each piece's frames decode a superset of its rows.
    g = {"a": rng.integers(-4, 4, (32, 24)).astype(np.float32)}
    state = {"a": dtensor_from_numpy(g["a"], mesh, [Shard(0)])}
    with knobs.override_compression("zlib"), knobs.override_compression_frame_bytes(100):
        tts.Snapshot.take(os.path.join(root, "s"), {"m": tts.StateDict(state)})
    framed = []
    plain = sharded_array._framed_shard_reads

    def counting(*args, **kwargs):
        reqs = plain(*args, **kwargs)
        framed.extend(reqs)
        return reqs

    sharded_array._framed_shard_reads = counting
    os.environ["TSS_TORCH_PER_RANK_MEMORY_BUDGET_BYTES"] = "500"
    target = {"a": dtensor_from_numpy(np.zeros_like(g["a"]), mesh, [Shard(1)])}
    ptr = target["a"].to_local().data_ptr()
    sd = tts.StateDict(target)
    kernels.reset_launch_counts()
    tts.Snapshot(os.path.join(root, "s")).restore({"m": sd})
    assert framed and kernels.LAUNCHES["copy_blocks"] >= len(framed)
    consumers = [r.buffer_consumer for r in framed]
    assert any(c.raw_begin != c.group_raw_begin for c in consumers)  # supersets
    want = dtensor_from_numpy(g["a"], mesh, [Shard(1)]).to_local()
    assert sd["a"].to_local().data_ptr() == ptr and torch.equal(_bytes(sd["a"].to_local()), _bytes(want))


def test_framed_sharded_restore_through_k3(device, tmp_path):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_framed_reshard, 2, args=(str(tmp_path),), process_group=True)


def test_device_memory_returns_after_wait_on_a_hit(device, tmp_path):
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod

    g = torch.Generator(device=device).manual_seed(7)
    state = {f"p{i}": torch.randn(1024, 256, generator=g, device=device) for i in range(4)}
    with knobs.override_batching_enabled(True):
        for take in range(2):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(device)
            tts.Snapshot.async_take(str(tmp_path / f"s{take}"), {"m": tts.StateDict(state)}).wait()
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated(device) <= before, take
    assert snapshot_mod.LAST_TAKE_CACHE["prepared_cache_hit"]


def test_small_frozen_finetune_checkpoints(device, tmp_path):
    """``chip_smoke.py``'s phase 5 at a small size."""
    from torchsnapshot_tpu_torch import dryrun
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=1024, d_model=256, n_heads=4, n_layers=4, d_ff=1024, max_seq_len=128)
    kernels.reset_launch_counts()
    out = dryrun.frozen_finetune_checkpoints(cfg, str(tmp_path), device=device, batch=4, frozen_blocks=2)
    assert kernels.LAUNCHES["fork_copy"] == 4 and kernels.LAUNCHES["pack_slab"] >= 1
    # The batched hit packed its slabs with K1 over its own forks.
    assert out["c5_cache"]["prepared_cache_hit"] and out["c5_launches"]["pack_slab"] >= 1
    assert out["c5_launches"]["fork_copy"] == 1
    assert out["c2_bytes_deduped"] >= out["frozen_bytes"] and out["c2_samefile"] >= 1


def test_small_continuous_checkpoints(device, tmp_path):
    """``chip_smoke.py``'s phase 7 at a small size: managed chains over CUDA
    state, retention, restores of the retained pair and the debris sweep."""
    from torchsnapshot_tpu_torch import dryrun
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    os.environ["TSS_TORCH_DEDUP_DIGESTS"] = "1"
    cfg = TransformerConfig(vocab_size=1024, d_model=256, n_heads=4, n_layers=4, d_ff=1024, max_seq_len=128)
    kernels.reset_launch_counts()
    out = dryrun.continuous_checkpoints(cfg, str(tmp_path), device=device, batch=4, frozen_blocks=2)
    assert kernels.LAUNCHES["fork_copy"] == 4 and kernels.LAUNCHES["pack_slab"] >= 6
    assert out["chain_lens"] == [0, 1, 2, 0, 1, 2]
    assert out["retain_applied"]["condemned"] == ["t1", "t2", "t3", "t4"]
    t6 = out["takes"]["t6"]["record"]
    assert t6["bytes_deduped"] > 0 and out["t6_cached_attribution"]["origin_bytes"] == t6["bytes_written"]


def _pinned_h2d_probe(monkeypatch_target):
    """Wrap the whole-tensor H2D (T2) to record whether each host source
    was pinned."""
    from torchsnapshot_tpu_torch import d2h

    seen = []
    inner = d2h.host_to_device

    def probe(host, live, device, stream):
        seen.append(bool(host.is_pinned()))
        return inner(host, live, device, stream)

    monkeypatch_target.host_to_device = probe
    return seen


def _cuda_bcast_swarm(rank, world_size, root):
    import json

    import numpy as np

    from torchsnapshot_tpu_torch import bcast, d2h, snapshot, swarm

    torch.cuda.set_device(0)
    os.environ["TSS_TORCH_DEDUP_DIGESTS"] = "1"
    os.environ["TSS_TORCH_HASH_CHUNK_BYTES"] = "65536"
    rng = np.random.default_rng(0)
    g = {"emb": rng.standard_normal((512, 256)).astype(np.float32),  # 512 KiB
         "w": rng.standard_normal((64, 64)).astype(np.float32),
         "ids": rng.integers(0, 9, 1000).astype(np.int64)}
    state = {k: torch.from_numpy(v).cuda() for k, v in g.items()}
    path = os.path.join(root, "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(state)}, replicated=["**"])
    seen = _pinned_h2d_probe(d2h)
    out = {}
    for mode, cap in (("bcast", str(1 << 20)), ("swarm", "4096")):
        os.environ["TSS_TORCH_BCAST_RESTORE"] = "1"
        os.environ["TSS_TORCH_SWARM_RESTORE"] = "1"
        os.environ["TSS_TORCH_BCAST_MAX_BYTES"] = cap
        target = {k: torch.zeros_like(v) for k, v in state.items()}
        ptrs = {k: t.data_ptr() for k, t in target.items()}
        sd = tts.StateDict(target)
        tts.Snapshot(path).restore({"m": sd})
        for k in g:
            assert sd[k].is_cuda and sd[k].data_ptr() == ptrs[k], k
            assert torch.equal(_bytes(sd[k]), _bytes(state[k])), (mode, k)
        out[mode] = {
            "recv": bcast.LAST_RESTORE_BCAST["recv_bytes"],
            "peer": swarm.LAST_RESTORE_SWARM["peer_bytes"],
            "origin": snapshot.LAST_RESTORE_STATS["attribution"]["origin_bytes"],
        }
    assert seen and all(seen), seen
    with open(os.path.join(root, f"r{rank}.json"), "w") as f:
        json.dump(out, f)


def test_bcast_and_swarm_payloads_land_in_cuda_targets_through_pinned_buffers(device, tmp_path):
    import json

    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_cuda_bcast_swarm, 2, args=(str(tmp_path),), process_group=True)
    recs = [json.load(open(tmp_path / f"r{r}.json")) for r in range(2)]
    assert sum(r["bcast"]["recv"] for r in recs) > 0
    assert sum(r["swarm"]["peer"] for r in recs) > 0
    total = 512 * 256 * 4 + 64 * 64 * 4 + 1000 * 8
    assert sum(r["bcast"]["origin"] for r in recs) == total
    assert sum(r["swarm"]["origin"] for r in recs) <= 1.1 * total


def test_verified_reads_into_cuda_tensors(device, tmp_path, monkeypatch):
    from torchsnapshot_tpu_torch import scheduler

    monkeypatch.setenv("TSS_TORCH_VERIFY_READS", "all")
    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(1024, 1024, generator=g, device=device).to(torch.bfloat16)
    path = str(tmp_path / "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=x)})
    sd = tts.StateDict(x=torch.zeros_like(x))
    tts.Snapshot(path).restore({"m": sd})
    assert torch.equal(_bytes(sd["x"]), _bytes(x))
    with open(os.path.join(path, "0/m/x"), "r+b") as f:
        f.seek(12345)
        b = f.read(1)
        f.seek(12345)
        f.write(bytes([b[0] ^ 1]))
    target = torch.zeros_like(x)
    with pytest.raises(tts.CheckpointAbortedError) as info:
        tts.Snapshot(path).restore({"m": tts.StateDict(x=target)})
    assert isinstance(info.value.__cause__, scheduler.ReadVerificationError)
    torch.cuda.synchronize()
    # Checked on the host before the H2D: the live tensor was never written.
    assert not target.any()


def _swarm_reshard(rank, world_size, root):
    import json

    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import swarm
    from torchsnapshot_tpu_torch.convert import dtensor_from_numpy

    torch.cuda.set_device(0)
    os.environ["TSS_TORCH_DEDUP_DIGESTS"] = "1"
    os.environ["TSS_TORCH_HASH_CHUNK_BYTES"] = "65536"
    mesh = DeviceMesh("cuda", list(range(world_size)))
    a = np.random.default_rng(1).standard_normal((256, 512)).astype(np.float32)
    path = os.path.join(root, "s")
    tts.Snapshot.take(path, {"m": tts.StateDict(a=dtensor_from_numpy(a, mesh, [Shard(0)]))})
    os.environ["TSS_TORCH_SWARM_RESTORE"] = "1"
    target = dtensor_from_numpy(np.zeros_like(a), mesh, [Shard(1)])
    sd = tts.StateDict(a=target)
    kernels.reset_launch_counts()
    tts.Snapshot(path).restore({"m": sd})
    launches = kernels.LAUNCHES["copy_blocks"]
    want = dtensor_from_numpy(a, mesh, [Shard(1)]).to_local()
    assert torch.equal(_bytes(sd["a"].to_local()), _bytes(want))
    rec = swarm.LAST_RESTORE_SWARM
    with open(os.path.join(root, f"r{rank}.json"), "w") as f:
        json.dump({"k3": launches, "origin": rec["origin_bytes"], "peer": rec["peer_bytes"]}, f)


def test_swarm_reshard_into_dtensors_launches_k3(device, tmp_path):
    import json

    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_swarm_reshard, 2, args=(str(tmp_path),), process_group=True)
    recs = [json.load(open(tmp_path / f"r{r}.json")) for r in range(2)]
    assert all(r["k3"] > 0 for r in recs), recs
    assert all(r["peer"] > 0 for r in recs), recs
    # Each rank needs every row of both saved shards: one origin copy.
    assert sum(r["origin"] for r in recs) == 256 * 512 * 4


# The H100's host link: PCIe 5.0 x16, 128 GB/s both ways together (NVIDIA's
# data sheet), so at most 64 GB/s device to host. A stage.d2h span that
# closed when its copy was enqueued, not done, would imply a faster rate.
HOST_LINK_BYTES_PER_S = 64e9


def test_traced_async_take_d2h_spans_cover_the_transfers(device, tmp_path, monkeypatch):
    import json

    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.engine.intervals import measure, merge_intervals

    trace = tmp_path / "trace.json"
    monkeypatch.setenv("TSS_TORCH_TRACE", str(trace))
    monkeypatch.setenv("TSS_TORCH_ENABLE_BATCHING", "1")
    g = torch.Generator(device=device).manual_seed(0)
    state = {
        "w": torch.randn(4096, 2048, generator=g, device=device).to(torch.bfloat16),
        "up": torch.randn(2048, 4096, generator=g, device=device),
        "b": torch.randn(4096, generator=g, device=device),
        "ln": torch.ones(2048, device=device),
    }
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    pending = tts.Snapshot.async_take(str(tmp_path / "s"), {"m": tts.StateDict(**state)})
    for t in state.values():
        t.add_(1)  # races the drain
    pending.wait()
    with open(trace) as f:
        obj = json.load(f)
    spans = telemetry.spans_from_chrome_trace(obj)
    d2h = [s for s in spans if s.name == "stage.d2h"]
    assert d2h and sum(s.attrs["nbytes"] for s in d2h) == nbytes
    assert telemetry.metrics_from_chrome_trace(obj)["d2h.bytes"] == nbytes
    assert obj["otherData"]["dropped_spans"] == 0
    busy = measure(merge_intervals([(s.ts, s.ts + s.dur) for s in d2h]))
    assert nbytes / busy <= HOST_LINK_BYTES_PER_S, (nbytes, busy)
    # The phase spans are exactly LAST_TAKE_PHASES (a view of them).
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod

    phases = {}
    for s in spans:
        if s.cat == "take.phase":
            phases[s.name] = phases.get(s.name, 0.0) + s.dur
    assert phases.keys() == snapshot_mod.LAST_TAKE_PHASES.keys()
    for k, v in phases.items():
        assert abs(v - snapshot_mod.LAST_TAKE_PHASES[k]) < 1e-5, k


def test_pinned_allocations_are_spans_of_a_cuda_take(device, tmp_path):
    """Each D2H transfer's pinned allocation is a ``stage.pin_alloc`` span
    inside its ``stage.d2h``, with the tensor's bytes; it joins no drain
    stat."""
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod
    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.engine.intervals import measure, merge_intervals

    g = torch.Generator(device=device).manual_seed(0)
    state = {"w": torch.randn(1024, 512, generator=g, device=device), "b": torch.randn(512, generator=g, device=device)}
    tm = telemetry.Telemetry()
    tts.Snapshot.take(str(tmp_path / "s"), {"m": tts.StateDict(**state)}, _telemetry=tm)
    pins = tm.spans(name="stage.pin_alloc")
    assert sorted(s.attrs["nbytes"] for s in pins) == sorted(t.numel() * t.element_size() for t in state.values())
    d2hs = tm.spans(name="stage.d2h")
    assert all(any(d.ts <= p.ts and p.ts + p.dur <= d.ts + d.dur for d in d2hs) for p in pins)
    stats = snapshot_mod.LAST_SYNC_DRAIN_STATS
    assert "stage_pin_alloc_s" not in stats and stats["stage_d2h_s"] > 0
    assert measure(merge_intervals([(p.ts, p.ts + p.dur) for p in pins])) < stats["stage_d2h_s"]


def _robust_state(device):
    """Phase 10's state at a small size: many small bf16 layers (slabbed by
    K1) and a few larger ones."""
    g = torch.Generator(device=device).manual_seed(10)
    state = {f"l{i}": torch.randn(64, 48, generator=g, device=device).to(torch.bfloat16) for i in range(8)}
    state.update({f"big{i}": torch.randn(300, 200, generator=g, device=device) for i in range(8)})
    state["step"] = torch.tensor(11, device=device)
    return state


def _restore_exact(path, state):
    target = tts.StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    tts.Snapshot(path).restore({"m": target})
    for k, v in state.items():
        assert target[k].is_cuda and torch.equal(_bytes(target[k]), _bytes(v)), k


def test_transient_storm_commits_and_restores_bit_exact(device, tmp_path, monkeypatch):
    """Phase 10 (a) at a small size: every third write fails once (six
    times) and is retried; the take commits, K1 launches, the restore is
    bit-exact."""
    from torchsnapshot_tpu_torch import telemetry

    state = _robust_state(device)
    monkeypatch.setenv("TSS_TORCH_FAULTS", "seed=0;backoff=0.01;op=write,every=3,kind=transient,times=6")
    monkeypatch.setenv("TSS_TORCH_STREAM_WRITES", "off")
    tm = telemetry.Telemetry()
    # An 8 KiB slab threshold: one K1 slab per small layer and one object
    # per large tensor, enough writes for all six injections.
    monkeypatch.setenv("TSS_TORCH_SLAB_SIZE_THRESHOLD_BYTES", "8192")
    with knobs.override_batching_enabled(True):
        kernels.reset_launch_counts()
        tts.Snapshot.take(str(tmp_path / "a"), {"m": tts.StateDict(state)}, _telemetry=tm)
        assert kernels.LAUNCHES["pack_slab"] >= 1
    counters = tm.metrics.as_dict()
    assert counters["faults.transient"] == counters["cloud_retry.faults.retries"] == 6
    monkeypatch.delenv("TSS_TORCH_FAULTS")
    assert tts.Snapshot(str(tmp_path / "a")).verify() == {}
    _restore_exact(str(tmp_path / "a"), state)


def test_bit_rot_heals_once_and_persistent_rot_fails(device, tmp_path, monkeypatch):
    """Phase 10 (d) at a small size, under ``TSS_TORCH_VERIFY_READS=all``:
    one corrupt read heals by one re-fetch; an object that rots on every
    read fails the restore with ``CheckpointAbortedError(rank=0,
    phase="restore.read")`` from the ``ReadVerificationError`` naming it."""
    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.scheduler import ReadVerificationError

    state = _robust_state(device)
    path = str(tmp_path / "s0")
    tts.Snapshot.take(path, {"m": tts.StateDict(state)})
    monkeypatch.setenv("TSS_TORCH_VERIFY_READS", "all")
    monkeypatch.setenv("TSS_TORCH_FAULTS", "op=read,at=2,kind=corrupt,bytes=8")
    tm = telemetry.Telemetry()
    target = tts.StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    tts.Snapshot(path).restore({"m": target}, _telemetry=tm)
    for k, v in state.items():
        assert torch.equal(_bytes(target[k]), _bytes(v)), k
    counters = tm.metrics.as_dict()
    assert counters["faults.corrupt"] == counters["scheduler.read_verify_failures"] == 1
    monkeypatch.setenv("TSS_TORCH_FAULTS", "op=read,after=0,kind=corrupt,path=0/m/big3")
    with pytest.raises(tts.CheckpointAbortedError) as info:
        _restore_exact(path, state)
    assert (info.value.rank, info.value.phase) == (0, "restore.read")
    assert isinstance(info.value.__cause__, ReadVerificationError)
    assert "0/m/big3" in str(info.value.__cause__)


# ---------------------------------------------------------------------------
# Capture modes, eager D2H, the HBM cap, overlapped restore
# ---------------------------------------------------------------------------


def _capture_state(device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "w": torch.randn(512, 256, generator=g, device=device).to(torch.bfloat16),
        "m": torch.randn(512, 256, generator=g, device=device),
        "b": torch.randn(256, generator=g, device=device),
        "ids": torch.arange(100, device=device),
    }


def _restored(path, like):
    target = tts.StateDict({k: torch.zeros_like(v) for k, v in like.items()})
    tts.Snapshot(path).restore({"m": target})
    return target


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "drain"])
def test_donate_capture_forks_nothing_and_spends_no_device_memory(device, tmp_path, monkeypatch, eager):
    monkeypatch.setenv("TSS_TORCH_ASYNC_CAPTURE", "donate")
    monkeypatch.setenv("TSS_TORCH_ASYNC_EAGER_D2H", "1" if eager else "0")
    state = _capture_state(device)
    want = {k: v.clone() for k, v in state.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    kernels.reset_launch_counts()
    tts.Snapshot.async_take(str(tmp_path / "d"), {"m": tts.StateDict(state)}).wait()
    assert kernels.LAUNCHES["fork_copy"] == 0
    assert torch.cuda.max_memory_allocated(device) - base < 1 << 20
    got = _restored(str(tmp_path / "d"), want)
    for k, v in want.items():
        assert torch.equal(_bytes(got[k]), _bytes(v)), k


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "drain"])
def test_donate_broken_promise_fails_the_take(device, tmp_path, monkeypatch, eager):
    """The caller's stream sleeps before the capture point, so every D2H
    copy waits; an in-place update enqueued right after ``async_take``
    returns is certain to precede the copies' end, and the version check
    must catch it."""
    monkeypatch.setenv("TSS_TORCH_ASYNC_CAPTURE", "donate")
    monkeypatch.setenv("TSS_TORCH_ASYNC_EAGER_D2H", "1" if eager else "0")
    state = _capture_state(device)
    path = str(tmp_path / "bad")
    torch.cuda._sleep(2_000_000_000)
    pending = tts.Snapshot.async_take(path, {"m": tts.StateDict(state)})
    state["w"].add_(1)  # the promise broken
    with pytest.raises(tts.snapshot.CheckpointAbortedError) as ei:
        pending.wait()
    assert "changed in place" in repr(ei.value)
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "drain"])
def test_eager_d2h_restores_bit_exact_after_in_place_updates(device, tmp_path, monkeypatch, eager):
    from torchsnapshot_tpu_torch import d2h

    monkeypatch.setenv("TSS_TORCH_ASYNC_EAGER_D2H", "1" if eager else "0")
    counts = {"submit": 0, "to_host": 0}
    submit, to_host = d2h.TransferLanes.submit_to_host, d2h.TransferLanes.to_host

    def counted_submit(self, *a, **k):
        counts["submit"] += 1
        return submit(self, *a, **k)

    async def counted_to_host(self, *a, **k):
        counts["to_host"] += 1
        return await to_host(self, *a, **k)

    monkeypatch.setattr(d2h.TransferLanes, "submit_to_host", counted_submit)
    monkeypatch.setattr(d2h.TransferLanes, "to_host", counted_to_host)
    state = _capture_state(device)
    want = {k: v.clone() for k, v in state.items()}
    kernels.reset_launch_counts()
    pending = tts.Snapshot.async_take(str(tmp_path / "e"), {"m": tts.StateDict(state)})
    for v in state.values():
        v.add_(1)
    pending.wait()
    assert kernels.LAUNCHES["fork_copy"] == 1
    # Eager: each leaf's hinted copy is what its staging consumes.
    assert counts == ({"submit": 4, "to_host": 0} if eager else {"submit": 0, "to_host": 4})
    got = _restored(str(tmp_path / "e"), want)
    for k, v in want.items():
        assert torch.equal(_bytes(got[k]), _bytes(v)), k


def test_hbm_cap_at_half_forks_what_fits_and_captures_the_rest(device, tmp_path, monkeypatch):
    state = _capture_state(device)
    want = {k: v.clone() for k, v in state.items()}
    total = sum(v.numel() * v.element_size() for v in state.values())
    group = [state[k] for k in state]
    expect = []
    io_preparer._fork_or_capture(
        [t.cpu() for t in group], lambda g: g, lambda g: g, expect, limit=total // 2
    )
    monkeypatch.setenv("TSS_TORCH_ASYNC_FORK_HBM_LIMIT_BYTES", str(total // 2))
    before = dict(io_preparer.HOST_CAPTURED)
    kernels.reset_launch_counts()
    pending = tts.Snapshot.async_take(str(tmp_path / "h"), {"m": tts.StateDict(state)})
    for v in state.values():
        v.add_(1)
    pending.wait()
    assert io_preparer.HOST_CAPTURED["leaves"] - before["leaves"] == len(expect) > 0
    assert 0 < io_preparer.HOST_CAPTURED["bytes"] - before["bytes"] < total
    assert kernels.LAUNCHES["fork_copy"] >= 1
    got = _restored(str(tmp_path / "h"), want)
    for k, v in want.items():
        assert torch.equal(_bytes(got[k]), _bytes(v)), k


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "phase_split"])
def test_overlapped_restore_into_live_tensors(device, tmp_path, monkeypatch, overlap):
    monkeypatch.setenv("TSS_TORCH_RESTORE_OVERLAP", "1" if overlap else "0")
    monkeypatch.setenv("TSS_TORCH_PER_RANK_MEMORY_BUDGET_BYTES", str(300_000))
    state = _capture_state(device)
    path = str(tmp_path / "o")
    with knobs.override_max_chunk_size_bytes(100_000):
        tts.Snapshot.take(path, {"m": tts.StateDict(state)})
    target = tts.StateDict({k: torch.zeros_like(v) for k, v in state.items()})
    ptrs = {k: v.data_ptr() for k, v in target.items()}
    tts.Snapshot(path).restore({"m": target})
    for k, v in state.items():
        assert target[k].data_ptr() == ptrs[k]
        assert torch.equal(_bytes(target[k]), _bytes(v)), k


def _overlap_reshard(rank, world_size, root):
    os.environ["TSS_TORCH_RESTORE_OVERLAP"] = "1"
    _two_rank_reshard(rank, world_size, root)


def test_overlapped_reshard_into_dtensors(device, tmp_path):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_overlap_reshard, 2, args=(str(tmp_path),), process_group=True)


# ---------------------------------------------------------------------------
# K1 out of device memory (phase 12 at a small size)
# ---------------------------------------------------------------------------


def _capped_pack_worker(rank, world_size, root):
    """The body of the test below, in a fresh process: no segment cached by
    an earlier test can hold the slab, and the cap dies with the process."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import batcher, kernels
    from torchsnapshot_tpu_torch.utils import knobs

    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(12)
    # Members of 12 MiB each get segments of their own, so the slab (48 MiB)
    # and its halves (24 MiB) need new ones.
    state = {f"w{i}": torch.randn(3 << 20, generator=g, device=device) for i in range(4)}
    member = 12 << 20
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    live = torch.cuda.memory_reserved(device)
    total = torch.cuda.get_device_properties(device).total_memory
    warned = []
    batcher.logger.warning = lambda *a, **k: warned.append(a)

    def cap(headroom):
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction((live + headroom) / total, device)

    # Not even one member fits: the take aborts, naming the allocation.
    cap(4 << 20)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        torch.empty(member, dtype=torch.uint8, device=device)
    with knobs.override_batching_enabled(True):
        with pytest.raises(tts.CheckpointAbortedError) as info:
            tts.Snapshot.take(os.path.join(root, "short"), {"m": tts.StateDict(state)})
    assert (info.value.rank, info.value.phase) == (0, "write")
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
    assert not os.path.exists(os.path.join(root, "short", ".snapshot_metadata"))
    assert kernels.LAUNCHES["pack_slab"] == 0 and warned == []

    # A member fits, a half of the slab does not: each take packs the slab
    # in 4 K1 launches.
    cap(16 << 20)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        torch.empty(2 * member, dtype=torch.uint8, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    with knobs.override_batching_enabled(True):
        tts.Snapshot.take(os.path.join(root, "sync"), {"m": tts.StateDict(state)})
        assert kernels.LAUNCHES["pack_slab"] == 4 and len(warned) == 1
        os.environ["TSS_TORCH_ASYNC_CAPTURE"] = "donate"
        tts.Snapshot.async_take(os.path.join(root, "donate"), {"m": tts.StateDict(state)}).wait()
        del os.environ["TSS_TORCH_ASYNC_CAPTURE"]
    assert kernels.LAUNCHES["pack_slab"] == 8 and len(warned) == 2
    assert torch.cuda.max_memory_reserved(device) <= live + (16 << 20)
    torch.cuda.set_per_process_memory_fraction(1.0, device)
    for name in ("sync", "donate"):
        _restore_exact(os.path.join(root, name), state)
        assert tts.Snapshot(os.path.join(root, name)).verify() == {}
    with knobs.override_batching_enabled(True):
        tts.Snapshot.take(os.path.join(root, "uncapped"), {"m": tts.StateDict(state)})
    assert kernels.LAUNCHES["pack_slab"] == 9 and len(warned) == 2
    for k in state:
        want = _bytes(tts.Snapshot(os.path.join(root, "uncapped")).read_object(f"0/m/{k}", device="cpu"))
        for name in ("sync", "donate"):
            got = _bytes(tts.Snapshot(os.path.join(root, name)).read_object(f"0/m/{k}", device="cpu"))
            assert torch.equal(got, want), (name, k)


def test_pack_out_of_memory_packs_in_groups(device, tmp_path):
    """Under a cap on the caching allocator, K1's slab allocation raises
    ``torch.cuda.OutOfMemoryError``: with room for no member the take
    aborts; with room for one member and not two, a sync take and a
    ``donate`` ``async_take`` each commit with the slab packed in 4 K1
    launches and one warning, restore bit-exactly and verify, and an
    uncapped take's slab (one launch) holds the same member bytes."""
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(_capped_pack_worker, 1, args=(str(tmp_path),), timeout_s=180)

"""Drive torchsnapshot_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a host with one CUDA GPU::

    python3 chip_smoke.py [--gb 4.0] [--seed 0]

Phase 0 builds the CUDA kernels from ``torchsnapshot_tpu_torch/csrc``.
Phase 1 holds each kernel (K1 pack_slab, K2 fork_copy, K3 copy_blocks)
byte-exactly against its plain PyTorch version on the card, over every
packable dtype, empty, one-element, odd-sized and misaligned members, a
transposed view and a ~100 MB member (K3: 0-d, empty, odd widths at odd
addresses, 3-D blocks, strided last dims); then times kernel, plain version
and one library call at the main path's shapes, beside the copy's bound
(2 x bytes / 3.35 TB/s).
Phase 2 drives the main path on a transformer-shaped bf16 state
(d_model 4096, d_ff 16384, ~``--gb`` GB): a sync take with batching on,
verify, restore into zeroed CUDA tensors, read_object, then async_take
followed at once by an in-place ``add_(1)`` of every tensor, wait, and a
restore that must give the values from before the mutation.
Phase 3 drives the multi-rank path: two ranks, two processes on the one
card (gloo process group, ``DeviceMesh("cuda", (2,))``), holding the same
model state sharded tensor-parallel style as DTensors (``attn`` and ``up``
``Shard(1)``, ``down`` ``Shard(0)``, column biases ``Shard(0)``, LayerNorm
weights and the other biases ``Replicate()``), a per-rank step tensor,
primitives and a pickled object: a sync take, a restore in place with the
same placements, a restore with swapped placements (``Shard(1)`` <->
``Shard(0)``: every target shard overlaps both saved shards through strided
rectangles, scattered by K3), ``read_object`` of one sharded entry, and an
async take followed at once by ``add_(1)`` on every local shard, then a
restore that must give the values from before the mutation; all
bit-exact. The numbers are of two ranks sharing one card, its PCIe link
and one disk, not of two cards.
Phase 4 drives a trainer: the port's transformer at the width of the
repo's FSDP and optimizer benchmarks (vocab 32000, d_model 4096, 32 heads,
d_ff 16384, 512 positions, 8 layers: 1,875,320,064 parameters, bf16
weights, fp32 LayerNorm parameters) with AdamW (optax's defaults, torch's
``foreach`` update) and deterministic algorithms, on batches of 4 x 512
tokens from a seeded generator on the card. It takes steps 1-3, calls
``async_take`` of ``{"model", "optim", "progress", "rng"}`` and at once
takes steps 4-6, whose in-place updates race the drain; then waits,
verifies, restores into a fresh model and optimizer (state materialised
first) and checks every tensor against a device copy of the step-3 state,
retrains steps 4-6 and checks every loss, parameter and moment against the
uninterrupted run, and restores a sync take of the step-6 state into
zeroed tensors in place; all bit-exact (``dryrun.train_checkpoint_resume``).
Phase 5 drives the write-path features (compressed, incremental and
plan-cached takes) on a partial fine-tune of phase 4's transformer at the
same width, its token and position embeddings and first 4 blocks frozen
(``requires_grad=False``, out of the optimizer): steps 1-2, ``async_take``
to c0 (a prepared-take miss), step 3 racing its drain; ``async_take`` to c1
(a hit, other values), step 4 racing; a sync take to c2 with ``base=c1``
(the frozen tensors hard-linked); step 5, a sync take to c3 with zlib and
member-framed compressed slabs; steps 6-7; then c1, c2 and c3 restored
into a fresh model and materialised optimizer, each bit-exact, and steps
6-7 resumed from c3 bit-identically. c0-c2 are taken without slab
batching; then, with batching, on the uninterrupted run: step 8,
``async_take`` to c4 (a miss) racing step 9, ``async_take`` to c5 (a hit
whose K1 slabs are packed over its new forks) racing step 10, and a sync
take to c6 with ``base=c5``; each restored bit-exactly
(``dryrun.frozen_finetune_checkpoints``).
It prints the stalls with their phases and cache hits, the deduped bytes
of c2 and c6 against the frozen bytes and their hard links, c3's raw and
on-disk bytes and rates, each take's streaming decision and scorecard
(``TSS_TORCH_STREAM_WRITES=auto``), device memory around each take, and the
launches. The phase runs again with zstd in place of zlib when
``zstandard`` imports. Phase 4 prints its takes' streaming decisions too.
Phase 0 also builds the native O_DIRECT I/O engine (``g++``, beside the
kernels' ``nvcc``) and fails if it does not load.
Phase 6 drives a serving fleet: two ranks on the one card (gloo) each hold
phase 4's transformer weights (3.75 GB, no optimizer), taken once with
``replicated=["**"]`` and batching on (K1), then restored bit-exactly into
a fresh model directly, by broadcast, by swarm (the broadcast cap lowered
to 1 byte, since no object of this model exceeds 256 MiB), twice through a
read cache (the second reads 0 origin bytes), with ``VERIFY_READS=all``,
and lazily for one block (the bytes read equal the block's); phase 3's TP
state, taken without slabs, is restored with swapped placements through
the need-aware swarm (K3, at most 1.1x one copy from the origin). The
parent then scrubs the served snapshot, scrubs and repairs a copy with one
flipped byte (the object is quarantined and a restore of the copy raises),
and runs phase 2's sync take and restore with the native engine on, off
and on, printing its direct/buffered counts and the temp root's file
system. It prints origin, peer and cache bytes per rank and the rates.
The launch counts are set to 0 just before each drive and read just after.

Any failure raises, and the script exits non-zero without a result line.
It exits non-zero too on a host without CUDA. The last line of its output
is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference between two byte tensors (0 when identical)."""
    if a.numel() != b.numel():
        raise AssertionError(f"sizes differ: {a.numel()} vs {b.numel()}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` per call, by CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(nbytes: int) -> float:
    """Least time for a copy of ``nbytes``: read once, written once."""
    return 2 * nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase1_inputs(device, gen):
    from torchsnapshot_tpu_torch import kernels

    members = []
    for dtype in sorted(kernels.PACKABLE_DTYPES, key=str):
        for shape in [(), (0,), (1,), (7,), (3, 5), (1023,)]:
            if dtype == torch.bool:
                t = torch.randint(0, 2, shape, generator=gen, device=device).bool()
            elif dtype.is_floating_point:
                t = torch.randn(shape, generator=gen, device=device).to(dtype)
            else:
                t = torch.randint(0, 100, shape, generator=gen, device=device).to(dtype)
            members.append(t)
    base = torch.randint(0, 255, (4099,), generator=gen, device=device).to(torch.uint8)
    members.append(base[1:4001])  # a source at an odd address
    members.append(torch.randn(33, 17, generator=gen, device=device).t())  # transposed
    big = torch.randn(50_000_000, generator=gen, device=device).to(torch.bfloat16)  # ~100 MB
    return members, [base[3:10], big, members[5]]


def phase1(device, gen):
    from torchsnapshot_tpu_torch import kernels

    members, big_group = phase1_inputs(device, gen)
    errs = {"pack_slab": 0, "fork_copy": 0}
    for group in (members, big_group):
        got = kernels.pack_slab(group)
        want = kernels.pack_slab_plain(group)
        torch.cuda.synchronize()
        errs["pack_slab"] = max(errs["pack_slab"], _max_abs_err(got, want))
        forks = kernels.fork_copy(group)
        torch.cuda.synchronize()
        for t, c in zip(group, forks):
            if c.stride() != t.stride() and t.numel() > 1:
                raise AssertionError("fork_copy changed a tensor's layout")
            errs["fork_copy"] = max(errs["fork_copy"], _max_abs_err(_bytes(c), _bytes(t)))
    pairs = k3_pairs(device, gen)
    want = [dst.clone() for _, dst in pairs]
    kernels.copy_blocks_plain([(src, w) for (src, _), w in zip(pairs, want)])
    kernels.copy_blocks(pairs)
    torch.cuda.synchronize()
    errs["copy_blocks"] = max(_max_abs_err(_bytes(dst), _bytes(w)) for (_, dst), w in zip(pairs, want))
    if any(errs.values()):
        raise AssertionError(f"kernels disagree with their plain versions: {errs}")
    log(f"phase1 kernels byte-exact on {len(members) + len(big_group)} members and {len(pairs)} K3 views: {errs}")
    return errs


def k3_pairs(device, gen):
    """K3 (source view, destination view) pairs of every packable dtype:
    0-d, empty, odd widths at odd addresses, 3-D blocks, a transposed
    source, strided last dims, and one main-path reshard rectangle."""
    from torchsnapshot_tpu_torch import kernels

    pairs = []
    for dtype in sorted(kernels.PACKABLE_DTYPES, key=str):
        def rand(*shape):
            if dtype == torch.bool:
                return torch.randint(0, 2, shape, generator=gen, device=device).bool()
            if dtype.is_floating_point:
                return torch.randn(shape, generator=gen, device=device).to(dtype)
            return torch.randint(0, 100, shape, generator=gen, device=device).to(dtype)

        def zeros(*shape):
            return torch.zeros(shape, device=device).to(dtype)

        a = rand(9, 12, 5)
        pairs += [
            (rand(), zeros()),
            (a[0:0, :9], zeros(12, 9, 5)[0:0]),
            (rand(37)[1:34], zeros(40)[5:38]),
            (a[2:7, 3:11, 1:4], zeros(12, 9, 5)[4:9, 0:8, 2:5]),
            (a[1:3].transpose(0, 1), zeros(12, 9, 5)[0:12, 4:6, :]),
            (a[1:3, :, 2], zeros(12, 9, 5)[:, 2:4, 1].t()),
        ]
    src = torch.randn(2048, 8192, generator=gen, device=device).to(torch.bfloat16)
    pairs.append((src, torch.zeros(2048, 16384, device=device, dtype=torch.bfloat16)[:, 8192:]))
    return pairs


def time_kernels(device, slab_members, state_tensors):
    """K1 at one main-path slab, K2 at the whole main-path state."""
    from torchsnapshot_tpu_torch import kernels

    stream = torch.cuda.current_stream(device)
    out = {}

    # K1
    nbytes = sum(t.numel() * t.element_size() for t in slab_members)
    slab = torch.empty(nbytes, dtype=torch.uint8, device=device)
    offs, off = [], 0
    for t in slab_members:
        offs.append(slab.data_ptr() + off)
        off += t.numel() * t.element_size()
    table, n, total = kernels.descriptor_table(slab_members, offs, device)
    out["pack_slab"] = {
        "bytes": nbytes,
        "members": len(slab_members),
        "ms": _time_ms(lambda: kernels.launch_raw("pack_slab", table, n, total, stream), 50),
        "wrapper_ms": _time_ms(lambda: kernels.pack_slab(slab_members), 20),
        "plain_ms": _time_ms(lambda: kernels.pack_slab_plain(slab_members), 20),
        "library_ms": _time_ms(lambda: torch.cat([t.reshape(-1).view(torch.uint8) for t in slab_members]), 20),
        "bound_ms": _bound_ms(nbytes),
    }

    # K2
    nbytes = sum(t.numel() * t.element_size() for t in state_tensors)
    dsts = [torch.empty_like(t) for t in state_tensors]
    table, n, total = kernels.descriptor_table(state_tensors, [d.data_ptr() for d in dsts], device)
    out["fork_copy"] = {
        "bytes": nbytes,
        "members": len(state_tensors),
        "ms": _time_ms(lambda: kernels.launch_raw("fork_copy", table, n, total, stream), 10),
        "wrapper_ms": _time_ms(lambda: kernels.fork_copy(state_tensors), 5),
        "plain_ms": _time_ms(lambda: kernels.fork_copy_plain(state_tensors), 5),
        "library_ms": _time_ms(lambda: torch._foreach_copy_(dsts, state_tensors), 5),
        "bound_ms": _bound_ms(nbytes),
    }
    del dsts, slab
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 2: the main path
# ---------------------------------------------------------------------------


def build_state(gb: float, device, gen):
    """Transformer-shaped params (bench.py's d_model 4096 / d_ff 16384
    layers, bf16, plus LayerNorm weights in fp32 and bf16 biases), an int64
    step tensor, primitives and a pickled object."""
    d_model, d_ff = 4096, 16384
    layer_bytes = (3 * d_model * d_model + 2 * d_model * d_ff) * 2
    n_layers = max(1, round(gb * 1e9 / layer_bytes))
    bf16 = torch.bfloat16
    params = {}
    for i in range(n_layers):
        params[f"layer_{i}"] = {
            "attn": torch.randn(d_model, 3 * d_model, generator=gen, device=device, dtype=bf16),
            "up": torch.randn(d_model, d_ff, generator=gen, device=device, dtype=bf16),
            "down": torch.randn(d_ff, d_model, generator=gen, device=device, dtype=bf16),
            "ln1_w": torch.randn(d_model, generator=gen, device=device),
            "ln1_b": torch.randn(d_model, generator=gen, device=device),
            "ln2_w": torch.randn(d_model, generator=gen, device=device),
            "ln2_b": torch.randn(d_model, generator=gen, device=device),
            "b_attn": torch.randn(3 * d_model, generator=gen, device=device, dtype=bf16),
            "b_up": torch.randn(d_ff, generator=gen, device=device, dtype=bf16),
            "b_down": torch.randn(d_model, generator=gen, device=device, dtype=bf16),
        }
    progress = {
        "step": torch.tensor(1000, dtype=torch.int64, device=device),
        "epoch": 3,
        "lr": 3e-4,
        "run": "chip-smoke",
        "meta": ("transformer", d_model, d_ff, n_layers),
    }
    return params, progress, n_layers


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _assert_bits_equal(got, want, what):
    gt, wt = list(_tensors(got)), list(_tensors(want))
    if len(gt) != len(wt):
        raise AssertionError(f"{what}: {len(gt)} tensors, expected {len(wt)}")
    for a, b in zip(gt, wt):
        if a.device.type != "cuda" or a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what}: {a.device} {a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
        if not torch.equal(_bytes(a), _bytes(b)):
            raise AssertionError(f"{what}: bytes differ")


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return None if not isinstance(tree, (int, float, str, tuple)) else tree


def phase2(gb, device, gen, root, card):
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import io_preparer, kernels
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod

    params, progress, n_layers = build_state(gb, device, gen)
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    nbytes += sum(t.numel() * t.element_size() for t in _tensors(progress))
    torch.cuda.synchronize()
    log(f"phase2 state: {n_layers} layers, {nbytes / 1e9:.3f} GB on {card}")
    app = {"model": tts.StateDict(params), "progress": tts.StateDict(progress)}
    launches = {}
    rates = {}

    # 1. sync take, batching on
    path = os.path.join(root, "sync")
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    snap = tts.Snapshot.take(path, app)
    take_s = time.monotonic() - t0
    launches["sync_take"] = dict(kernels.LAUNCHES)
    if launches["sync_take"]["pack_slab"] < n_layers:
        raise AssertionError(f"K1 launched {launches['sync_take']} for {n_layers} layers")
    slabs = {
        e.location for e in snap.get_manifest().values()
        if getattr(e, "location", "").startswith("batched/")
    }
    log(f"sync take: {take_s:.3f} s, {nbytes / take_s / 1e9:.3f} GB/s, slabs {len(slabs)}, launches {launches['sync_take']}, phases {snapshot_mod.LAST_TAKE_PHASES}")
    rates["sync_take_gbps"] = nbytes / take_s / 1e9

    # 2. verify
    problems = tts.Snapshot(path).verify()
    if problems:
        raise AssertionError(f"verify: {problems}")

    # 3. restore into zeroed CUDA tensors
    target = {"model": tts.StateDict(_zeros_like_tree(params)), "progress": tts.StateDict(_zeros_like_tree(progress))}
    target["progress"].update(epoch=None, lr=None, run=None, meta=None)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    tts.Snapshot(path).restore(target)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _assert_bits_equal(dict(target["model"]), params, "restore")
    _assert_bits_equal(dict(target["progress"]), progress, "restore progress")
    if target["progress"]["meta"] != progress["meta"] or target["progress"]["lr"] != progress["lr"]:
        raise AssertionError("restore: primitives or object differ")
    rates["restore_gbps"] = nbytes / restore_s / 1e9
    log(f"restore: {restore_s:.3f} s, {rates['restore_gbps']:.3f} GB/s")
    del target

    # 4. read_object of one leaf
    leaf = tts.Snapshot(path).read_object("0/model/layer_0/ln1_w")
    if leaf.device.type != "cuda" or not torch.equal(leaf, params["layer_0"]["ln1_w"]):
        raise AssertionError("read_object")
    shutil.rmtree(path)

    # 5-7. async_take, mutate in place at once, wait, restore
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in params.items()}
    step_before = progress["step"].clone()
    path = os.path.join(root, "async")
    captured0 = io_preparer.HOST_CAPTURED["leaves"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    pending = tts.Snapshot.async_take(path, app)
    stall_s = time.monotonic() - t0
    for t in _tensors(params):
        t.add_(1)
    progress["step"].add_(1)
    pending.wait()
    drain_s = time.monotonic() - t0 - stall_s
    launches["async_take"] = dict(kernels.LAUNCHES)
    if launches["async_take"]["fork_copy"] < 1:
        raise AssertionError(f"K2 not launched: {launches['async_take']}")
    if io_preparer.HOST_CAPTURED["leaves"] != captured0:
        raise AssertionError("a leaf was captured through host RAM")
    rates["async_stall_s"] = stall_s
    rates["async_drain_s"] = drain_s
    log(f"async take: stall {stall_s:.4f} s, drain {drain_s:.3f} s, launches {launches['async_take']}, phases {snapshot_mod.LAST_TAKE_PHASES}, drain stats {pending.drain_stats}")
    target = {"model": tts.StateDict(_zeros_like_tree(params)), "progress": tts.StateDict(step=torch.zeros_like(step_before))}
    tts.Snapshot(path).restore(target)
    torch.cuda.synchronize()
    _assert_bits_equal(dict(target["model"]), before, "async restore")
    if not torch.equal(target["progress"]["step"], step_before):
        raise AssertionError("async restore: step")
    shutil.rmtree(path)
    del target, before

    # Steady state: a second take of each kind in this process (warm
    # pinned-buffer and device-memory caches), as a training job's later
    # checkpoints see it. Checked by verify() only.
    for kind in ("sync", "async"):
        path = os.path.join(root, f"warm_{kind}")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if kind == "sync":
            tts.Snapshot.take(path, app)
            rates["warm_sync_take_gbps"] = nbytes / (time.monotonic() - t0) / 1e9
        else:
            pending = tts.Snapshot.async_take(path, app)
            rates["warm_async_stall_s"] = time.monotonic() - t0
            pending.wait()
            rates["warm_async_drain_s"] = time.monotonic() - t0 - rates["warm_async_stall_s"]
        log(f"warm {kind} take phases {snapshot_mod.LAST_TAKE_PHASES}")
        if tts.Snapshot(path).verify():
            raise AssertionError(f"warm {kind} take: verify")
        shutil.rmtree(path)
    return launches, rates, {k: v for k, v in params["layer_0"].items() if k not in ("up", "down")}, list(_tensors(params))


def reshard_rectangles(device, gb, gen):
    """K3's work in one rank's swapped-placement restore of the phase-3
    state: for each tensor, the overlap of each saved shard with rank 0's
    target shard, as (staging view, target view) pairs on the card."""
    from torchsnapshot_tpu_torch.io_preparers.sharded_array import overlap, placement_offsets_sizes

    pairs = []
    keep = []
    for name, shape, save, restore in tp_layout(gb):
        if save == restore:
            continue
        t_off, t_sz = placement_offsets_sizes(shape, (2,), [restore], (0,))
        target = torch.empty(t_sz, dtype=torch.bfloat16, device=device)
        keep.append(target)
        for coord in range(2):
            s_off, s_sz = placement_offsets_sizes(shape, (2,), [save], (coord,))
            ov = overlap(s_off, s_sz, t_off, t_sz)
            if ov is None:
                continue
            rows = ov[0][0]
            piece_sz = [rows.stop - rows.start] + list(s_sz[1:])
            staging = torch.randn(piece_sz, generator=gen, device=device).to(torch.bfloat16)
            keep.append(staging)
            src_sl = (slice(0, piece_sz[0]),) + ov[0][1:]
            pairs.append((staging[src_sl], target[ov[1]]))
    return pairs, keep


def time_k3(device, gb, gen):
    """K3 at one main-path rectangle (2048x8192 bf16 into rows of 32 KiB
    pitch) and over all rectangles of one rank's reshard restore."""
    from torchsnapshot_tpu_torch import kernels

    stream = torch.cuda.current_stream(device)
    out = {}
    src = torch.randn(2048, 8192, generator=gen, device=device).to(torch.bfloat16)
    dst = torch.zeros(2048, 16384, device=device, dtype=torch.bfloat16)[:, 8192:]
    whole, keep = reshard_rectangles(device, gb, gen)
    for label, pairs in (("rectangle", [(src, dst)]), ("reshard_restore", whole)):
        table, total = kernels.rect_table(pairs)
        dev_table = kernels.upload_rect_table(table, device)
        nbytes = sum(s.numel() * s.element_size() for s, _ in pairs)
        reps = 50 if label == "rectangle" else 5
        out[label] = {
            "bytes": nbytes,
            "rectangles": len(table),
            "ms": _time_ms(lambda: kernels.launch_raw("copy_blocks", dev_table, len(table), total, stream), reps),
            "wrapper_ms": _time_ms(lambda: kernels.copy_blocks(pairs), reps),
            "plain_ms": _time_ms(lambda: kernels.copy_blocks_plain(pairs), reps),
            "library_ms": _time_ms(lambda: [d.copy_(s) for s, d in pairs], reps),
            "bound_ms": _bound_ms(nbytes),
        }
    del src, dst, whole, keep
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3: two ranks on the card, DTensor state sharded tensor-parallel style
# ---------------------------------------------------------------------------


def tp_layout(gb):
    """(name, global shape, saved placement, swapped placement) of every
    bf16 tensor of the TP-sharded state; LayerNorm weights are handled
    apart (fp32, Replicate)."""
    from torch.distributed.tensor import Replicate, Shard

    d_model, d_ff = 4096, 16384
    out = []
    for i in range(n_layers_for(gb)):
        out += [
            (f"layer_{i}/attn", (d_model, 3 * d_model), Shard(1), Shard(0)),
            (f"layer_{i}/up", (d_model, d_ff), Shard(1), Shard(0)),
            (f"layer_{i}/down", (d_ff, d_model), Shard(0), Shard(1)),
            (f"layer_{i}/b_attn", (3 * d_model,), Shard(0), Shard(0)),
            (f"layer_{i}/b_up", (d_ff,), Shard(0), Shard(0)),
            (f"layer_{i}/b_down", (d_model,), Replicate(), Replicate()),
        ]
    return out


def n_layers_for(gb):
    d_model, d_ff = 4096, 16384
    return max(1, round(gb * 1e9 / ((3 * d_model * d_model + 2 * d_model * d_ff) * 2)))


def _global(name, shape, dtype, seed, device):
    """The global value of one tensor: random, from the seed and its name."""
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + sum(map(ord, name)) * 7919 + len(name))
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)


def _local(full, placement):
    from torchsnapshot_tpu_torch.io_preparers.sharded_array import placement_offsets_sizes

    import torch.distributed as dist

    off, sz = placement_offsets_sizes(full.shape, (2,), [placement], (dist.get_rank(),))
    return full[tuple(slice(o, o + n) for o, n in zip(off, sz))]


def tp_state(gb, seed, device, mesh, kind, zeros=False):
    """This rank's DTensor state (``kind``: "save" or "swap" placements)."""
    from torch.distributed.tensor import DTensor, Replicate

    from torchsnapshot_tpu_torch.io_preparers.sharded_array import contiguous_stride

    params = {}
    entries = [(n, s, p if kind == "save" else q, torch.bfloat16) for n, s, p, q in tp_layout(gb)]
    for i in range(n_layers_for(gb)):
        for ln in ("ln1_w", "ln1_b", "ln2_w", "ln2_b"):
            entries.append((f"layer_{i}/{ln}", (4096,), Replicate(), torch.float32))
    for name, shape, placement, dtype in entries:
        full = _global(name, shape, dtype, seed, device)
        local = torch.zeros_like(_local(full, placement)) if zeros else _local(full, placement).clone()
        del full
        layer, leaf = name.split("/")
        params.setdefault(layer, {})[leaf] = DTensor.from_local(
            local, mesh, [placement], run_check=False, shape=torch.Size(shape), stride=contiguous_stride(shape)
        )
    return params


def check_tp_state(params, gb, seed, device, kind, what, delta=0):
    """Every local shard equals the seeded global value's slice (+ delta)."""
    layouts = {n: (p if kind == "save" else q) for n, _, p, q in tp_layout(gb)}
    for layer, leaves in params.items():
        for leaf, dt in leaves.items():
            name = f"{layer}/{leaf}"
            local = dt.to_local()
            full = _global(name, tuple(dt.shape), local.dtype, seed, device)
            want = _local(full, layouts.get(name, dt.placements[0]))
            if delta:
                want = want + delta
            if local.device.type != "cuda" or not torch.equal(_bytes(local), _bytes(want)):
                raise AssertionError(f"{what}: {name} differs")


def _tensor_bytes(params):
    return sum(dt.to_local().numel() * dt.to_local().element_size() for v in params.values() for dt in v.values())


def phase3_worker(rank, world_size, gb, seed, root, out_dir):
    """One rank of phase 3; writes its numbers to ``out_dir/rank<r>.json``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import io_preparer, kernels
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod

    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = DeviceMesh("cuda", list(range(world_size)))
    result = {"rank": rank, "mesh_warnings": [str(w.message)[:300] for w in caught], "launches": {}, "rates": {}}

    def barrier():
        dist.barrier()

    def drive(label, fn):
        barrier()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        result["launches"][label] = dict(kernels.LAUNCHES)
        return out, wall

    params = tp_state(gb, seed, device, mesh, "save")
    progress = {"step": torch.tensor(1000 + rank, dtype=torch.int64, device=device), "epoch": 3,
                "lr": 3e-4, "meta": ("transformer-tp", 4096, 16384, world_size)}
    app = {"model": tts.StateDict(params), "progress": tts.StateDict(progress)}
    nbytes = _tensor_bytes(params)
    result["local_bytes"] = nbytes
    torch.cuda.synchronize()

    path = os.path.join(root, "tp_sync")
    _, take_s = drive("sync_take", lambda: tts.Snapshot.take(path, app))
    result["rates"]["take_gbps"] = nbytes / take_s / 1e9
    result["rates"]["take_s"] = take_s
    result["take_phases"] = dict(snapshot_mod.LAST_TAKE_PHASES)
    if rank == 0 and tts.Snapshot(path).verify():
        raise AssertionError("phase3 verify")

    target = {"model": tts.StateDict(tp_state(gb, seed, device, mesh, "save", zeros=True)),
              "progress": tts.StateDict(step=torch.zeros((), dtype=torch.int64, device=device))}
    ptrs = {(l, k): dt.to_local().data_ptr() for l, v in target["model"].items() for k, dt in v.items()}
    _, restore_s = drive("restore", lambda: tts.Snapshot(path).restore(target))
    check_tp_state(dict(target["model"]), gb, seed, device, "save", "same-placement restore")
    if any(dt.to_local().data_ptr() != ptrs[(l, k)] for l, v in target["model"].items() for k, dt in v.items()):
        raise AssertionError("restore did not fill the local shards in place")
    if int(target["progress"]["step"]) != 1000 + rank:
        raise AssertionError("per-rank step")
    result["rates"]["restore_gbps"] = nbytes / restore_s / 1e9
    del target

    target = {"model": tts.StateDict(tp_state(gb, seed, device, mesh, "swap", zeros=True))}
    _, reshard_s = drive("reshard_restore", lambda: tts.Snapshot(path).restore(target))
    check_tp_state(dict(target["model"]), gb, seed, device, "swap", "swapped-placement restore")
    if result["launches"]["reshard_restore"]["copy_blocks"] < 1:
        raise AssertionError("K3 was not launched in the reshard restore")
    result["rates"]["reshard_restore_gbps"] = _tensor_bytes(dict(target["model"])) / reshard_s / 1e9
    del target

    up, _ = drive("read_object", lambda: tts.Snapshot(path).read_object("0/model/layer_0/up"))
    if not torch.equal(_bytes(up), _bytes(_global("layer_0/up", (4096, 16384), torch.bfloat16, seed, device))):
        raise AssertionError("read_object of a sharded entry")
    del up
    barrier()
    if rank == 0:
        shutil.rmtree(path)

    path = os.path.join(root, "tp_async")
    captured0 = io_preparer.HOST_CAPTURED["leaves"]
    barrier()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    pending = tts.Snapshot.async_take(path, app)
    stall_s = time.monotonic() - t0
    for leaves in params.values():
        for dt in leaves.values():
            dt.to_local().add_(1)
    progress["step"].add_(1)
    pending.wait()
    drain_s = time.monotonic() - t0 - stall_s
    result["launches"]["async_take"] = dict(kernels.LAUNCHES)
    if result["launches"]["async_take"]["fork_copy"] < 1:
        raise AssertionError("K2 not launched in the async take")
    if io_preparer.HOST_CAPTURED["leaves"] != captured0:
        raise AssertionError("a leaf was captured through host RAM")
    result["rates"]["async_stall_s"] = stall_s
    result["rates"]["async_drain_s"] = drain_s
    result["drain_stats"] = pending.drain_stats
    check_tp_state(params, gb, seed, device, "save", "mutated state", delta=1)
    target = {"model": tts.StateDict(tp_state(gb, seed, device, mesh, "save", zeros=True)),
              "progress": tts.StateDict(step=torch.zeros((), dtype=torch.int64, device=device))}
    drive("async_restore", lambda: tts.Snapshot(path).restore(target))
    check_tp_state(dict(target["model"]), gb, seed, device, "save", "async restore")
    if int(target["progress"]["step"]) != 1000 + rank:
        raise AssertionError("async restore: step")
    barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def phase3(gb, seed, root, card):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    with open("/proc/meminfo") as f:
        avail = next(line for line in f if line.startswith("MemAvailable")).split()[1]
    log(f"phase3 host MemAvailable before: {int(avail) / 1024**2:.1f} GiB")
    out_dir = os.path.join(root, "phase3_out")
    os.makedirs(out_dir)
    t0 = time.monotonic()
    run_with_processes(phase3_worker, 2, args=(gb, seed, root, out_dir), timeout_s=600, process_group=True)
    log(f"phase3 two ranks done in {time.monotonic() - t0:.1f} s")
    results = []
    for rank in range(2):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            r = json.load(f)
        results.append(r)
        log(f"phase3 rank {rank} on {card} (two ranks sharing one card): {json.dumps(r)}")
    return results


# ---------------------------------------------------------------------------
# Phase 4: a trainer that checkpoints while it trains, and resumes
# ---------------------------------------------------------------------------


def phase4(seed, device, root, card):
    from torchsnapshot_tpu_torch import dryrun, kernels
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(
        vocab_size=32000, d_model=4096, n_heads=32, n_layers=8, d_ff=16384, max_seq_len=512
    )
    with open("/proc/meminfo") as f:
        avail = next(line for line in f if line.startswith("MemAvailable")).split()[1]
    log(f"phase4 before: host MemAvailable {int(avail) / 1024**2:.1f} GiB, disk free {shutil.disk_usage(root).free} bytes")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = dryrun.train_checkpoint_resume(cfg, root, device=device, batch=4, seed=seed)
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    if launches["pack_slab"] < 1 or launches["fork_copy"] < 1:
        raise AssertionError(f"phase4: K1 and K2 must both launch: {launches}")
    nbytes = out["state_bytes"]
    rates = {
        "params": out["n_params"],
        "layers": cfg.n_layers,
        "state_bytes": nbytes,
        "async_stall_s": out["async_stall_s"],
        "async_drain_s": out["async_drain_s"],
        "sync_take_gbps": nbytes / out["sync_take_s"] / 1e9,
        "restore_gbps": nbytes / out["restore_s"] / 1e9,
        "sync_restore_gbps": nbytes / out["sync_restore_s"] / 1e9,
        "step_s": out["step_s"],
        "racing_step_s": out["racing_step_s"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(device),
        "wall_s": wall,
    }
    log(f"phase4 state on {card}: {out['n_params']} parameters, {out['n_tensors']} tensors, {nbytes} bytes")
    log(f"phase4 losses (bit-identical after the resume) on {card}: {out['losses']}")
    log(f"phase4 async take on {card}: stall {out['async_stall_s']:.4f} s (phases {json.dumps(out['async_phases'])}), drain {out['async_drain_s']:.3f} s, drain stats {json.dumps(out['drain_stats'])}")
    log(f"phase4 on {card}: sync take {rates['sync_take_gbps']:.3f} GB/s, restore {rates['restore_gbps']:.3f} GB/s, sync restore {rates['sync_restore_gbps']:.3f} GB/s over {nbytes} bytes")
    log(f"phase4 step time on {card}: {out['step_s']} s alone, {out['racing_step_s']} s racing the drain")
    log(f"phase4 allocator growth per step on {card}: alone {json.dumps(out['step_allocations'])}, racing {json.dumps(out['racing_step_allocations'])}")
    for kind in ("async", "sync"):
        log(f"phase4 {kind} take stream decision on {card}: {json.dumps(out[kind + '_stream'])}")
    log(f"phase4 launches on {card}: {json.dumps(launches)}")
    log(f"phase4 on {card}: {json.dumps(rates)}")
    return launches, rates


# ---------------------------------------------------------------------------
# Phase 5: a partial fine-tune, checkpointed with the caches, base= and zlib
# ---------------------------------------------------------------------------


def phase5(seed, device, root, card):
    from torchsnapshot_tpu_torch import dryrun, kernels
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(
        vocab_size=32000, d_model=4096, n_heads=32, n_layers=8, d_ff=16384, max_seq_len=512
    )
    try:
        import zstandard  # noqa: F401

        codecs = ["zlib", "zstd"]
    except ImportError:
        codecs = ["zlib"]
    log(f"phase5 codecs run: {codecs}; disk free {shutil.disk_usage(root).free} bytes")
    results, launches = {}, {}
    for codec in codecs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = dryrun.frozen_finetune_checkpoints(cfg, root, device=device, batch=4, seed=seed, frozen_blocks=4, codec=codec)
        out["wall_s"] = time.monotonic() - t0
        launches[codec] = dict(kernels.LAUNCHES)
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        if launches[codec]["fork_copy"] != 4 or launches[codec]["pack_slab"] < 1:
            raise AssertionError(f"phase5 ({codec}): K2 must launch four times and K1 at least once: {launches[codec]}")
        if out["c5_launches"]["pack_slab"] < 1 or out["c5_launches"]["fork_copy"] != 1:
            raise AssertionError(f"phase5 ({codec}): the batched hit c5 must fork with K2 and pack with K1: {out['c5_launches']}")
        nbytes = out["state_bytes"]
        log(f"phase5 {codec} on {card}: state {nbytes} bytes, frozen {out['frozen_bytes']} bytes, losses {out['losses']} (resume bit-identical)")
        for c, batched in (("c0", False), ("c1", False), ("c4", True), ("c5", True)):
            log(f"phase5 {codec} {c} async take (batching {'on' if batched else 'off'}) on {card}: stall {out[c + '_stall_s']:.4f} s, cache {json.dumps(out[c + '_cache'])}, phases {json.dumps(out[c + '_phases'])}, drain {out[c + '_drain_s']:.3f} s, allocated before/after wait {out[c + '_allocated']}, launches {json.dumps(out[c + '_launches'])}")
        for c, base, batched in (("c2", "c1", False), ("c6", "c5", True)):
            log(f"phase5 {codec} {c} take(base={base}, batching {'on' if batched else 'off'}) on {card}: {out[c + '_take_s']:.3f} s, deduped {out[c + '_bytes_deduped']} bytes vs frozen {out['frozen_bytes']}, objects linked {out[c + '_objects_linked']}, samefile {out[c + '_samefile']} of {out[c + '_objects']}, allocated before/after {out[c + '_allocated']}")
        for c in ("c0", "c1", "c2", "c3", "c4", "c5", "c6"):
            log(f"phase5 {codec} {c} stream decision on {card}: {json.dumps(out[c + '_stream'])}")
        log(f"phase5 {codec} c3 compressed take on {card}: raw {nbytes} bytes, on disk {out['c3_disk_bytes']} bytes (ratio {nbytes / out['c3_disk_bytes']:.4f}), take {out['c3_take_s']:.3f} s ({nbytes / out['c3_take_s'] / 1e9:.3f} GB/s), restore {out['c3_restore_s']:.3f} s ({nbytes / out['c3_restore_s'] / 1e9:.3f} GB/s), allocated before/after {out['c3_allocated']}")
        restores = ", ".join(f"{c} {nbytes / out[c + '_restore_s'] / 1e9:.3f} GB/s" for c in ("c1", "c2", "c4", "c5", "c6"))
        log(f"phase5 {codec} restores (bit-exact) on {card}: {restores}; step times {out['step_s']}")
        log(f"phase5 {codec} launches on {card}: {json.dumps(launches[codec])}; peak device memory {out['peak_device_bytes']} bytes; wall {out['wall_s']:.1f} s")
        results[codec] = out
    return launches, results


# ---------------------------------------------------------------------------
# Phase 6: a serving fleet restoring from one snapshot
# ---------------------------------------------------------------------------

SERVE_CFG = dict(vocab_size=32000, d_model=4096, n_heads=32, n_layers=8, d_ff=16384, max_seq_len=512)
SERVE_BLOCK = "model/block_3.*"  # the lazy restore's subtree


def _fresh_model(cfg, device):
    """An all-zero Transformer on ``device``, without a random init."""
    from torchsnapshot_tpu_torch.models.transformer import Transformer

    with torch.device("meta"):
        model = Transformer(cfg)
    model.to_empty(device=device)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
    return model


def _set_env(env):
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


_SERVE_MODES = {
    "direct": {"TSS_TORCH_BCAST_RESTORE": "0", "TSS_TORCH_SWARM_RESTORE": "0", "TSS_TORCH_BCAST_MAX_BYTES": None},
    "bcast": {"TSS_TORCH_BCAST_RESTORE": "1", "TSS_TORCH_SWARM_RESTORE": "0", "TSS_TORCH_BCAST_MAX_BYTES": None},
    # Every object of this model is under the 256 MiB broadcast cap, so
    # the swarm leg lowers the cap to 1 byte: it then takes every object
    # with a v2 chunk grid.
    "swarm": {"TSS_TORCH_BCAST_RESTORE": "0", "TSS_TORCH_SWARM_RESTORE": "1", "TSS_TORCH_BCAST_MAX_BYTES": "1"},
}


def phase6_worker(rank, world_size, seed, root, out_dir):
    """One serving rank: restores of the served snapshot in every mode, then
    the need-aware swarm reshard of phase 3's TP state. Writes its numbers
    to ``out_dir/rank<r>.json``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import kernels
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, init_params

    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    cfg = TransformerConfig(**SERVE_CFG)
    result = {"rank": rank, "launches": {}, "restores": {}}
    model = init_params(cfg, seed=seed, device=device)
    ref = model.state_dict()
    nbytes = sum(t.numel() * t.element_size() for t in ref.values())
    result["state_bytes"] = nbytes
    result["n_tensors"] = len(ref)
    path = os.path.join(root, "serve")

    def drive(label, fn):
        dist.barrier()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        result["launches"][label] = dict(kernels.LAUNCHES)
        return out, wall

    _, take_s = drive("take", lambda: tts.Snapshot.take(path, {"model": model}, replicated=["**"]))
    if result["launches"]["take"]["pack_slab"] < 1:
        raise AssertionError(f"phase6: the take of the served snapshot did not launch K1: {result['launches']['take']}")
    result["take_gbps"] = nbytes / take_s / 1e9
    if rank == 0:
        sizes = {}
        for e in tts.Snapshot(path).get_manifest().values():
            loc = getattr(e, "location", None)
            if loc:
                sizes[loc] = max(sizes.get(loc, 0), os.path.getsize(os.path.join(path, loc)))
        result["objects"] = len(sizes)
        result["largest_objects"] = sorted(sizes.items(), key=lambda kv: -kv[1])[:4]

    def restore(label, env, include=None):
        _set_env(env)
        target = _fresh_model(cfg, device)
        _, wall = drive(label, lambda: tts.Snapshot(path).restore({"model": target}, include=include))
        got = target.state_dict()
        for k, want in ref.items():
            selected = include is None or snapshot_mod._matches_include(f"model/{k}", include)
            expect = want if selected else torch.zeros_like(want)
            if not torch.equal(_bytes(got[k]), _bytes(expect)):
                raise AssertionError(f"phase6 {label}: {k} differs")
        stats = snapshot_mod.LAST_RESTORE_STATS
        bc, sw = stats["bcast"], stats["swarm"]
        rec = {
            "wall_s": wall,
            "gbps": nbytes / wall / 1e9,
            "bytes_read": stats["bytes_read"],
            "attribution": stats["attribution"],
            "bcast": {k: bc.get(k) for k in ("entries", "origin_bytes", "recv_bytes", "direct_fallbacks", "reelections")},
            "swarm": {k: sw.get(k) for k in ("objects", "chunks", "origin_bytes", "peer_bytes", "cache_bytes", "direct_fallbacks", "reelections", "peer_chunks_verified")},
        }
        result["restores"][label] = rec
        log(f"phase6 rank {rank} {label}: {json.dumps(rec)}")
        del target, got
        torch.cuda.empty_cache()
        return rec

    # (a) the three transports
    for mode, env in _SERVE_MODES.items():
        restore(mode, env)
    _set_env(_SERVE_MODES["direct"])
    # (b) the read cache: one directory per rank, as one per host
    cache_env = {"TSS_TORCH_READ_CACHE_DIR": os.path.join(root, f"cache{rank}")}
    restore("cache_cold", cache_env)
    second = restore("cache_warm", cache_env)
    if second["attribution"]["origin_bytes"] != 0:
        raise AssertionError(f"phase6: the second cached restore read origin bytes: {second}")
    _set_env({"TSS_TORCH_READ_CACHE_DIR": None})
    shutil.rmtree(os.path.join(root, f"cache{rank}"))
    # (c) verified reads
    restore("verify_all", {"TSS_TORCH_VERIFY_READS": "all"})
    _set_env({"TSS_TORCH_VERIFY_READS": None})
    # (d) a lazy restore of one block
    lazy = restore("include_block", {}, include=[SERVE_BLOCK])
    block_bytes = sum(
        t.numel() * t.element_size() for k, t in ref.items()
        if snapshot_mod._matches_include(f"model/{k}", [SERVE_BLOCK])
    )
    result["block_bytes"] = block_bytes
    if lazy["bytes_read"] != block_bytes:
        raise AssertionError(f"phase6: the lazy restore read {lazy['bytes_read']} bytes, the block has {block_bytes}")
    del model, ref
    torch.cuda.empty_cache()

    # (e) phase 3's TP state restored with swapped placements through the
    # need-aware swarm. Each shard is its own object (no slabs: a slab
    # member is a byte range, which the swarm does not trade), and a 16 MiB
    # hash grain gives the 50-67 MB shard objects the v2 chunk grids the
    # swarm needs.
    mesh = DeviceMesh("cuda", list(range(world_size)))
    tp_path = os.path.join(root, "serve_tp")
    params = tp_state(4.0, seed, device, mesh, "save")
    result["tp_local_bytes"] = _tensor_bytes(params)
    _set_env({"TSS_TORCH_HASH_CHUNK_BYTES": str(16 << 20), "TSS_TORCH_ENABLE_BATCHING": "0"})
    drive("tp_take", lambda: tts.Snapshot.take(tp_path, {"model": tts.StateDict(params)}))
    _set_env({"TSS_TORCH_HASH_CHUNK_BYTES": None, "TSS_TORCH_ENABLE_BATCHING": "1", "TSS_TORCH_SWARM_RESTORE": "1"})
    del params
    target = {"model": tts.StateDict(tp_state(4.0, seed, device, mesh, "swap", zeros=True))}
    _, wall = drive("swarm_reshard", lambda: tts.Snapshot(tp_path).restore(target))
    check_tp_state(dict(target["model"]), 4.0, seed, device, "swap", "phase6 swarm reshard")
    sw = snapshot_mod.LAST_RESTORE_STATS["swarm"]
    result["reshard"] = {
        "wall_s": wall,
        "gbps": _tensor_bytes(dict(target["model"])) / wall / 1e9,
        "attribution": snapshot_mod.LAST_RESTORE_STATS["attribution"],
        "swarm": {k: sw.get(k) for k in ("objects", "chunks", "chunks_origin", "chunks_peer", "origin_bytes", "peer_bytes")},
    }
    if result["launches"]["swarm_reshard"]["copy_blocks"] < 1:
        raise AssertionError("phase6: the swarm reshard did not launch K3")
    if sw.get("objects", 0) < 1:
        raise AssertionError(f"phase6: the reshard did not go through the swarm: {sw}")
    _set_env({"TSS_TORCH_SWARM_RESTORE": None})
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def phase6_scrub(root, card):
    """(f): the served snapshot scrubs clean; a copy with one flipped byte
    scrubs corrupt, then is quarantined by a repair, and its restore
    raises."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig
    from torchsnapshot_tpu_torch.parallel.coordinator import Coordinator
    from torchsnapshot_tpu_torch.parallel.store import LocalStore

    path = os.path.join(root, "serve")
    t0 = time.monotonic()
    clean = tts.Snapshot(path).scrub()
    scrub_s = time.monotonic() - t0
    if not clean["clean"]:
        raise AssertionError(f"phase6: scrub of the served snapshot: {clean['problems']} problems")
    copy = os.path.join(root, "serve_copy")
    shutil.copytree(path, copy)
    # The largest object (the embedding table), one byte past its middle.
    victim = max(
        {e.location for e in tts.Snapshot(path).get_manifest().values() if getattr(e, "location", None)},
        key=lambda loc: os.path.getsize(os.path.join(path, loc)),
    )
    _flip_byte(os.path.join(copy, victim), os.path.getsize(os.path.join(path, victim)) // 2 + 1)
    found = tts.Snapshot(copy).scrub()
    if found["entries"][victim]["status"] != "corrupt" or found["corrupt"] != 1:
        raise AssertionError(f"phase6: scrub missed the flipped byte: {found['entries'].get(victim)}")
    fixed = tts.Snapshot(copy).scrub(repair=True)
    status = fixed["entries"][victim]["status"]
    if status not in ("repaired", "quarantined"):
        raise AssertionError(f"phase6: scrub(repair=True) left {victim} {status}")
    raised = None
    if status == "quarantined":
        one = Coordinator(LocalStore(), 0, 1)
        try:
            tts.Snapshot(copy).restore({"model": _fresh_model(TransformerConfig(**SERVE_CFG), torch.device("cuda", 0))}, coordinator=one)
        except FileNotFoundError as e:
            raised = repr(e)[:200]
        if raised is None:
            raise AssertionError("phase6: a restore of the quarantined copy did not raise")
    shutil.rmtree(copy)
    out = {
        "scrub_s": scrub_s,
        "scrub_gbps": clean["bytes"] / scrub_s / 1e9,
        "objects": clean["objects"],
        "bytes": clean["bytes"],
        "flipped": victim,
        "found": found["entries"][victim],
        "after_repair": fixed["entries"][victim],
        "restore_raised": raised,
    }
    log(f"phase6 scrub on {card}: {json.dumps(out)}")
    return out


def _meminfo_kib(field):
    with open("/proc/meminfo") as f:
        return int(next(line for line in f if line.startswith(field + ":")).split()[1])


def _evict_page_cache(path):
    """fsync and ``POSIX_FADV_DONTNEED`` every file under ``path``; returns
    the files and the drop of ``/proc/meminfo``'s ``Cached`` in bytes."""
    before = _meminfo_kib("Cached")
    files = 0
    for dirpath, _, names in os.walk(path):
        for name in names:
            fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
            files += 1
    return {"files": files, "cached_drop_bytes": (before - _meminfo_kib("Cached")) * 1024}


def phase6_native_io(gb, device, gen, root, card):
    """(g): phase 2's sync take and restore with the native engine and
    with ``TSS_TORCH_DISABLE_NATIVE_IO=1``, with the engine's counts; each
    restore runs again after its files are evicted from the page cache."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import native

    fs_type = subprocess.run(["stat", "-f", "-c", "%T", root], capture_output=True, text=True).stdout.strip()
    params, progress, _ = build_state(gb, device, gen)
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    out = {"fs_type": fs_type, "state_bytes": nbytes}
    for label, disabled in (("engine", None), ("no_engine", "1"), ("engine_again", None)):
        _set_env({"TSS_TORCH_DISABLE_NATIVE_IO": disabled})
        path = os.path.join(root, f"native_{label}")
        app = {"model": tts.StateDict(params), "progress": tts.StateDict(progress)}
        native.reset_io_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        tts.Snapshot.take(path, app)
        take_s = time.monotonic() - t0
        target = {"model": tts.StateDict(_zeros_like_tree(params)), "progress": tts.StateDict(step=torch.zeros_like(progress["step"]))}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        tts.Snapshot(path).restore(target)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        _assert_bits_equal(dict(target["model"]), params, f"phase6 native {label}")
        counts = native.io_counts()
        # The same restore after asking the kernel to drop the snapshot's
        # files from the page cache; ``cached_drop_bytes`` shows whether
        # the machine's page cache shrank by them.
        evicted = _evict_page_cache(path)
        for t in _tensors(target["model"]):
            t.zero_()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        tts.Snapshot(path).restore(target)
        torch.cuda.synchronize()
        evicted_s = time.monotonic() - t0
        _assert_bits_equal(dict(target["model"]), params, f"phase6 native {label} evicted")
        out[label] = {
            "take_gbps": nbytes / take_s / 1e9,
            "restore_gbps": nbytes / restore_s / 1e9,
            "evicted_restore_gbps": nbytes / evicted_s / 1e9,
            "page_cache_evicted": evicted,
            "counts": counts,
        }
        if disabled is None and counts["direct_writes"] + counts["buffered_writes"] < 1:
            raise AssertionError(f"phase6: the native engine moved nothing: {counts}")
        if disabled and counts["direct_writes"] + counts["buffered_writes"] + counts["direct_reads"] + counts["buffered_reads"]:
            raise AssertionError(f"phase6: the disabled engine moved bytes: {counts}")
        del target
        shutil.rmtree(path)
    _set_env({"TSS_TORCH_DISABLE_NATIVE_IO": None})
    log(f"phase6 native engine on {card}, temp root on {fs_type}: {json.dumps(out)}")
    return out


def phase6(seed, device, gen, gb, root, card):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    with open("/proc/meminfo") as f:
        avail = next(line for line in f if line.startswith("MemAvailable")).split()[1]
    log(f"phase6 before: host MemAvailable {int(avail) / 1024**2:.1f} GiB, disk free {shutil.disk_usage(root).free} bytes")
    out_dir = os.path.join(root, "phase6_out")
    os.makedirs(out_dir)
    t0 = time.monotonic()
    run_with_processes(phase6_worker, 2, args=(seed, root, out_dir), timeout_s=900, process_group=True)
    log(f"phase6 two serving ranks done in {time.monotonic() - t0:.1f} s")
    ranks = []
    for rank in range(2):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
        log(f"phase6 rank {rank} on {card} (two ranks sharing one card): {json.dumps(ranks[-1])}")
    nbytes = ranks[0]["state_bytes"]
    cap = 256 * 1024 * 1024
    over = [(loc, n) for loc, n in ranks[0]["largest_objects"] if n > cap]
    log(f"phase6 objects above BCAST_MAX_BYTES ({cap}): {over}; largest {ranks[0]['largest_objects'][:2]}")
    summary = {}
    for label in ranks[0]["restores"]:
        recs = [r["restores"][label] for r in ranks]
        summary[label] = {
            "origin_bytes_per_rank": [r["attribution"]["origin_bytes"] for r in recs],
            "peer_bytes_per_rank": [r["attribution"]["peer_bytes"] for r in recs],
            "cache_bytes_per_rank": [r["attribution"]["cache_bytes"] for r in recs],
            "direct_fallbacks": [r["bcast"]["direct_fallbacks"] for r in recs],
            "gbps_per_rank": [r["gbps"] for r in recs],
        }
        log(f"phase6 {label} restore on {card}: {json.dumps(summary[label])}")
    swarm_origin = sum(summary["swarm"]["origin_bytes_per_rank"])
    if swarm_origin > 1.1 * nbytes:
        raise AssertionError(f"phase6: the swarm read {swarm_origin} origin bytes for {nbytes} bytes of state")
    reshard_origin = sum(r["reshard"]["attribution"]["origin_bytes"] for r in ranks)
    tp_bytes = sum(r["tp_local_bytes"] for r in ranks)
    if reshard_origin > 1.1 * tp_bytes:
        raise AssertionError(f"phase6: the swarm reshard read {reshard_origin} origin bytes for {tp_bytes} bytes")
    log(f"phase6 swarm reshard on {card}: origin {reshard_origin} bytes for {tp_bytes} bytes of state ({reshard_origin / tp_bytes:.4f}x), per rank {json.dumps([r['reshard'] for r in ranks])}")
    scrub = phase6_scrub(root, card)
    shutil.rmtree(os.path.join(root, "serve"))
    shutil.rmtree(os.path.join(root, "serve_tp"))
    native_io = phase6_native_io(gb, device, gen, root, card)
    launches = {}
    for r in ranks:
        for label, counts in r["launches"].items():
            launches[f"phase6_rank{r['rank']}_{label}"] = counts
    return launches, {"summary": summary, "scrub": scrub, "native_io": native_io}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gb", type=float, default=4.0, help="size of the main-path state")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    # Phase 4 runs cuBLAS deterministically, which needs this before CUDA starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import torchsnapshot_tpu_torch as tts  # noqa: F401 - fails outside a checkout
    from torchsnapshot_tpu_torch import kernels

    os.environ.setdefault("TSS_TORCH_ENABLE_BATCHING", "1")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = f"{smi} ({torch.cuda.get_device_name(0)})"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    import threading

    from torchsnapshot_tpu_torch import native

    # The kernels (nvcc) and the native I/O engine (g++) build side by side.
    t0 = time.monotonic()
    engine = {}
    engine_build = threading.Thread(target=lambda: engine.update(lib=native.load_native()))
    engine_build.start()
    kernels.load_library()
    engine_build.join()
    log(f"kernel build: {kernels.BUILD_SECONDS:.2f} s compile, {time.monotonic() - t0:.2f} s to load")
    if engine.get("lib") is None:
        raise AssertionError("the native I/O engine did not build or load")
    log(f"native I/O engine: ABI {engine['lib'].tss_io_version()}, {native._lib_path()}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    errs = phase1(device, gen)

    root = tempfile.mkdtemp(prefix="tss_chip_smoke_")
    try:
        launches, rates, slab_layer, state_tensors = phase2(args.gb, device, gen, root, card)
        # The main path's K1 slab is one layer's attn plus its small tensors.
        slab_members = [slab_layer[k] for k in sorted(slab_layer)]
        times = time_kernels(device, slab_members, state_tensors)
        del slab_layer, slab_members, state_tensors
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        k3_times = time_k3(device, args.gb, gen)
        ranks = phase3(args.gb, args.seed, root, card)
        launches["phase4"], trainer = phase4(args.seed, device, root, card)
        phase5_launches, finetune = phase5(args.seed, device, root, card)
        for codec, counts in phase5_launches.items():
            launches[f"phase5_{codec}"] = counts
        phase6_launches, serving = phase6(args.seed, device, gen, args.gb, root, card)
        launches.update(phase6_launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    for name, t in times.items():
        log(f"{name} timing on {card}: {json.dumps(t)}")
    for label, t in k3_times.items():
        log(f"copy_blocks timing ({label}) on {card}: {json.dumps(t)}")
    log(f"main path on {card}: {json.dumps(rates)}")
    log(f"phase4 trainer on {card}: {json.dumps(trainer)}")
    for codec, out in finetune.items():
        summary = {k: v for k, v in out.items() if not k.endswith(("_phases", "_stream"))}
        log(f"phase5 {codec} summary on {card}: {json.dumps(summary)}")
    log(f"phase6 serving summary on {card}: {json.dumps(serving)}")
    for r in ranks:
        log(
            f"phase3 rank {r['rank']} (two ranks sharing one card): take {r['rates']['take_gbps']:.3f} GB/s, "
            f"restore {r['rates']['restore_gbps']:.3f} GB/s, reshard restore {r['rates']['reshard_restore_gbps']:.3f} GB/s, "
            f"async stall {r['rates']['async_stall_s']:.4f} s, drain {r['rates']['async_drain_s']:.3f} s, "
            f"launches {json.dumps(r['launches'])}"
        )
    times["copy_blocks"] = k3_times["rectangle"]
    for r in ranks:
        for label, counts in r["launches"].items():
            launches[f"rank{r['rank']}_{label}"] = counts

    sources = {
        "pack_slab": ("torchsnapshot_tpu_torch/csrc/tss_kernels.cu", "torchsnapshot_tpu/batcher.py:408"),
        "fork_copy": ("torchsnapshot_tpu_torch/csrc/tss_kernels.cu", "torchsnapshot_tpu/io_preparer.py:348"),
        "copy_blocks": ("torchsnapshot_tpu_torch/csrc/tss_kernels.cu", "torchsnapshot_tpu/io_preparers/sharded_array.py:266"),
    }
    record = {"kernels": []}
    for name, (source, replaces) in sources.items():
        t = times[name]
        total = sum(d.get(name, 0) for d in launches.values())
        if total < 1:
            raise AssertionError(f"{name} was not launched on the main path: {launches}")
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": total,
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": t["library_ms"],
        })
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

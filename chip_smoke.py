"""Drive torchsnapshot_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a host with one CUDA GPU::

    python3 chip_smoke.py [--gb 4.0] [--phase3-gb 2.0] [--phase9-gb 2.0] [--seed 0]

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
restore that must give the values from before the mutation. The sync
take and its restore run under ``TSS_TORCH_DEBUG_LEDGER=1`` (phase 9): a
budget leak raises ``LedgerLeakError``.
Phase 3 drives the multi-rank path: two ranks, two processes on the one
card (gloo process group, ``DeviceMesh("cuda", (2,))``), holding a
``--phase3-gb`` GB model state (2 GB since phase 8 came: cut from ``--gb``
so the script keeps its time) sharded tensor-parallel style as DTensors (``attn`` and ``up``
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
same width (``--phase5-layers``, 2 since phase 13 came; 4 before, and 8
before phase 11), its
token and position embeddings and first half of its blocks frozen
(``requires_grad=False``, out of the optimizer): steps 1-2, ``async_take``
to c0 (a prepared-take miss), step 3 racing its drain; ``async_take`` to c1
(a hit, other values), step 4 racing; a sync take to c2 with ``base=c1``
(the frozen tensors hard-linked); step 5, a sync take to c3 with slabs
(``--phase5-codecs``, zlib by default, and zstd where ``zstandard`` is
installed, one run of the drive each: member-framed compressed slabs);
steps 6-7; then c1, c2 and c3 restored
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
launches. The phase runs once per codec of ``--phase5-codecs`` (``zstd``
only when ``zstandard`` imports). Phase 4 prints its takes' streaming decisions too.
Phase 0 also builds the native O_DIRECT I/O engine (``g++``, beside the
kernels' ``nvcc``) and fails if it does not load.
Phase 6 drives a serving fleet: two ranks on the one card (gloo) each hold
phase 4's transformer weights at 4 layers (2.14 GB, no optimizer; 8
layers, 3.75 GB, before phase 13 came: a depth cut), taken once with
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
Phase 7 drives continuous checkpointing: phase 5's partial fine-tune at
the same width (8 layers, the embeddings and first 4 blocks frozen, AdamW)
checkpointed into one bucket with ``job="ft"``, ``step=`` and
``max_chain_len=2`` and batching on: ``async_take`` t1, sync t2,
``async_take`` t3 and t4, sync t5, ``async_take`` t6 after the chain cache
is dropped (its base from a catalog scan), one training step between takes
and each ``async_take`` raced by the next step. The chains must record 0,
1, 2, 0, 1, 2. ``catalog.retain(bucket, "last=2")`` then condemns t1-t4
(t5's base t4 among them) and keeps t5 and t6, which restore bit-exactly
into a fresh model, directly and through a fresh read cache (t6 reads only
its unshared bytes from the origin); a planted torn ``*.tmp.*`` file and an
uncommitted root are all a ``Snapshot.gc`` sweep removes
(``dryrun.continuous_checkpoints``). It prints the chains, each delta's
deduped bytes against the frozen bytes, stalls and rates, the retain and
gc reports with the bucket's bytes before and after, the cache's origin
bytes and the phase's launches (K1 and K2 must launch; K3 is not on it).
Phase 8 traces the port on the card: (a) phase 4's trainer (8 layers, AdamW,
11.25 GB in 408 tensors) takes steps 1-3, ``async_take`` raced by step 4
with ``TSS_TORCH_TRACE`` set, then a traced restore into a fresh model,
bit-exact; the trace must parse, drop no span, hold ``take.phase`` spans
equal to ``LAST_TAKE_PHASES``, and ``stage.d2h`` spans whose bytes are the
state's CUDA bytes at a rate no higher than the host link's 64 GB/s; it
prints the io node's split (the union of hashing time against the union of
storage time) for the drain and the restore. (b) phase 3's TP state on two
ranks (gloo), fleet beacons on, a traced take and a swapped-placement
restore (K3), per-rank traces (``.rank1``); ``fleet-health`` must read both
beacons and ``python -m torchsnapshot_tpu_torch stats`` merge both ranks'
artifacts, whose byte counters must equal each rank's written bytes.
(c) phase 2's state, three interleaved pairs of a sync take and an
``async_take`` drain with the flight recorder and artifacts on against both
off: medians and spread, a warning (not a failure) above 1% of the drain.
Phase 9 drives the engine's QoS classes and FSDP2 over TP. (a) In one
process, phase 4's trainer state (8 layers, AdamW, every parameter and
moment from the seed, 11.25 GB) is taken with ``async_take(qos=
"background")``; as soon as its drain has staged its first bytes,
``restore(qos="foreground")`` of a snapshot of the same model's weights
(phase 4's 8 layers, 3.75 GB) goes into a fresh model's live CUDA tensors
(``dryrun.qos_race``): one interleaved pair (three before phase 11
came, two before phase 13 came: a depth cut for the script's time) with QoS on and with ``TSS_TORCH_QOS=0``, the first pair
under ``TSS_TORCH_DEBUG_LEDGER=1``.
It prints per race the restore's seconds and GB/s, the drain's seconds
and the drain engine's ``engine.preemptions`` and
``engine.preempted_wait_s`` (its artifact's ``engine`` section), which
must be > 0 with QoS on and exactly 0 off; every restore, and a restore of
each drained snapshot, must be bit-exact. (b) Four ranks share the card
(gloo, ``init_device_mesh("cuda", (2, 2), ("dp", "tp"))``) and lay the
transformer at phase 4's width out as FSDP2 over TP
(``models.transformer.parallelize_fsdp_tp``: ``ColwiseParallel`` on
``up``/``lm_head``, ``RowwiseParallel`` on ``down``, ``fully_shard`` over
``dp``) with AdamW state, ``--phase9-gb`` GB in whole layers (one layer:
~2.8 GB); gloo has no reduce-scatter, so no step runs and every parameter
and moment is filled from the seed. ``up`` and ``lm_head`` must carry
``_StridedShard``; the state is taken, restored into the same layout,
into ``Shard(0)`` over a flat mesh of 4, and that plain state's take back
into FSDP x TP (``dryrun.fsdp_tp_checkpoints``), every local shard equal
to its seeded block; K3 must launch on every rank. It prints bytes, GB/s
and K3 launches per rank and step.
Phase 10 drives robustness under storage faults and preemption
(``TSS_TORCH_FAULTS``, ``faults.py``): (a) phase 2's state taken under a
storm of transient write faults (every third write fails once, six times;
whole-object writes, since neither package retries an injected append
fault) commits with ``faults.transient`` and ``cloud_retry.faults.retries``
both 6, launches K1 and restores bit-exactly; (b) an ``async_take`` under
``op=write,at=2,kind=fail`` with the ledger on: ``wait()`` raises
``CheckpointAbortedError``, no ``.snapshot_metadata``, the fork's device
memory is given back, K2 launches, the previous snapshot restores
bit-exactly; (c) a spawned child on the card takes ``s0`` (``job=``), then
an ``async_take`` of ``s1`` that ``op=write,at=4,kind=kill`` ends: the
child exits 87, the catalog's latest is ``s0``, ``Snapshot.gc`` removes
exactly ``s1``'s debris and a second run nothing, ``s0`` restores
bit-exactly; (d) ``s0`` under ``TSS_TORCH_VERIFY_READS=all``: one corrupt
read heals by one re-fetch, bit-exact, and an object that rots on every
read raises ``CheckpointAbortedError(rank=0, phase="restore.read")`` from
the ``ReadVerificationError`` naming it, and a sync take under
``op=write,at=2,kind=fail`` raises ``CheckpointAbortedError(rank=0,
phase="write")`` and leaves no ``.snapshot_metadata``; (e) two ranks (gloo) on phase 3's
TP state: a take failing on rank 1 aborts both ranks naming rank 1, and a
swapped-placement restore under a transient read storm on rank 0 is
bit-exact with K3 on both ranks; (f) continuous checkpointing of phase 2's
widths at one layer (369 MB; the depth cut so every prefix's verify and gc
fit) journaled under ``TSS_TORCH_DEBUG_EFFECTS=1`` (t1, t2 a delta of t1,
``retain("last=1")``, gc) and explored by ``crash_explorer`` with 2
interior cuts, a restore into CUDA tensors of every committed snapshot in
every crash state: 0 violations.
Phase 11 drives the capture and transfer controls on phase 4's trainer
at phase 4's width and depth (``--phase11-layers``, 8: 11.25 GB of AdamW
state in 408 tensors): (a) ``async_take`` with the fork, eager D2H on
against off (``TSS_TORCH_ASYNC_EAGER_D2H``), two alternating pairs
(``--phase11-pairs``, cut from 3, and to 1 since phase 13 came, for the
script's time), each raced by two
in-place AdamW steps: the stall, the drain, the racing steps' times
against two unraced ones, the fork's device memory and the ``stage.d2h``
busy time and bytes of each take's telemetry; the last pair's snapshots
restore bit-exactly into a second model and optimizer, and the racing
steps resumed from them give the same state bit for bit. (b)
``TSS_TORCH_ASYNC_CAPTURE=donate``: a take that keeps the promise commits
with no K2 launch and no device memory above the live state, and restores
bit-exactly; a take whose state a training step updates in place before
its copies end (the card asleep before the capture point) fails at
``wait()`` with no ``.snapshot_metadata``, and the kept snapshot still
restores bit-exactly. (c) ``TSS_TORCH_ASYNC_FORK_HBM_LIMIT_BYTES`` at half
the state: the forked and host-captured leaves and bytes, the stall, a
bit-exact restore. (d) the state set from the seed and taken, then
restored into live CUDA tensors with ``TSS_TORCH_RESTORE_OVERLAP`` on
against off, ``--phase11-pairs`` pairs, each in a fresh child process (forked from a
server that has imported torch and the port): the rate, the resident-set
peak above the child's start (``VmRSS`` sampled every 5 ms: the card's
kernel reports no ``VmHWM``) and the pinned host allocator's peak, every
tensor held against its seeded value. (e) two ranks on the card (gloo) at phase 3's depth,
``LOCAL_WORLD_SIZE`` withheld: each rank's budget (0.6 x ``MemAvailable``
/ 2) and fs I/O cap (8) from the hostname gather, and a swapped-placement
restore under overlapped restore with K3 on both ranks, bit-exact.
Phase 12 drives K1 under a real out of memory, in a child process of its
own (the allocator's cap and segments stay there): phase 2's widths at 4
layers; with the caching allocator capped 99 MiB above the live state
(``torch.cuda.set_per_process_memory_fraction``), room for a layer's attn
(96 MiB, the largest slab member) and K1's descriptor table (a 2 MiB
segment) and none for its slab (attn and the layer's small tensors, which
the allocator rounds to 98 MiB) and the table, a sync
take and a ``TSS_TORCH_ASYNC_CAPTURE=donate`` ``async_take`` commit with
every slab packed by K1 in groups (the whole slab's allocation raises
``torch.cuda.OutOfMemoryError``; one warning per slab); with the cap
lifted both restore bit-exactly and verify, and an uncapped take (one K1
launch per slab) holds the same bytes for every slab member, read back by
``read_object``.
Phase 13 drives the storage-plugin extension contract and the examples.
(a) In a child process whose ``PYTHONPATH`` holds a site directory, a
third-party plugin that implements only ``write``, ``read`` and ``delete``
is registered as protocol ``smokefs`` under the entry-point group
``torchsnapshot_tpu_torch.storage_plugins`` by a ``.dist-info`` folder, as
an installed package registers one; phase 12's state (phase 2's widths at
4 layers, 1.48 GB) goes through it with batching on: a sync take (K1), an
``async_take`` raced by an in-place ``add_(1)`` of every tensor (K2),
restores of both into zeroed CUDA tensors, bit-exact, and ``verify() ==
{}``; a take under ``TSS_TORCH_FAULTS=op=write,at=1,kind=torn,bytes=4096``
must raise ``CheckpointAbortedError`` and leave no ``.snapshot_metadata``.
It prints each take's and restore's GB/s and the launches. (b) The three
examples of ``examples/torch/`` run as ``python examples/torch/<name>.py``
on the card, side by side: ``simple_example.py`` for two epochs, then
relaunched for four (it must resume from epoch 2);
``distributed_example.py`` (two gloo ranks on the card, a bit-exact
restore into the transposed mesh); ``embedding_example.py`` at its default
1,000,000 x 128 fp32 (512 MB), whose ``Replicate()`` restore must launch
K3 on both ranks. Each must exit 0 and print its success line.
Every phase's wall seconds are printed.
The launch counts are set to 0 just before each drive and read just after.

Any failure raises, and the script exits non-zero without a result line.
Every process it starts (ranks, children, the ``multiprocessing``
forkserver and resource tracker) is stopped and reaped before it exits.
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


# ---------------------------------------------------------------------------
# The processes the script starts
# ---------------------------------------------------------------------------


def _become_subreaper() -> None:
    """Make this process the parent of its orphaned descendants (Linux
    ``PR_SET_CHILD_SUBREAPER``), so that :func:`_stop_processes` finds a
    process whose own parent ended first."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _descendants(pid):
    """``[(pid, state)]`` of every live descendant of ``pid``, from ``/proc``."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        children.setdefault(int(fields[1]), []).append((int(entry), fields[0]))
    out, todo = [], [pid]
    while todo:
        for child, state in children.get(todo.pop(), []):
            out.append((child, state))
            todo.append(child)
    return out


def _stop_forkserver() -> None:
    """End the ``multiprocessing`` forkserver, if one runs, and wait for
    it. Left alone it would outlive the script: it ends only when it reads
    EOF on a pipe that this process holds, and then unloads torch first."""
    import signal
    from multiprocessing import forkserver

    server = forkserver._forkserver
    if server._forkserver_pid is None:
        return
    try:
        os.kill(server._forkserver_pid, signal.SIGTERM)
    except ProcessLookupError:
        pass
    server._stop()


def _stop_processes(grace_s: float = 10.0):
    """Stop every process this script started and reap it: the forkserver,
    the ``multiprocessing`` resource tracker (it ends at EOF on its pipe),
    then any descendant still alive, SIGTERM first and SIGKILL after
    ``grace_s``. Returns the pids that had to be signalled."""
    import signal
    from multiprocessing import resource_tracker

    _stop_forkserver()
    tracker = resource_tracker._resource_tracker
    if tracker._fd is not None:
        os.close(tracker._fd)
        tracker._fd = None
    signalled = []
    deadline = time.monotonic() + grace_s
    while True:
        while True:
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break
        live = [pid for pid, state in _descendants(os.getpid()) if state != "Z"]
        if not live:
            return signalled
        late = time.monotonic() > deadline
        if late and time.monotonic() > deadline + grace_s:
            raise RuntimeError(f"processes {live} survived SIGKILL")
        for pid in live:
            if pid == tracker._pid and not late:
                continue
            try:
                os.kill(pid, signal.SIGKILL if late else signal.SIGTERM)
            except ProcessLookupError:
                continue
            if pid not in signalled:
                signalled.append(pid)
        time.sleep(0.1)


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


def build_state(gb: float, device, gen, n_layers=None):
    """Transformer-shaped params (bench.py's d_model 4096 / d_ff 16384
    layers, bf16, plus LayerNorm weights in fp32 and bf16 biases), an int64
    step tensor, primitives and a pickled object; ``n_layers`` layers, by
    default as many as make ``gb`` GB."""
    d_model, d_ff = 4096, 16384
    layer_bytes = (3 * d_model * d_model + 2 * d_model * d_ff) * 2
    if n_layers is None:
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

    # 1. sync take, batching on; it and the restore run under the budget
    # ledger (phase 9): a leak raises LedgerLeakError.
    os.environ["TSS_TORCH_DEBUG_LEDGER"] = "1"
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
    os.environ.pop("TSS_TORCH_DEBUG_LEDGER")
    log(f"restore: {restore_s:.3f} s, {rates['restore_gbps']:.3f} GB/s (sync take and restore under TSS_TORCH_DEBUG_LEDGER=1)")
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


def phase5(seed, device, root, card, codecs=("zlib", "zstd"), n_layers=2):
    """``codecs``: c3's codec, one run of the drive each (``zstd`` only
    where ``zstandard`` is installed; ``none`` takes c3 uncompressed).
    ``n_layers``: the fine-tune's depth (2 since phase 13 came; 4 since
    phase 11, 8 before; cut for the script's time), its first half
    frozen."""
    from torchsnapshot_tpu_torch import dryrun, kernels
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(
        vocab_size=32000, d_model=4096, n_heads=32, n_layers=n_layers, d_ff=16384, max_seq_len=512
    )
    codecs = list(codecs)
    if "zstd" in codecs:
        try:
            import zstandard  # noqa: F401
        except ImportError:
            codecs.remove("zstd")
    log(f"phase5 codecs run: {codecs}; disk free {shutil.disk_usage(root).free} bytes")
    results, launches = {}, {}
    for codec in codecs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = dryrun.frozen_finetune_checkpoints(
            cfg, root, device=device, batch=4, seed=seed, frozen_blocks=n_layers // 2, codec=codec
        )
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
        log(f"phase5 {codec} c3 take (codec {codec}) on {card}: raw {nbytes} bytes, on disk {out['c3_disk_bytes']} bytes (ratio {nbytes / out['c3_disk_bytes']:.4f}), take {out['c3_take_s']:.3f} s ({nbytes / out['c3_take_s'] / 1e9:.3f} GB/s), restore {out['c3_restore_s']:.3f} s ({nbytes / out['c3_restore_s'] / 1e9:.3f} GB/s), allocated before/after {out['c3_allocated']}")
        restores = ", ".join(f"{c} {nbytes / out[c + '_restore_s'] / 1e9:.3f} GB/s" for c in ("c1", "c2", "c4", "c5", "c6"))
        log(f"phase5 {codec} restores (bit-exact) on {card}: {restores}; step times {out['step_s']}")
        log(f"phase5 {codec} launches on {card}: {json.dumps(launches[codec])}; peak device memory {out['peak_device_bytes']} bytes; wall {out['wall_s']:.1f} s")
        results[codec] = out
    return launches, results


# ---------------------------------------------------------------------------
# Phase 6: a serving fleet restoring from one snapshot
# ---------------------------------------------------------------------------

# Phase 4's widths at 4 layers (2.14 GB; 8 layers, 3.75 GB, until phase 13
# needed the script's time).
SERVE_CFG = dict(vocab_size=32000, d_model=4096, n_heads=32, n_layers=4, d_ff=16384, max_seq_len=512)
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
        except tts.CheckpointAbortedError as e:
            if not isinstance(e.__cause__, FileNotFoundError):
                raise AssertionError(f"phase6: the quarantined copy's restore failed from {e.__cause__!r}") from e
            raised = repr(e.__cause__)[:200]
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


# ---------------------------------------------------------------------------
# Phase 7: continuous checkpointing under the catalog, retention and gc
# ---------------------------------------------------------------------------


def phase7(seed, device, root, card):
    from torchsnapshot_tpu_torch import dryrun, kernels
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(
        vocab_size=32000, d_model=4096, n_heads=32, n_layers=8, d_ff=16384, max_seq_len=512
    )
    log(f"phase7 before: disk free {shutil.disk_usage(root).free} bytes")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = dryrun.continuous_checkpoints(cfg, root, device=device, batch=4, seed=seed, frozen_blocks=4)
    out["wall_s"] = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    if launches["pack_slab"] < 1 or launches["fork_copy"] != 4 or launches["copy_blocks"] != 0:
        raise AssertionError(f"phase7: K1 must launch, K2 once per async take (4), K3 never: {launches}")
    nbytes, frozen = out["state_bytes"], out["frozen_bytes"]
    t6 = out["takes"]["t6"]["record"]
    origin_t6 = out["t6_cached_attribution"]["origin_bytes"]
    if origin_t6 != t6["bytes_written"]:
        raise AssertionError(f"phase7: t6 read {origin_t6} origin bytes through the cache, its unshared bytes are {t6['bytes_written']}")
    log(f"phase7 on {card}: state {nbytes} bytes, frozen {frozen} bytes, chain lengths {out['chain_lens']}")
    for name, rec in out["takes"].items():
        r = rec["record"]
        if rec["async"]:
            how = f"async_take stall {rec['stall_s']:.4f} s, drain {rec['drain_s']:.3f} s ({nbytes / (rec['stall_s'] + rec['drain_s']) / 1e9:.3f} GB/s)"
        else:
            how = f"sync take {rec['take_s']:.3f} s ({nbytes / rec['take_s'] / 1e9:.3f} GB/s)"
        log(
            f"phase7 {name} (step {rec['step']}) on {card}: {how}; base {r['base']}, chain {r['chain_len']}, "
            f"deduped {r['bytes_deduped']} of {r['bytes_total']} bytes (frozen {frozen}; drain stats deduped "
            f"{rec['drain_stats'].get('bytes_deduped')}, linked {rec['drain_stats'].get('objects_linked')}), "
            f"cache {json.dumps(rec['cache'])}, launches {json.dumps(rec['launches'])}"
        )
    log(f"phase7 retain last=2 on {card}: dry run {json.dumps(out['retain_dry'])}; applied {json.dumps(out['retain_applied'])} in {out['retain_s']:.3f} s; bucket bytes (files, distinct inodes) before {out['bucket_bytes_before']}, after {out['bucket_bytes_after']}")
    for name in ("t5", "t6"):
        log(f"phase7 {name} restores (bit-exact, base collected) on {card}: direct {nbytes / out[name + '_restore_s'] / 1e9:.3f} GB/s, through a fresh read cache {nbytes / out[name + '_cached_restore_s'] / 1e9:.3f} GB/s, attribution {json.dumps(out[name + '_cached_attribution'])}")
    log(f"phase7 t6 origin bytes through the cache on {card}: {origin_t6} (its unshared bytes {t6['bytes_written']}, state {nbytes})")
    log(f"phase7 gc debris sweep on {card}: {json.dumps(out['gc'])}")
    log(f"phase7 launches on {card}: {json.dumps(launches)}; peak device memory {out['peak_device_bytes']} bytes; takes {out['takes_wall_s']:.1f} s; wall {out['wall_s']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# Phase 8: telemetry on the card
# ---------------------------------------------------------------------------

# The H100's host link: PCIe 5.0 x16, 128 GB/s both ways together (NVIDIA's
# data sheet), so at most 64 GB/s one way. A stage.d2h span that closed at
# the copy's enqueue would imply a faster rate.
HOST_LINK_BYTES_PER_S = 64e9
TRAINER_CFG = dict(vocab_size=32000, d_model=4096, n_heads=32, n_layers=8, d_ff=16384, max_seq_len=512)


def _io_split(report):
    return {k: report[k] for k in ("hash_busy_s", "write_busy_s", "read_busy_s", "consume_busy_s")}


def phase8a(seed, device, root, card):
    """Phase 4's trainer, its async checkpoint and restore traced."""
    from torchsnapshot_tpu_torch import dryrun, kernels
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(**TRAINER_CFG)
    trace_dir = os.path.join(root, "phase8_traces")
    os.makedirs(trace_dir)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = dryrun.traced_checkpoint(cfg, root, trace_dir, device=device, batch=4, seed=seed)
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    take = dryrun.trace_report(out["traces"]["take"])
    restore = dryrun.trace_report(out["traces"]["restore"])
    if launches["pack_slab"] < 1 or launches["fork_copy"] != 1:
        raise AssertionError(f"phase8 (a): K1 must launch and K2 once: {launches}")
    for name, rep in (("take", take), ("restore", restore)):
        if rep["dropped_spans"] or rep["spans_dropped_metric"]:
            raise AssertionError(f"phase8 (a): the {name} trace dropped spans: {rep['dropped_spans']}")
    phases = out["take_phases"]
    if set(take["phases"]) != set(phases) or any(abs(take["phases"][k] - v) > 1e-6 for k, v in phases.items()):
        raise AssertionError(f"phase8 (a): take.phase spans {take['phases']} != LAST_TAKE_PHASES {phases}")
    if take["d2h_bytes"] != out["d2h_bytes"] or take["metrics"].get("d2h.bytes") != out["d2h_bytes"]:
        raise AssertionError(f"phase8 (a): stage.d2h bytes {take['d2h_bytes']} != the state's CUDA bytes {out['d2h_bytes']}")
    d2h_rate = take["d2h_bytes"] / take["d2h_busy_s"]
    if d2h_rate > HOST_LINK_BYTES_PER_S:
        raise AssertionError(f"phase8 (a): D2H at {d2h_rate / 1e9:.1f} GB/s beats the host link: a span closed at enqueue")
    for need in ("scheduler.stage", "scheduler.io", "stage.hash_chunk", "storage.write", "capture"):
        if not take["span_counts"].get(need):
            raise AssertionError(f"phase8 (a): no {need} span in the take trace")
    if not restore["span_counts"].get("scheduler.consume"):
        raise AssertionError("phase8 (a): no scheduler.consume span in the restore trace")
    summary = {
        "state_bytes": out["state_bytes"],
        "d2h_bytes": out["d2h_bytes"],
        "async_stall_s": out["async_stall_s"],
        "async_drain_s": out["async_drain_s"],
        "restore_s": out["restore_s"],
        "d2h_busy_s": take["d2h_busy_s"],
        "d2h_gbps": d2h_rate / 1e9,
        "take_spans": take["spans"],
        "restore_spans": restore["spans"],
        "drain_io_split_s": _io_split(take),
        "restore_io_split_s": _io_split(restore),
        "drain_stats": out["drain_stats"],
        "wall_s": wall,
    }
    log(f"phase8 (a) traced trainer checkpoint on {card}: {out['n_tensors']} tensors, {out['state_bytes']} bytes "
        f"({out['d2h_bytes']} on the card), stall {out['async_stall_s']:.4f} s, drain {out['async_drain_s']:.3f} s, "
        f"restore {out['restore_s']:.3f} s (bit-exact), {take['spans']} + {restore['spans']} spans, none dropped, "
        f"artifact writes {take['artifact_write_s']:.4f} / {restore['artifact_write_s']:.4f} s")
    log(f"phase8 (a) stage.d2h on {card}: {take['d2h_bytes']} bytes over {take['d2h_busy_s']:.3f} s busy "
        f"({d2h_rate / 1e9:.2f} GB/s, host link {HOST_LINK_BYTES_PER_S / 1e9:.0f} GB/s)")
    log(f"phase8 (a) io node split, drain, on {card}: hashing {take['hash_busy_s']:.3f} s busy, "
        f"storage.write {take['write_busy_s']:.3f} s busy, drain wall {out['async_drain_s']:.3f} s, "
        f"drain stats {json.dumps(out['drain_stats'])}")
    log(f"phase8 (a) io node split, restore, on {card}: storage.read {restore['read_busy_s']:.3f} s busy, "
        f"hashing {restore['hash_busy_s']:.3f} s, scheduler.consume {restore['consume_busy_s']:.3f} s, "
        f"restore wall {out['restore_s']:.3f} s")
    log(f"phase8 (a) take span counts on {card}: {json.dumps(take['span_counts'], sort_keys=True)}")
    log(f"phase8 (a) launches on {card}: {json.dumps(launches)}")
    return launches, summary


def phase8b_worker(rank, world_size, gb, seed, root, out_dir):
    """One rank of phase 8 (b): phase 3's TP state, traced, fleet beacons on."""
    import contextlib as ctx
    import io

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import kernels
    from torchsnapshot_tpu_torch.__main__ import main as cli_main

    os.environ["TSS_TORCH_FLEET_TELEMETRY"] = "1"
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mesh = DeviceMesh("cuda", list(range(world_size)))
    result = {"rank": rank, "launches": {}}
    params = tp_state(gb, seed, device, mesh, "save")
    path = os.path.join(root, "tp_traced")
    os.environ["TSS_TORCH_TRACE"] = os.path.join(out_dir, "take.json")  # rank 1: take.json.rank1
    dist.barrier()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tts.Snapshot.take(path, {"model": tts.StateDict(params)})
    result["launches"]["take"] = dict(kernels.LAUNCHES)
    del params
    target = {"model": tts.StateDict(tp_state(gb, seed, device, mesh, "swap", zeros=True))}
    os.environ["TSS_TORCH_TRACE"] = os.path.join(out_dir, "restore.json")
    dist.barrier()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tts.Snapshot(path).restore(target)
    torch.cuda.synchronize()
    result["launches"]["reshard_restore"] = dict(kernels.LAUNCHES)
    os.environ.pop("TSS_TORCH_TRACE")
    check_tp_state(dict(target["model"]), gb, seed, device, "swap", "phase8 swapped-placement restore")
    if result["launches"]["reshard_restore"]["copy_blocks"] < 1:
        raise AssertionError("phase8 (b): K3 was not launched in the reshard restore")
    del target
    dist.barrier()
    if rank == 0:
        store = dist.distributed_c10d._get_default_store()._underlying_non_prefix_store
        out = io.StringIO()
        with ctx.redirect_stdout(out):
            rc = cli_main(["fleet-health", f"{store.host}:{store.port}"])
        result["fleet_health"] = {"rc": rc, "text": out.getvalue()}
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def phase8b(gb, seed, root, card):
    from torchsnapshot_tpu_torch import dryrun, hashing
    from torchsnapshot_tpu_torch.telemetry import aggregate
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    out_dir = os.path.join(root, "phase8b_out")
    os.makedirs(out_dir)
    t0 = time.monotonic()
    run_with_processes(phase8b_worker, 2, args=(gb, seed, root, out_dir), timeout_s=600, process_group=True)
    wall = time.monotonic() - t0
    ranks = []
    for rank in range(2):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    fleet = ranks[0]["fleet_health"]
    if fleet["rc"] != 0 or "fleet: world_size=2  beacons=2" not in fleet["text"]:
        raise AssertionError(f"phase8 (b): fleet-health did not read both ranks' beacons: {fleet}")
    path = os.path.join(root, "tp_traced")
    proc = subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch", "stats", path],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0 or "ranks_present=2" not in proc.stdout:
        raise AssertionError(f"phase8 (b): stats failed: {proc.stdout} {proc.stderr}")
    world, artifacts, problems = aggregate.read_snapshot_artifacts(path)
    if problems or sorted(artifacts) != [0, 1]:
        raise AssertionError(f"phase8 (b): artifacts {sorted(artifacts)}, problems {problems}")
    per_rank = {}
    for rank in range(2):
        with open(os.path.join(path, f".checksums.{rank}")) as f:
            local = sum(hashing.record_size(r) for r in json.load(f).values())
        art = artifacts[rank]
        if not (art["bytes"]["written"] == art["metrics"]["scheduler.bytes_staged"] == local):
            raise AssertionError(f"phase8 (b): rank {rank} counters {art['bytes']} != its local bytes {local}")
        take = dryrun.trace_report(os.path.join(out_dir, "take.json" + ("" if rank == 0 else f".rank{rank}")))
        restore = dryrun.trace_report(os.path.join(out_dir, "restore.json" + ("" if rank == 0 else f".rank{rank}")))
        if take["dropped_spans"] or restore["dropped_spans"] or not restore["span_counts"].get("scheduler.consume"):
            raise AssertionError(f"phase8 (b): rank {rank} traces incomplete")
        if take["d2h_bytes"] != local:
            raise AssertionError(f"phase8 (b): rank {rank} stage.d2h bytes {take['d2h_bytes']} != local {local}")
        per_rank[rank] = {
            "local_bytes": local,
            "take_io_split_s": _io_split(take),
            "restore_io_split_s": _io_split(restore),
            "launches": ranks[rank]["launches"],
        }
    shutil.rmtree(path)
    log(f"phase8 (b) two ranks on {card} (gloo, one card), traced take and swapped-placement restore in {wall:.1f} s")
    log("phase8 (b) fleet-health:\n" + fleet["text"].rstrip())
    log("phase8 (b) stats:\n" + proc.stdout.rstrip())
    log(f"phase8 (b) per rank on {card}: {json.dumps(per_rank)}")
    return {f"phase8b_rank{r}_{k}": v for r in range(2) for k, v in ranks[r]["launches"].items()}, per_rank


def phase8c(gb, device, gen, root, card):
    """Overhead of the always-on telemetry: phase 2's state, sync take and
    async_take drain, with the recorder and artifacts on against both off,
    three interleaved pairs."""
    import statistics

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import kernels
    from torchsnapshot_tpu_torch import telemetry

    params, progress, _ = build_state(gb, device, gen)
    app = {"model": tts.StateDict(params), "progress": tts.StateDict(progress)}
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    configs = {
        "on": {"TSS_TORCH_RECORDER": "1", "TSS_TORCH_TELEMETRY_ARTIFACTS": "1"},
        "off": {"TSS_TORCH_RECORDER": "0", "TSS_TORCH_TELEMETRY_ARTIFACTS": "0"},
    }
    times = {k: {"take_s": [], "drain_s": [], "stall_s": []} for k in configs}
    kernels.reset_launch_counts()

    def run(name, record):
        _set_env(configs[name])
        telemetry.recorder.reset()
        path = os.path.join(root, f"ab_{name}")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        tts.Snapshot.take(path, app)
        take_s = time.monotonic() - t0
        shutil.rmtree(path)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pending = tts.Snapshot.async_take(path, app)
        stall_s = time.monotonic() - t0
        pending.wait()
        drain_s = time.monotonic() - t0 - stall_s
        has_artifact = os.path.exists(os.path.join(path, ".telemetry", "rank_0.json"))
        if has_artifact != (name == "on"):
            raise AssertionError(f"phase8 (c): artifact present {has_artifact} with telemetry {name}")
        shutil.rmtree(path)
        if record:
            times[name]["take_s"].append(take_s)
            times[name]["stall_s"].append(stall_s)
            times[name]["drain_s"].append(drain_s)

    try:
        run("off", False)  # warm-up: the prepared-take cache, the pools
        for i in range(3):
            for name in ("on", "off") if i % 2 == 0 else ("off", "on"):
                run(name, True)
    finally:
        _set_env({k: None for k in configs["on"]})
        telemetry.recorder.reset()
    launches = dict(kernels.LAUNCHES)
    summary = {"state_bytes": nbytes}
    for name, t in times.items():
        summary[name] = {
            k: {"median": statistics.median(v), "min": min(v), "max": max(v), "runs": v} for k, v in t.items()
        }
    drain_on, drain_off = summary["on"]["drain_s"]["median"], summary["off"]["drain_s"]["median"]
    summary["drain_overhead_frac"] = (drain_on - drain_off) / drain_off
    take_on, take_off = summary["on"]["take_s"]["median"], summary["off"]["take_s"]["median"]
    summary["take_overhead_frac"] = (take_on - take_off) / take_off
    log(f"phase8 (c) telemetry overhead on {card}, {nbytes} bytes, 3 interleaved pairs: {json.dumps(summary)}")
    if summary["drain_overhead_frac"] > 0.01:
        log(f"phase8 (c) WARNING: drain median with telemetry on is {summary['drain_overhead_frac'] * 100:.1f}% "
            "above off (the JAX package's fail-soft 1% gate; drains vary by tens of percent run to run here)")
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 9: QoS classes and the budget ledger; FSDP2 over TP
# ---------------------------------------------------------------------------


def _trainer_cfg(n_layers=8):
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=32000, d_model=4096, n_heads=32, n_layers=n_layers, d_ff=16384, max_seq_len=512
    )


def phase9a(seed, device, root, card, pairs=1):
    """A foreground restore of phase 4's weights (8 layers, 3.75 GB) racing
    the background drain of phase 4's trainer state (8 layers, AdamW,
    11.25 GB) in one process: ``pairs`` interleaved pairs (1, cut from 3
    and then 2 for the script's time), QoS on and ``TSS_TORCH_QOS=0``; the
    first pair under ``TSS_TORCH_DEBUG_LEDGER=1``."""
    import statistics

    from torchsnapshot_tpu_torch import dryrun, kernels

    cfg = _trainer_cfg()
    races = {"on": [], "off": []}
    launches = {"pack_slab": 0, "fork_copy": 0, "copy_blocks": 0}
    for pair in range(pairs):
        for qos in ("on", "off"):
            env = {"TSS_TORCH_QOS": "1" if qos == "on" else "0", "TSS_TORCH_DEBUG_LEDGER": "1" if pair == 0 else None}
            _set_env(env)
            try:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                kernels.reset_launch_counts()
                out = dryrun.qos_race(cfg, root, device=device, seed=seed)
                for k, v in kernels.LAUNCHES.items():
                    launches[k] += v
                out["launches"] = dict(kernels.LAUNCHES)
            finally:
                _set_env({k: None for k in env})
            if qos == "on" and out["preemptions"] < 1:
                raise AssertionError(f"phase9 (a): the drain was not preempted with QoS on: {out}")
            if qos == "off" and (out["preemptions"] != 0 or out["preempted_wait_s"] != 0):
                raise AssertionError(f"phase9 (a): the drain was preempted with TSS_TORCH_QOS=0: {out}")
            races[qos].append(out)
            log(
                f"phase9 (a) pair {pair} QoS {qos} on {card}{' (ledger on)' if pair == 0 else ''}: foreground restore "
                f"{out['restore_s']:.3f} s, {out['restore_gbps']:.3f} GB/s over {out['weights_bytes']} bytes "
                f"(started {out['restore_start_after_return_s']:.4f} s after async_take returned); drain "
                f"{out['drain_s']:.3f} s over {out['state_bytes']} bytes (still running at the restore's end: "
                f"{out['drain_running_at_restore_end']}); drain engine.preemptions {out['preemptions']}, "
                f"engine.preempted_wait_s {out['preempted_wait_s']:.4f} (summed over overlapping waiters; "
                f"paused wall {out['paused_wall_s']:.4f} s); launches {json.dumps(out['launches'])}"
            )
    summary = {}
    for qos, outs in races.items():
        summary[qos] = {
            key: {"median": statistics.median(o[key] for o in outs), "all": [o[key] for o in outs]}
            for key in ("restore_s", "restore_gbps", "drain_s", "preemptions", "preempted_wait_s", "paused_wall_s")
        }
    log(f"phase9 (a) summary on {card}: {json.dumps(summary)}")
    if launches["fork_copy"] < 1:
        raise AssertionError(f"phase9 (a): K2 did not launch: {launches}")
    return launches, summary


def phase9b_worker(rank, world_size, n_layers, seed, root, out_dir):
    from torchsnapshot_tpu_torch import dryrun

    torch.cuda.set_device(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = dryrun.fsdp_tp_checkpoints(_trainer_cfg(n_layers), root, device=torch.device("cuda", 0), seed=seed)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase9b(gb, seed, root, card):
    """FSDP2 over TP on four ranks sharing the card (gloo): the transformer
    at phase 4's width, laid out by ``parallelize_fsdp_tp`` with AdamW
    state, ~``gb`` GB; take, restore into the same layout, into
    ``Shard(0)`` over 4, and a plain take back into FSDP x TP."""
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    # bf16 parameters and two bf16 moments: 3 x 2 bytes per parameter.
    per_layer = 3 * 2 * (4096 * 3 * 4096 + 4096 * 4096 + 2 * 4096 * 16384)
    fixed = 3 * 2 * (2 * 32000 * 4096 + 512 * 4096)
    n_layers = max(1, round((gb * 1e9 - fixed) / per_layer))
    out_dir = os.path.join(root, "phase9b_out")
    os.makedirs(out_dir)
    t0 = time.monotonic()
    run_with_processes(phase9b_worker, 4, args=(n_layers, seed, root, out_dir), timeout_s=900, process_group=True)
    wall = time.monotonic() - t0
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(4)]
    launches = {}
    for r, out in enumerate(ranks):
        steps = out["steps"]
        k3 = {label: step["launches"]["copy_blocks"] for label, step in steps.items()}
        if not any(k3[label] for label in ("restore_same", "restore_plain", "restore_from_plain")):
            raise AssertionError(f"phase9 (b): K3 did not launch on rank {r}: {k3}")
        for label, step in steps.items():
            launches[f"phase9b_rank{r}_{label}"] = step["launches"]
        log(
            f"phase9 (b) rank {r} on {card} (four ranks sharing one card, gloo): {out['state_bytes']} local bytes; "
            + "; ".join(f"{label} {st['s']:.3f} s {st['gbps']:.3f} GB/s K3 {st['launches']['copy_blocks']}" for label, st in steps.items())
        )
    total = sum(o["state_bytes"] for o in ranks)
    log(
        f"phase9 (b) on {card}: {n_layers} layer(s), state {ranks[0]['global_bytes']} bytes ({total} local bytes "
        f"over 4 ranks, the dp-only leaves held by both tp ranks), strided {json.dumps(ranks[0]['strided'])}, wall {wall:.1f} s"
    )
    shutil.rmtree(os.path.join(root, "fsdp_tp"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "fsdp_tp_plain"), ignore_errors=True)
    return launches, {"layers": n_layers, "state_bytes": ranks[0]["global_bytes"], "local_bytes": total, "ranks": ranks, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 10: robustness under preemption and storage faults
# ---------------------------------------------------------------------------


def _faulted(spec, **env):
    """Environment of a faulted step: ``TSS_TORCH_FAULTS`` and extra knobs
    (None unsets one)."""
    return {"TSS_TORCH_FAULTS": spec, **env}


def _with_env(env, fn):
    saved = {k: os.environ.get(k) for k in env}
    _set_env(env)
    try:
        return fn()
    finally:
        _set_env(saved)


def _counters(tm):
    return {k: v for k, v in tm.metrics.as_dict().items() if k.startswith(("faults.", "cloud_retry.", "scheduler.read_verify"))}


def _rot_abort(e, victim):
    """The text of the root error of a world-1 restore that persistent rot
    of ``victim`` aborted (phase 10 (d)): ``CheckpointAbortedError`` of rank
    0 in ``restore.read`` from the ``ReadVerificationError`` naming it."""
    from torchsnapshot_tpu_torch import CheckpointAbortedError, ReadVerificationError

    cause = e.__cause__
    if not isinstance(e, CheckpointAbortedError) or (e.rank, e.phase) != (0, "restore.read"):
        raise AssertionError(f"phase10 (d): expected an abort of rank 0 in restore.read: {e!r}")
    if not isinstance(cause, ReadVerificationError) or victim not in str(cause):
        raise AssertionError(f"phase10 (d): the abort's cause does not name {victim}: {cause!r}")
    return str(cause)[:200]


def _restore_exact(path, params, progress, what, env=None, telemetry_session=None):
    """Restore ``path`` into zeroed CUDA tensors and hold it bit-exactly
    against ``params`` and ``progress["step"]``; returns the seconds."""
    import torchsnapshot_tpu_torch as tts

    target = {
        "model": tts.StateDict(_zeros_like_tree(params)),
        "progress": tts.StateDict(step=torch.zeros_like(progress["step"])),
    }
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _with_env(env or {}, lambda: tts.Snapshot(path).restore(target, _telemetry=telemetry_session))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    _assert_bits_equal(dict(target["model"]), params, what)
    if not torch.equal(target["progress"]["step"], progress["step"]):
        raise AssertionError(f"{what}: step")
    return wall


# The preempted child: builds phase 2's state from the seed on the card,
# takes s0 (job=), then an async_take of s1 that a `kill` fault ends.
_PHASE10_CHILD = r"""
import os, sys, json, torch
sys.path.insert(0, os.getcwd())
import chip_smoke
import torchsnapshot_tpu_torch as tts
gb, seed, bucket, kill_at, out = float(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]), sys.argv[5]
device = torch.device("cuda", 0)
gen = torch.Generator(device=device).manual_seed(seed)
params, progress, n_layers = chip_smoke.build_state(gb, device, gen)
app = {"model": tts.StateDict(params), "progress": tts.StateDict(progress)}
tts.Snapshot.take(os.path.join(bucket, "s0"), app, job="preempt", step=0)
with open(out, "w") as f:
    json.dump({"s0": "committed", "layers": n_layers}, f)
for t in chip_smoke._tensors(params):
    t.add_(1)
os.environ["TSS_TORCH_FAULTS"] = f"op=write,at={kill_at},kind=kill"
pending = tts.Snapshot.async_take(os.path.join(bucket, "s1"), app, job="preempt", step=1)
pending.wait()
raise SystemExit("the kill fault did not fire")
"""


def phase10_worker(rank, world_size, gb, seed, root, out_dir):
    """Phase 10 (e) on one of two ranks: a take that fails on rank 1, then
    a swapped-placement restore under a transient read storm on rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import kernels, telemetry
    from torchsnapshot_tpu_torch.snapshot import CheckpointAbortedError

    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mesh = DeviceMesh("cuda", list(range(world_size)))
    result = {"rank": rank, "launches": {}}
    params = tp_state(gb, seed, device, mesh, "save")
    app = {"model": tts.StateDict(params)}

    failed = os.path.join(root, "e_failed")
    dist.barrier()
    t0 = time.monotonic()
    try:
        _with_env(_faulted("op=write,rank=1,kind=fail"), lambda: tts.Snapshot.take(failed, app))
        raise AssertionError("phase10 (e): the take under op=write,rank=1,kind=fail committed")
    except CheckpointAbortedError as e:
        if e.rank != 1 or "injected write failure" not in str(e):
            raise AssertionError(f"phase10 (e): the abort does not name rank 1's injected fault: {e!r}")
        result["abort"] = {"rank": e.rank, "phase": e.phase, "s": time.monotonic() - t0}
    dist.barrier()
    if os.path.exists(os.path.join(failed, ".snapshot_metadata")):
        raise AssertionError("phase10 (e): the failed take committed")

    path = os.path.join(root, "e_tp")
    tts.Snapshot.take(path, app)
    del params, app
    target = {"model": tts.StateDict(tp_state(gb, seed, device, mesh, "swap", zeros=True))}
    tm = telemetry.Telemetry()
    dist.barrier()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    _with_env(
        _faulted("backoff=0.01;op=read,rank=0,every=2,kind=transient,times=8"),
        lambda: tts.Snapshot(path).restore(target, _telemetry=tm),
    )
    torch.cuda.synchronize()
    result["storm_restore_s"] = time.monotonic() - t0
    result["launches"]["storm_restore"] = dict(kernels.LAUNCHES)
    result["counters"] = _counters(tm)
    check_tp_state(dict(target["model"]), gb, seed, device, "swap", "phase10 (e) restore under a read storm")
    if result["launches"]["storm_restore"]["copy_blocks"] < 1:
        raise AssertionError(f"phase10 (e): K3 did not launch on rank {rank}")
    injected = result["counters"].get("faults.transient", 0)
    retried = result["counters"].get("cloud_retry.faults.retries", 0)
    if injected != retried or (injected < 1) != (rank != 0):
        raise AssertionError(f"phase10 (e): rank {rank}: {result['counters']} (the storm is rank 0's only)")
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def phase10(gb, tp_gb, seed, device, root, card):
    """Robustness on the card: (a) a transient storm, (b) a permanent fault
    under ``async_take``, (c) a preempted child, (d) bit rot, (e) two ranks,
    (f) the crash explorer over continuous checkpointing."""
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import catalog, crash_explorer, effect_journal, kernels, telemetry
    from torchsnapshot_tpu_torch.snapshot import CheckpointAbortedError
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    out = {"walls": {}}
    launches = {}

    def step(name, fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        out["walls"][name] = time.monotonic() - t0
        launches[f"phase10_{name}"] = dict(kernels.LAUNCHES)
        log(f"phase10 ({name}) on {card}: {out['walls'][name]:.1f} s, launches {json.dumps(kernels.LAUNCHES)}: {json.dumps(res)}")
        return res

    gen = torch.Generator(device=device).manual_seed(seed)
    params, progress, n_layers = build_state(gb, device, gen)
    app = {"model": tts.StateDict(params), "progress": tts.StateDict(progress)}
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))

    # (a) A storm of transient write faults: every third write fails once
    # (six times), retried through cloud_retry. Whole-object writes: an
    # injected append fault is not retried by either package (an append
    # may have moved bytes), so the schedule's append rule stays inert here.
    spec_a = "seed=0;backoff=0.01;op=write,every=3,kind=transient,times=6;op=append,at=1,kind=transient"
    path_a = os.path.join(root, "a")

    def a():
        tm = telemetry.Telemetry()
        t0 = time.monotonic()
        _with_env(_faulted(spec_a, TSS_TORCH_STREAM_WRITES="off"), lambda: tts.Snapshot.take(path_a, app, _telemetry=tm))
        take_s = time.monotonic() - t0
        got = _counters(tm)
        k1 = kernels.LAUNCHES["pack_slab"]
        if got.get("faults.transient") != 6 or got.get("cloud_retry.faults.retries") != 6:
            raise AssertionError(f"phase10 (a): expected 6 injected and 6 retried transients, got {got}")
        if k1 < 1:
            raise AssertionError("phase10 (a): K1 did not launch")
        if tts.Snapshot(path_a).verify():
            raise AssertionError("phase10 (a): verify")
        restore_s = _restore_exact(path_a, params, progress, "phase10 (a) restore")
        return {"bytes": nbytes, "take_s": take_s, "take_gbps": nbytes / take_s / 1e9, "restore_s": restore_s, "counters": got, "k1": k1}

    out["a"] = step("a", a)

    # (b) A permanent fault under async_take: wait() raises the structured
    # abort, nothing commits, the ledger balances, the fork is given back.
    path_b = os.path.join(root, "b")

    def b():
        import gc

        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(device)
        t0 = time.monotonic()

        def run():
            # Only the abort's fields leave this frame: its traceback would
            # keep the pending take, and with it the fork, alive.
            pending = tts.Snapshot.async_take(path_b, app)
            stall = time.monotonic() - t0
            try:
                pending.wait()
            except CheckpointAbortedError as e:
                return stall, {"rank": e.rank, "phase": e.phase, "detail": e.detail[:300], "text": str(e)}
            raise AssertionError("phase10 (b): the async_take under op=write,at=2,kind=fail committed")

        stall, abort = _with_env(_faulted("op=write,at=2,kind=fail", TSS_TORCH_DEBUG_LEDGER="1"), run)
        k2 = kernels.LAUNCHES["fork_copy"]
        if abort["rank"] != 0 or "injected write failure" not in abort["text"] or "LedgerLeak" in abort["text"]:
            raise AssertionError(f"phase10 (b): unexpected abort {abort}")
        if os.path.exists(os.path.join(path_b, ".snapshot_metadata")):
            raise AssertionError("phase10 (b): .snapshot_metadata was written")
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(device)
        if after > before + (64 << 20):
            raise AssertionError(f"phase10 (b): the fork was not given back: {before} -> {after} bytes allocated")
        if k2 < 1:
            raise AssertionError("phase10 (b): K2 did not launch")
        restore_s = _restore_exact(path_a, params, progress, "phase10 (b) previous snapshot")
        abort.pop("text")
        return {"abort": abort, "stall_s": stall,
                "wait_s": time.monotonic() - t0, "allocated_before": before, "allocated_after": after,
                "k2": k2, "previous_restore_s": restore_s}

    out["b"] = step("b", b)
    shutil.rmtree(path_a)
    shutil.rmtree(path_b, ignore_errors=True)

    # (c) Preemption mid-checkpoint, in a spawned child on the card.
    bucket = os.path.join(root, "preempt")
    os.makedirs(bucket)

    def c():
        from torchsnapshot_tpu_torch.faults import KILL_EXIT_CODE

        info = os.path.join(root, "child.json")
        env = {k: v for k, v in os.environ.items() if k != "TSS_TORCH_FAULTS"}
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-c", _PHASE10_CHILD, str(gb), str(seed), bucket, "4", info],
            env=env, capture_output=True, text=True, timeout=300,
        )
        child_s = time.monotonic() - t0
        if proc.returncode != KILL_EXIT_CODE:
            raise AssertionError(f"phase10 (c): the child exited {proc.returncode}, not {KILL_EXIT_CODE}: {proc.stderr[-3000:]}")
        with open(info) as f:
            json.load(f)
        if os.path.exists(os.path.join(bucket, "s1", ".snapshot_metadata")):
            raise AssertionError("phase10 (c): s1 committed")
        with catalog.Catalog(bucket) as cat:
            latest = cat.latest("preempt")
        if latest is None or latest.name != "s0":
            raise AssertionError(f"phase10 (c): the catalog's latest is {latest}")
        debris = sorted(os.path.relpath(os.path.join(d, n), bucket) for d, _, ns in os.walk(os.path.join(bucket, "s1")) for n in ns)
        first = tts.Snapshot.gc(bucket, dry_run=False)
        second = tts.Snapshot.gc(bucket, dry_run=False)
        if len(first["remove"]) < 1 or second["remove"]:
            raise AssertionError(f"phase10 (c): gc did not converge: {first['remove']} then {second['remove']}")
        if first["committed"] != ["s0"] or sorted(first["remove"]) != debris:
            raise AssertionError(f"phase10 (c): gc removed {first['remove']}, the debris is {debris}")
        restore_s = _restore_exact(os.path.join(bucket, "s0"), params, progress, "phase10 (c) s0 after the kill")
        return {"child_s": child_s, "exit": proc.returncode, "debris": len(debris), "gc_removed": len(first["remove"]),
                "gc_again_removed": len(second["remove"]), "latest": latest.name, "s0_restore_s": restore_s}

    out["c"] = step("c", c)

    # (d) Bit rot under verified reads: one corrupt read heals by one
    # re-fetch; an object that rots on every read fails the restore.
    s0 = os.path.join(bucket, "s0")

    def d():
        tm = telemetry.Telemetry()
        heal_s = _restore_exact(
            s0, params, progress, "phase10 (d) healed restore",
            env=_faulted("op=read,at=2,kind=corrupt,bytes=8", TSS_TORCH_VERIFY_READS="all"), telemetry_session=tm,
        )
        got = _counters(tm)
        if got.get("faults.corrupt") != 1 or got.get("scheduler.read_verify_failures") != 1:
            raise AssertionError(f"phase10 (d): expected one corrupt read healed by one re-fetch, got {got}")
        victim = "0/model/layer_0/up"
        try:
            _restore_exact(s0, params, progress, "phase10 (d) persistent rot",
                           env=_faulted(f"op=read,after=0,kind=corrupt,path={victim}", TSS_TORCH_VERIFY_READS="all"))
            raise AssertionError("phase10 (d): a persistently rotten object restored")
        except CheckpointAbortedError as e:
            err = _rot_abort(e, victim)
        # A world-1 sync take under a permanent write fault aborts wrapped.
        path_w = os.path.join(bucket, "w")

        def take_failing():
            try:
                tts.Snapshot.take(path_w, app)
            except CheckpointAbortedError as e:
                return {"rank": e.rank, "phase": e.phase, "cause": type(e.__cause__).__name__, "text": str(e)[:200]}
            raise AssertionError("phase10 (d): the sync take under op=write,at=2,kind=fail committed")

        t0 = time.monotonic()
        take_abort = _with_env(_faulted("op=write,at=2,kind=fail"), take_failing)
        take_abort["wall_s"] = time.monotonic() - t0
        if (take_abort["rank"], take_abort["phase"], take_abort["cause"]) != (0, "write", "InjectedFault"):
            raise AssertionError(f"phase10 (d): unexpected sync-take abort {take_abort}")
        if os.path.exists(os.path.join(path_w, ".snapshot_metadata")):
            raise AssertionError("phase10 (d): the aborted sync take wrote .snapshot_metadata")
        shutil.rmtree(path_w, ignore_errors=True)
        return {"heal_restore_s": heal_s, "counters": got, "persistent": err, "sync_take_abort": take_abort}

    out["d"] = step("d", d)
    del app, params, progress
    shutil.rmtree(bucket)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (e) Two ranks on the card (gloo), phase 3's TP state.
    def e():
        out_dir = os.path.join(root, "phase10_out")
        os.makedirs(out_dir)
        run_with_processes(phase10_worker, 2, args=(tp_gb, seed, root, out_dir), timeout_s=600, process_group=True)
        ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(2)]
        for r in ranks:
            launches[f"phase10_e_rank{r['rank']}"] = r["launches"]["storm_restore"]
        shutil.rmtree(os.path.join(root, "e_tp"), ignore_errors=True)
        shutil.rmtree(os.path.join(root, "e_failed"), ignore_errors=True)
        return ranks

    out["e"] = step("e", e)

    # (f) The crash explorer over journaled continuous checkpointing: phase
    # 2's widths at one layer (the depth cut so that every prefix's verify
    # and gc fit the phase).
    def f():
        gen_f = torch.Generator(device=device).manual_seed(seed + 10)
        one, prog, layers = build_state(0.369, device, gen_f)
        if layers != 1:
            raise AssertionError(f"phase10 (f): {layers} layers")
        appf = {"model": tts.StateDict(one), "progress": tts.StateDict(prog)}
        fbucket = os.path.join(root, "explore_bucket")
        t1 = {k: v.clone() for k, v in one["layer_0"].items()}
        step1 = prog["step"].clone()

        def journaled():
            effect_journal.reset()
            try:
                tts.Snapshot.take(os.path.join(fbucket, "t1"), appf, job="ft", step=1)
                # t2: the LayerNorm weights and the step move, the rest is
                # linked from t1.
                one["layer_0"]["ln1_w"].add_(1)
                prog["step"].add_(1)
                tts.Snapshot.take(os.path.join(fbucket, "t2"), appf, job="ft", step=2)
                catalog.retain(fbucket, catalog.RetentionPolicy.parse("last=1"), dry_run=False)
                tts.Snapshot.gc(fbucket, dry_run=False)
                return effect_journal.get_journal().effects()
            finally:
                effect_journal.reset()

        t0 = time.monotonic()
        effects = _with_env({"TSS_TORCH_DEBUG_EFFECTS": "1", "TSS_TORCH_DEDUP_DIGESTS": "1"}, journaled)
        journal_s = time.monotonic() - t0
        want = {"t1": ({"layer_0": t1}, step1), "t2": (one, prog["step"])}
        checked = []

        def restore_check(snap_root):
            name = os.path.basename(snap_root)
            tree, stp = want[name]
            _restore_exact(snap_root, tree, {"step": stp}, f"phase10 (f) {name} in a crash state")
            checked.append(name)

        # The explorer copies the crash state once per prefix: in host RAM
        # where there is room for it.
        shm = "/dev/shm"
        fast = os.path.isdir(shm) and shutil.disk_usage(shm).free > 8 * 2**30
        workdir = tempfile.mkdtemp(prefix="tss_explore_", dir=shm if fast else root)
        t0 = time.monotonic()
        report = crash_explorer.explore(effects, workdir, seed=seed, interior_samples=2, restore_check=restore_check)
        explore_s = time.monotonic() - t0
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(fbucket, ignore_errors=True)
        if not report.ok or report.prefixes != len(effects) or report.interior_samples != 2:
            raise AssertionError(f"phase10 (f): {report.render()}")
        ops = {}
        for eff in effects:
            ops[eff.op] = ops.get(eff.op, 0) + 1
        return {"effects": len(effects), "ops": ops, "journal_bytes": sum(eff.nbytes for eff in effects),
                "prefixes": report.prefixes, "interior_samples": report.interior_samples,
                "violations": len(report.violations), "restore_checks": len(checked),
                "journal_s": journal_s, "explore_s": explore_s, "workdir_fs": "tmpfs /dev/shm" if fast else "the temp root"}

    out["f"] = step("f", f)
    return launches, out


# ---------------------------------------------------------------------------
# Phase 11: the capture and transfer controls on the trainer
# ---------------------------------------------------------------------------


def _rss_kib():
    """(resident KiB now, peak resident KiB, where the peak came from):
    ``VmRSS`` and ``VmHWM`` of ``/proc/self/status`` where the kernel
    reports them, else ``/proc/self/statm`` and ``getrusage``'s
    ``ru_maxrss`` (the same peak, in KiB on Linux)."""
    import resource

    fields = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key in ("VmRSS", "VmHWM") and rest.split():
                fields[key] = int(rest.split()[0])
    if "VmRSS" in fields:
        now = fields["VmRSS"]
    else:
        with open("/proc/self/statm") as f:
            now = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") // 1024
    if "VmHWM" in fields:
        return now, fields["VmHWM"], "VmHWM"
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss, "ru_maxrss"


def phase11d_child(path, seed, layers, overlap, out_path):
    """Phase 11 (d) in a fresh process (forked from a server that has
    imported torch and the port, so each restore starts in seconds): a
    fresh model's live CUDA tensors and the AdamW state as a plain state
    dict restored from ``path`` with ``TSS_TORCH_RESTORE_OVERLAP`` =
    ``overlap``, every tensor held against its seeded value; the rate and
    the process's resident-set peak above its start (``VmRSS`` sampled
    every 5 ms) go to ``out_path`` as JSON."""
    import traceback

    try:
        os.environ["TSS_TORCH_RESTORE_OVERLAP"] = overlap
        import torchsnapshot_tpu_torch as tts
        from torchsnapshot_tpu_torch import dryrun, scheduler
        from torchsnapshot_tpu_torch.utils.rss_profiler import measure_rss_deltas

        t_start = time.monotonic()
        device = torch.device("cuda", 0)
        model = dryrun.init_params(_trainer_cfg(layers), seed=seed + 5, device=device)
        # State i belongs to the model's i-th parameter, as in AdamW.
        moments = {
            i: {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
            for i, (_, p) in enumerate(model.named_parameters())
        }
        optim = tts.StateDict(state=moments, param_groups=[])
        torch.cuda.synchronize()
        rss_before, hwm_before, _ = _rss_kib()
        deltas = []
        t0 = time.monotonic()
        with measure_rss_deltas(deltas, interval_ms=5.0):
            tts.Snapshot(path).restore({"model": model, "optim": optim})
            torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        _, hwm, source = _rss_kib()
        host = torch.cuda.host_memory_stats()
        nbytes = 0
        for i, (name, p) in enumerate(model.named_parameters()):
            for label, t in ((name, p), (name + "/exp_avg", moments[i]["exp_avg"]), (name + "/exp_avg_sq", moments[i]["exp_avg_sq"])):
                if not dryrun.same_bits(t, dryrun.seeded_global(label, t.shape, t.dtype, seed, device)):
                    raise AssertionError(f"phase11 (d) restore: {label} differs from its seeded value")
                nbytes += t.numel() * t.element_size()
            if float(optim["state"][i]["step"]) != float(seed):
                raise AssertionError(f"phase11 (d) restore: {name}/step")
        out = {
            "restore_s": restore_s, "gbps": nbytes / restore_s / 1e9, "state_bytes": nbytes,
            "rss_before_kib": rss_before, "peak_rss_before_kib": hwm_before, "peak_rss_kib": hwm,
            "peak_rss_source": source, "rss_peak_above_start_bytes": max(deltas), "rss_samples": len(deltas),
            "pinned_peak_bytes": host.get("allocated_bytes.peak", 0),
            "budget_bytes": scheduler.get_process_memory_budget_bytes(None),
            "child_targets_s": t0 - t_start,
        }
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase11d_restores(path_d, seed, n_layers, root, card, pairs):
    """Phase 11 (d)'s ``pairs`` pairs of restores of ``path_d``, overlap
    on and off, each in a fresh child process (:func:`phase11d_child`)."""
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch._dynamo", "torchsnapshot_tpu_torch.dryrun"])
    restores = {"on": [], "off": []}
    for pair in range(pairs):
        for mode in ("on", "off"):
            out_path = os.path.join(root, f"p11d_{pair}_{mode}.json")
            t_child = time.monotonic()
            proc = ctx.Process(
                target=phase11d_child, args=(path_d, seed, n_layers, "1" if mode == "on" else "0", out_path)
            )
            proc.start()
            proc.join(600)
            if proc.is_alive():
                proc.kill()
                proc.join()
                raise AssertionError("phase11 (d): a restore child did not end within 600 s")
            if proc.exitcode != 0 or not os.path.exists(out_path):
                raise AssertionError(f"phase11 (d): a restore child exited {proc.exitcode}")
            with open(out_path) as f:
                out = json.load(f)
            if "error" in out:
                raise AssertionError(f"phase11 (d) child failed: {out['error'][-3000:]}")
            out["child_wall_s"] = time.monotonic() - t_child
            restores[mode].append(out)
            log(f"phase11 (d) pair {pair} overlap {mode} on {card}: {json.dumps(out)}")
    _stop_forkserver()
    return restores


def phase11e_worker(rank, world_size, gb, seed, root, out_dir):
    """Phase 11 (e) on one of two ranks sharing the card: phase 3's TP
    state taken, then restored with swapped placements under overlapped
    restore (K3 per read); the budget and the fs I/O cap come from the
    hostname gather (``LOCAL_WORLD_SIZE`` withheld)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import kernels, scheduler
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.utils import knobs

    os.environ.pop("LOCAL_WORLD_SIZE", None)
    knobs._local_world_size = None
    os.environ["TSS_TORCH_RESTORE_OVERLAP"] = "1"
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mesh = DeviceMesh("cuda", list(range(world_size)))
    params = tp_state(gb, seed, device, mesh, "save")
    path = os.path.join(root, "p11e")
    tts.Snapshot.take(path, {"model": tts.StateDict(params)})
    del params
    mem_available = scheduler._mem_available_bytes()
    result = {
        "rank": rank,
        "local_world_size": knobs.get_local_world_size(),
        "mem_available_bytes": mem_available,
        "budget_bytes": scheduler.get_process_memory_budget_bytes(None),
        "fs_io_cap": knobs.get_max_concurrent_io_for(FSStoragePlugin(root=path)),
        "direct_io_concurrency": knobs.get_direct_io_concurrency(),
    }
    target = {"model": tts.StateDict(tp_state(gb, seed, device, mesh, "swap", zeros=True))}
    dist.barrier()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    tts.Snapshot(path).restore(target)
    torch.cuda.synchronize()
    result["reshard_restore_s"] = time.monotonic() - t0
    result["launches"] = dict(kernels.LAUNCHES)
    check_tp_state(dict(target["model"]), gb, seed, device, "swap", "phase11 (e) overlapped reshard restore")
    result["reshard_restore_gbps"] = _tensor_bytes(dict(target["model"])) / result["reshard_restore_s"] / 1e9
    dist.barrier()
    if rank == 0:
        shutil.rmtree(path)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def phase11(seed, device, root, card, n_layers=8, tp_gb=2.0, pairs=1):
    """The capture and transfer controls on phase 4's trainer (``n_layers``
    layers, AdamW): (a) eager D2H on and off, (b) ``donate``, (c) the HBM
    cap at half the state, (d) overlapped restore on and off in fresh
    processes, (e) two ranks at phase 3's depth. (a) and (d) run
    ``pairs`` alternating on/off pairs."""
    import statistics

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import dryrun, io_preparer, kernels, telemetry
    from torchsnapshot_tpu_torch.test_utils import run_with_processes
    from torchsnapshot_tpu_torch.tricks.train_state import init_optimizer_state

    cfg = _trainer_cfg(n_layers)
    launches = {}
    summary = {"layers": n_layers, "walls_s": {}}
    step_no = [0]
    t_mark = [time.monotonic(), "setup"]

    def mark(name):
        now = time.monotonic()
        summary["walls_s"][t_mark[1]] = round(now - t_mark[0], 1)
        t_mark[:] = [now, name]

    def tokens():
        step_no[0] += 1
        return dryrun.tokens_for_step(cfg, step_no[0], 4, seed, device)

    def drive(label, fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[label] = dict(kernels.LAUNCHES)
        return out

    def run(fn):
        return dryrun._deterministic(fn)

    model = dryrun.init_params(cfg, seed=seed, device=device)
    optimizer = dryrun.adamw(model.parameters())
    app = {"model": model, "optim": optimizer}
    run(lambda: dryrun.train_step(model, optimizer, tokens()))
    state = dryrun.train_state_tensors(model, optimizer)
    nbytes = dryrun._state_bytes(state)
    summary["state_bytes"], summary["n_tensors"] = nbytes, len(state)
    log(f"phase11 state on {card}: {n_layers} layers, {len(state)} tensors, {nbytes} bytes")
    model2 = dryrun.init_params(cfg, seed=seed + 1, device=device)
    optimizer2 = init_optimizer_state(dryrun.adamw(model2.parameters()))
    app2 = {"model": model2, "optim": optimizer2}

    def restore_into_2(path, what):
        t0 = time.monotonic()
        tts.Snapshot(path).restore(app2)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    # (a) eager D2H on against off, alternating pairs, fork capture.
    mark("a")
    alone = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        run(lambda: dryrun.train_step(model, optimizer, tokens()))
        torch.cuda.synchronize()
        alone.append(time.monotonic() - t0)
    runs = {"on": [], "off": []}
    for pair in range(pairs):
        for mode in ("on", "off"):
            check = pair == pairs - 1
            path = os.path.join(root, f"p11a_{mode}_{pair}")
            copy = [t.detach().clone() for _, t in state] if check else None

            def one():
                tm = telemetry.Telemetry()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
                t0 = time.monotonic()
                pending = tts.Snapshot.async_take(path, app, _telemetry=tm)
                stall = time.monotonic() - t0
                hbm = torch.cuda.max_memory_allocated(device) - base
                racing, racing_tokens = [], []
                allocs0 = dryrun._allocations(device)
                for _ in range(2):
                    tk = tokens()
                    racing_tokens.append(tk)
                    t1 = time.monotonic()
                    run(lambda: dryrun.train_step(model, optimizer, tk))
                    torch.cuda.synchronize()
                    racing.append(time.monotonic() - t1)
                allocs1 = dryrun._allocations(device)
                pending.wait()
                drain = time.monotonic() - t0 - stall
                d2h_spans = [sp for sp in tm.spans() if sp.name == "stage.d2h"]
                return {
                    "stall_s": stall, "drain_s": drain, "racing_step_s": racing, "hbm_overhead_bytes": hbm,
                    "stage_d2h_busy_s": dryrun._union_s(tm.spans(), ("stage.d2h",)),
                    "stage_d2h_bytes": sum(sp.attrs.get("nbytes", 0) for sp in d2h_spans),
                    "drain_stage_d2h_s": pending.drain_stats.get("stage_d2h_s"),
                    "phases": {k: round(v, 4) for k, v in tts.snapshot.LAST_TAKE_PHASES.items()},
                    "racing_host_allocs": allocs1["host_allocs"] - allocs0["host_allocs"],
                    "racing_host_alloc_us": allocs1["host_alloc_us"] - allocs0["host_alloc_us"],
                }, racing_tokens

            out, racing_tokens = _with_env(
                {"TSS_TORCH_ASYNC_EAGER_D2H": "1" if mode == "on" else "0"},
                lambda: drive(f"phase11_a_{mode}_{pair}", one),
            )
            if out["stage_d2h_bytes"] < nbytes - 1024:  # the CPU step counters cross no D2H
                raise AssertionError(f"phase11 (a): stage.d2h covers {out['stage_d2h_bytes']} of {nbytes} bytes")
            if launches[f"phase11_a_{mode}_{pair}"]["fork_copy"] != 1:
                raise AssertionError(f"phase11 (a): K2 must launch once: {launches}")
            if check:
                # The snapshot is the state at the take, bit for bit; resumed
                # from it, the racing steps give the same state again.
                out["restore_s"] = restore_into_2(path, "a")
                dryrun._check_same_state(
                    dryrun.train_state_tensors(model2, optimizer2),
                    [(n, c) for (n, _), c in zip(state, copy)], f"phase11 (a) eager {mode} restore",
                )
                del copy
                for tk in racing_tokens:
                    run(lambda tk=tk: dryrun.train_step(model2, optimizer2, tk))
                dryrun._check_same_state(
                    dryrun.train_state_tensors(model2, optimizer2), dryrun.train_state_tensors(model, optimizer),
                    f"phase11 (a) eager {mode} resume",
                )
            shutil.rmtree(path)
            runs[mode].append(out)
            log(f"phase11 (a) pair {pair} eager D2H {mode} on {card}: {json.dumps(out)}")
    summary["a"] = {
        "step_alone_s": alone,
        **{
            mode: {key: statistics.median(o[key] for o in outs) for key in ("stall_s", "drain_s", "stage_d2h_busy_s", "hbm_overhead_bytes")}
            | {"racing_step_s": [o["racing_step_s"] for o in outs]}
            for mode, outs in runs.items()
        },
    }
    log(f"phase11 (a) summary on {card}: {json.dumps(summary['a'])}")

    # (b) donate: a kept promise commits; a broken one fails the take.
    mark("b")
    path_b1, path_b2 = os.path.join(root, "p11b_kept"), os.path.join(root, "p11b_broken")

    def kept():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.monotonic()
        pending = tts.Snapshot.async_take(path_b1, app)
        stall = time.monotonic() - t0
        at_return = torch.cuda.max_memory_allocated(device) - base
        pending.wait()
        return {"stall_s": stall, "drain_s": time.monotonic() - t0 - stall, "hbm_overhead_bytes": at_return,
                "hbm_overhead_through_drain_bytes": torch.cuda.max_memory_allocated(device) - base}

    b1 = _with_env({"TSS_TORCH_ASYNC_CAPTURE": "donate"}, lambda: drive("phase11_b_kept", kept))
    if launches["phase11_b_kept"]["fork_copy"] != 0:
        raise AssertionError(f"phase11 (b): donate launched K2: {launches['phase11_b_kept']}")
    b1["restore_s"] = restore_into_2(path_b1, "b")
    dryrun._check_same_state(dryrun.train_state_tensors(model2, optimizer2), state, "phase11 (b) donate restore")

    def broken():
        # The card sleeps before the capture point: every copy waits, so the
        # step's in-place updates are enqueued before any copy ends.
        torch.cuda._sleep(3_000_000_000)
        t0 = time.monotonic()
        pending = tts.Snapshot.async_take(path_b2, app2)
        stall = time.monotonic() - t0
        run(lambda: dryrun.train_step(model2, optimizer2, tokens()))
        try:
            pending.wait()
        except tts.snapshot.CheckpointAbortedError as e:
            return {"stall_s": stall, "raised": type(e).__name__, "detail": str(e)[:300]}
        raise AssertionError("phase11 (b): a broken donate promise committed")

    b2 = _with_env({"TSS_TORCH_ASYNC_CAPTURE": "donate"}, lambda: drive("phase11_b_broken", broken))
    if "changed in place" not in b2["detail"] or os.path.exists(os.path.join(path_b2, ".snapshot_metadata")):
        raise AssertionError(f"phase11 (b): the broken promise did not fail the take as it should: {b2}")
    b2["previous_restore_s"] = restore_into_2(path_b1, "b previous")
    dryrun._check_same_state(dryrun.train_state_tensors(model2, optimizer2), state, "phase11 (b) previous snapshot")
    shutil.rmtree(path_b1)
    shutil.rmtree(path_b2, ignore_errors=True)
    summary["b"] = {"kept": b1, "broken": b2, "fork_hbm_overhead_bytes": summary["a"]["on"]["hbm_overhead_bytes"]}
    log(f"phase11 (b) donate on {card}: kept {json.dumps(b1)}; broken {json.dumps(b2)}; fork HBM overhead (a) {summary['b']['fork_hbm_overhead_bytes']} bytes")

    # (c) the HBM cap at half the state.
    mark("c")
    path_c = os.path.join(root, "p11c")
    before = dict(io_preparer.HOST_CAPTURED)

    def capped():
        t0 = time.monotonic()
        pending = tts.Snapshot.async_take(path_c, app)
        stall = time.monotonic() - t0
        pending.wait()
        return {"stall_s": stall, "drain_s": time.monotonic() - t0 - stall}

    c = _with_env({"TSS_TORCH_ASYNC_FORK_HBM_LIMIT_BYTES": str(nbytes // 2)}, lambda: drive("phase11_c", capped))
    c["captured_leaves"] = io_preparer.HOST_CAPTURED["leaves"] - before["leaves"]
    c["captured_bytes"] = io_preparer.HOST_CAPTURED["bytes"] - before["bytes"]
    cuda_leaves = sum(1 for _, t in state if t.is_cuda)
    cuda_bytes = sum(t.numel() * t.element_size() for _, t in state if t.is_cuda)
    c["forked_leaves"], c["forked_bytes"] = cuda_leaves - c["captured_leaves"], cuda_bytes - c["captured_bytes"]
    if not (0 < c["captured_leaves"] < cuda_leaves and c["forked_bytes"] <= nbytes // 2):
        raise AssertionError(f"phase11 (c): the capped fork did not split: {c}")
    if launches["phase11_c"]["fork_copy"] < 1:
        raise AssertionError(f"phase11 (c): K2 did not launch: {launches['phase11_c']}")
    c["restore_s"] = restore_into_2(path_c, "c")
    dryrun._check_same_state(dryrun.train_state_tensors(model2, optimizer2), state, "phase11 (c) capped restore")
    shutil.rmtree(path_c)
    summary["c"] = c
    log(f"phase11 (c) HBM cap {nbytes // 2} bytes on {card}: {json.dumps(c)}")

    # (d) overlapped restore on and off, each in a fresh process.
    mark("d")
    path_d = os.path.join(root, "p11d")
    dryrun.fill_from_seed(model, optimizer, seed)
    drive("phase11_d_take", lambda: tts.Snapshot.take(path_d, app))
    del model, optimizer, model2, optimizer2, app, app2, state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    restores = phase11d_restores(path_d, seed, n_layers, root, card, pairs)
    shutil.rmtree(path_d)
    summary["d"] = {
        mode: {key: statistics.median(o[key] for o in outs) for key in ("gbps", "rss_peak_above_start_bytes", "peak_rss_kib", "pinned_peak_bytes")}
        | {"gbps_all": [o["gbps"] for o in outs], "rss_peak_above_start_bytes_all": [o["rss_peak_above_start_bytes"] for o in outs],
           "peak_rss_source": outs[0]["peak_rss_source"]}
        for mode, outs in restores.items()
    }
    log(f"phase11 (d) summary on {card}: {json.dumps(summary['d'])}")

    # (e) two ranks at phase 3's depth.
    mark("e")
    out_dir = os.path.join(root, "p11e_out")
    os.makedirs(out_dir)
    run_with_processes(phase11e_worker, 2, args=(tp_gb, seed, root, out_dir), timeout_s=600, process_group=True)
    summary["e"] = []
    for rank in range(2):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            r = json.load(f)
        launches[f"phase11_e_rank{rank}"] = r["launches"]
        if r["local_world_size"] != 2 or r["fs_io_cap"] != 8 or r["launches"]["copy_blocks"] < 1:
            raise AssertionError(f"phase11 (e) rank {rank}: {r}")
        want = int(r["mem_available_bytes"] * 0.6 / 2)
        if not 0.8 * want <= r["budget_bytes"] <= 1.2 * want and r["budget_bytes"] != 32 * 1024**3:
            raise AssertionError(f"phase11 (e) rank {rank}: budget {r['budget_bytes']} against 0.6 x MemAvailable / 2 = {want}")
        summary["e"].append(r)
        log(f"phase11 (e) rank {rank} on {card}: {json.dumps(r)}")
    mark("end")
    log(f"phase11 walls on {card}: {json.dumps(summary['walls_s'])}")
    log(f"phase11 launches on {card}: {json.dumps(launches)}")
    return launches, summary


# Phase 12: K1 under a real out-of-memory
# ---------------------------------------------------------------------------

# Device memory the cap leaves above the live state: room for the largest
# slab member of phase 2's widths (a layer's attn, 96 MiB) and K1's
# descriptor table (a 2 MiB segment), none for its slab (attn and the
# layer's small tensors, 96 MiB + 120 KiB, which the caching allocator
# rounds up to 98 MiB) and the table.
PHASE12_HEADROOM_BYTES = 99 << 20


def _slabs_of(snap):
    return {
        e.location for e in snap.get_manifest().values()
        if getattr(e, "byte_range", None) is not None and e.location.startswith("batched/")
    }


def phase12_child(seed, root, out_path, n_layers=4):
    """Phase 12 in a process of its own (the allocator's cap and the
    segments it leaves cached would bind every later phase): phase 2's
    widths at ``n_layers`` layers; with the caching allocator capped
    between the largest slab member and its slab, a sync take and a
    ``donate`` ``async_take`` must commit with every slab packed by K1 in
    groups, one warning per slab; with the cap lifted both restore
    bit-exactly and verify, and an uncapped take (one K1 launch per slab)
    holds the same bytes for every slab member, read back by
    ``read_object``. The result goes to ``out_path`` as JSON."""
    import logging
    import traceback

    try:
        import torchsnapshot_tpu_torch as tts
        from torchsnapshot_tpu_torch import kernels

        seed, n_layers = int(seed), int(n_layers)
        device = torch.device("cuda", 0)
        kernels.load_library()
        warned = []

        class _Warnings(logging.Handler):
            def emit(self, record):
                warned.append(record.getMessage())

        logging.getLogger("torchsnapshot_tpu_torch.batcher").addHandler(_Warnings(logging.WARNING))
        gen = torch.Generator(device=device).manual_seed(seed)
        params, progress, _ = build_state(0.0, device, gen, n_layers=n_layers)
        app = {"model": tts.StateDict(params), "progress": tts.StateDict(progress)}
        state_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
        largest = params["layer_0"]["attn"].numel() * params["layer_0"]["attn"].element_size()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        live = torch.cuda.memory_reserved(device)
        total = torch.cuda.get_device_properties(device).total_memory
        cap = live + PHASE12_HEADROOM_BYTES
        torch.cuda.set_per_process_memory_fraction(cap / total, device)
        # The cap's window: the largest member and a table fit, a slab of
        # it (one more small tensor) and a table do not. Probed on a stream
        # of their own, as K1 allocates on a lane's stream, where the
        # state's small segments have no room to lend.
        with torch.cuda.stream(torch.cuda.Stream(device)):
            probe = [torch.empty(largest, dtype=torch.uint8, device=device)]
            probe.append(torch.empty(64, dtype=torch.uint8, device=device))
            del probe
            torch.cuda.empty_cache()
            try:
                probe = [torch.empty(largest + (64 << 10), dtype=torch.uint8, device=device)]
                probe.append(torch.empty(64, dtype=torch.uint8, device=device))
                raise AssertionError("phase12: a slab fits under the cap")
            except torch.cuda.OutOfMemoryError:
                probe = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        paths = {name: os.path.join(root, name) for name in ("sync", "donate", "uncapped")}
        walls, capped, warnings, slabs = {}, {}, {}, {}
        for name in ("sync", "donate"):
            kernels.reset_launch_counts()
            del warned[:]
            t0 = time.monotonic()
            if name == "sync":
                tts.Snapshot.take(paths[name], app)
            else:
                os.environ["TSS_TORCH_ASYNC_CAPTURE"] = "donate"
                try:
                    pending = tts.Snapshot.async_take(paths[name], app)
                    walls["donate_stall_s"] = time.monotonic() - t0
                    pending.wait()
                finally:
                    del os.environ["TSS_TORCH_ASYNC_CAPTURE"]
            walls[f"{name}_take_s"] = time.monotonic() - t0
            capped[name], warnings[name] = dict(kernels.LAUNCHES), len(warned)
            slabs[name] = len(_slabs_of(tts.Snapshot(paths[name])))
        peak_reserved = torch.cuda.max_memory_reserved(device)
        torch.cuda.set_per_process_memory_fraction(1.0, device)
        for name in ("sync", "donate"):
            if not slabs[name] or warnings[name] != slabs[name] or capped[name]["pack_slab"] <= slabs[name]:
                raise AssertionError(
                    f"phase12: the capped {name} take did not pack every slab in groups: {slabs[name]} slabs, "
                    f"{warnings[name]} warnings, launches {capped[name]}"
                )
        if peak_reserved > cap:
            raise AssertionError(f"phase12: {peak_reserved} bytes reserved under a cap of {cap}")
        for name in ("sync", "donate"):
            t0 = time.monotonic()
            _restore_exact(paths[name], params, progress, f"phase12 {name} restore")
            walls[f"{name}_restore_s"] = time.monotonic() - t0
            if tts.Snapshot(paths[name]).verify() != {}:
                raise AssertionError(f"phase12: the {name} snapshot does not verify")
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        tts.Snapshot.take(paths["uncapped"], app)
        walls["uncapped_take_s"] = time.monotonic() - t0
        uncapped = dict(kernels.LAUNCHES)
        slabs["uncapped"] = len(_slabs_of(tts.Snapshot(paths["uncapped"])))
        if uncapped["pack_slab"] != slabs["uncapped"]:
            raise AssertionError(f"phase12: the uncapped take's K1 launches {uncapped} are not one per slab")
        members = sorted(
            p for p, e in tts.Snapshot(paths["uncapped"]).get_manifest().items()
            if getattr(e, "byte_range", None) is not None and e.location.startswith("batched/")
        )
        compared = 0
        for member in members:
            want = _bytes(tts.Snapshot(paths["uncapped"]).read_object(member, device="cpu"))
            for name in ("sync", "donate"):
                got = _bytes(tts.Snapshot(paths[name]).read_object(member, device="cpu"))
                if not torch.equal(got, want):
                    raise AssertionError(f"phase12: {member} of the {name} take differs from the uncapped take's")
            compared += want.numel()
        if not members:
            raise AssertionError("phase12: the uncapped take has no slab members")
        launches_capped = {k: capped["sync"][k] + capped["donate"][k] for k in capped["sync"]}
        out = {
            "layers": n_layers, "state_bytes": state_bytes, "live_reserved_bytes": live, "cap_bytes": cap,
            "peak_reserved_under_cap_bytes": peak_reserved, "slabs": slabs, "warnings": warnings,
            "launches_capped": launches_capped, "launches_uncapped": uncapped,
            "slab_members": len(members), "member_bytes_compared": compared, **walls,
        }
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(out_path, "w") as f:
        json.dump(out, f)


_PHASE12_CHILD = "import sys, chip_smoke; chip_smoke.phase12_child(*sys.argv[1:])"


def phase12(seed, root, card):
    """Phase 12 in a child process (:func:`phase12_child`); returns its K1,
    K2 and K3 launches and its summary."""
    out_path = os.path.join(root, "phase12.json")
    work = os.path.join(root, "phase12")
    os.makedirs(work)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", _PHASE12_CHILD, str(seed), work, out_path],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=300,
    )
    child_s = time.monotonic() - t0
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"phase12: the child exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_path) as f:
        out = json.load(f)
    if "error" in out:
        raise AssertionError(f"phase12 child failed: {out['error'][-3000:]}")
    shutil.rmtree(work, ignore_errors=True)
    out["child_s"] = child_s
    log(f"phase12 K1 out of memory on {card}: {json.dumps(out)}")
    launches = {k: out["launches_capped"].get(k, 0) + out["launches_uncapped"].get(k, 0) for k in out["launches_uncapped"]}
    return launches, out


# Phase 13: a third-party storage plugin by entry point, and the examples
# ---------------------------------------------------------------------------

# The plugin a third party would ship: write, read and delete, nothing else
# (the port's StoragePlugin supplies write_stream, close and the sync forms).
_PHASE13_PLUGIN = """
import os

from torchsnapshot_tpu_torch import StoragePlugin


class SmokePlugin(StoragePlugin):
    def __init__(self, root):
        self.root = root

    def _abs(self, path):
        return os.path.join(self.root, path)

    async def write(self, write_io):
        path = self._abs(write_io.path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".part", "wb") as f:
            f.write(write_io.buf)
        os.replace(path + ".part", path)

    async def read(self, read_io):
        with open(self._abs(read_io.path), "rb") as f:
            if read_io.byte_range is None:
                read_io.buf = f.read()
            else:
                begin, end = read_io.byte_range
                f.seek(begin)
                read_io.buf = f.read(end - begin)

    async def delete(self, path):
        os.remove(self._abs(path))
"""

PHASE13_PROTOCOL = "smokefs"
PHASE13_TORN = "op=write,at=1,kind=torn,bytes=4096"


def phase13_site(root):
    """A directory that registers :data:`_PHASE13_PLUGIN` as protocol
    ``smokefs`` the way an installed package does: its module, and a
    ``.dist-info`` folder whose ``entry_points.txt`` names it under
    ``torchsnapshot_tpu_torch.storage_plugins``."""
    site = os.path.join(root, "site")
    info = os.path.join(site, "tss_smoke_plugin-1.0.dist-info")
    os.makedirs(info)
    with open(os.path.join(site, "tss_smoke_plugin.py"), "w") as f:
        f.write(_PHASE13_PLUGIN)
    with open(os.path.join(info, "METADATA"), "w") as f:
        f.write("Metadata-Version: 2.1\nName: tss-smoke-plugin\nVersion: 1.0\n")
    with open(os.path.join(info, "entry_points.txt"), "w") as f:
        f.write(f"[torchsnapshot_tpu_torch.storage_plugins]\n{PHASE13_PROTOCOL} = tss_smoke_plugin:SmokePlugin\n")
    return site


def phase13a_child(seed, root, out_path, n_layers=4):
    """Phase 13 (a) in a process whose ``sys.path`` holds the plugin's site
    (:func:`phase13_site`): phase 2's widths at ``n_layers`` layers through
    ``smokefs://`` with batching on: a sync take (K1), an ``async_take``
    raced by an in-place ``add_(1)`` of every tensor (K2), restores of both
    into zeroed CUDA tensors, bit-exact, ``verify() == {}``; then a take
    under ``TSS_TORCH_FAULTS`` (a torn write) must raise
    ``CheckpointAbortedError`` and leave no ``.snapshot_metadata``. The
    result goes to ``out_path`` as JSON."""
    import traceback

    try:
        import torchsnapshot_tpu_torch as tts
        from torchsnapshot_tpu_torch import kernels
        from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

        seed, n_layers = int(seed), int(n_layers)
        device = torch.device("cuda", 0)
        kernels.load_library()
        url = f"{PHASE13_PROTOCOL}://{root}"
        plugin = url_to_storage_plugin(url)
        if type(plugin).__module__ != "tss_smoke_plugin":
            raise AssertionError(f"phase13 (a): {url} resolved to {type(plugin)}")
        gen = torch.Generator(device=device).manual_seed(seed)
        params, progress, _ = build_state(0.0, device, gen, n_layers=n_layers)
        app = {"model": tts.StateDict(params), "progress": tts.StateDict(progress)}
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
        nbytes += progress["step"].numel() * progress["step"].element_size()
        out = {"layers": n_layers, "state_bytes": nbytes, "launches": {}}

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        tts.Snapshot.take(f"{url}/sync", app)
        out["sync_take_s"] = time.monotonic() - t0
        out["launches"]["sync_take"] = dict(kernels.LAUNCHES)
        if out["launches"]["sync_take"]["pack_slab"] < n_layers:
            raise AssertionError(f"phase13 (a): K1 launched {out['launches']['sync_take']} for {n_layers} layers")
        out["restore_s"] = _restore_exact(f"{url}/sync", params, progress, "phase13 (a) restore")

        before = {k: {n: t.clone() for n, t in v.items()} for k, v in params.items()}
        step_before = {"step": progress["step"].clone()}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        pending = tts.Snapshot.async_take(f"{url}/async", app)
        out["async_stall_s"] = time.monotonic() - t0
        for t in _tensors(params):
            t.add_(1)
        progress["step"].add_(1)
        pending.wait()
        out["async_take_s"] = time.monotonic() - t0
        out["launches"]["async_take"] = dict(kernels.LAUNCHES)
        if out["launches"]["async_take"]["fork_copy"] < 1:
            raise AssertionError(f"phase13 (a): K2 not launched: {out['launches']['async_take']}")
        out["async_restore_s"] = _restore_exact(f"{url}/async", before, step_before, "phase13 (a) async restore")
        for name in ("sync", "async"):
            problems = tts.Snapshot(f"{url}/{name}").verify()
            if problems:
                raise AssertionError(f"phase13 (a): verify of {name}: {problems}")
        for key in ("sync_take", "async_take", "restore", "async_restore"):
            out[f"{key}_gbps"] = nbytes / out[f"{key}_s"] / 1e9

        os.environ["TSS_TORCH_FAULTS"] = PHASE13_TORN
        try:
            tts.Snapshot.take(f"{url}/torn", app)
            raise AssertionError(f"phase13 (a): the take under {PHASE13_TORN} committed")
        except tts.CheckpointAbortedError as e:
            out["torn_abort"] = [e.rank, e.phase, repr(e.__cause__)]
            if "injected torn write after 4096 bytes" not in str(e.__cause__):
                raise AssertionError(f"phase13 (a): unexpected abort {e!r} from {e.__cause__!r}")
        finally:
            del os.environ["TSS_TORCH_FAULTS"]
        if os.path.exists(os.path.join(root, "torn", ".snapshot_metadata")):
            raise AssertionError("phase13 (a): the torn take wrote .snapshot_metadata")
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(out_path, "w") as f:
        json.dump(out, f)


_PHASE13A_CHILD = "import sys, chip_smoke; chip_smoke.phase13a_child(*sys.argv[1:])"


def _example(name, *args):
    """Start ``python examples/torch/<name>`` on the card, its output to
    pipes."""
    return subprocess.Popen(
        [sys.executable, os.path.join("examples", "torch", name), *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _finish(proc, name, timeout_s=300):
    try:
        stdout, stderr = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"phase13 (b): {name} did not end within {timeout_s} s")
    if proc.returncode != 0:
        raise AssertionError(f"phase13 (b): {name} exited {proc.returncode}: {stderr[-3000:]}")
    return stdout


def phase13b(root):
    """Phase 13 (b): the three examples as a user runs them, on the card,
    side by side; ``simple_example.py`` is then relaunched over its
    snapshots and must resume. Returns each run's output lines, the walls
    and the K3 launches of the embedding restore per rank."""
    simple_root = os.path.join(root, "simple")
    t0 = time.monotonic()
    procs = {
        "simple_example.py": _example("simple_example.py", "--snapshot-path", simple_root, "--epochs", "2"),
        "distributed_example.py": _example("distributed_example.py", "--root", os.path.join(root, "distributed")),
        "embedding_example.py": _example("embedding_example.py"),
    }
    out, walls = {}, {}
    try:
        out["simple_example.py"] = _finish(procs.pop("simple_example.py"), "simple_example.py")
        procs["simple_example.py relaunch"] = _example("simple_example.py", "--snapshot-path", simple_root, "--epochs", "4")
        for name in ("distributed_example.py", "embedding_example.py"):
            out[name] = _finish(procs.pop(name), name)
            walls[name] = time.monotonic() - t0
        out["simple_example.py relaunch"] = _finish(procs.pop("simple_example.py relaunch"), "the relaunch")
        walls["simple_example.py and its relaunch"] = time.monotonic() - t0
    finally:
        for proc in procs.values():
            proc.kill()
            proc.communicate()
    if "simple_example: done at epoch 2 on cuda" not in out["simple_example.py"]:
        raise AssertionError(f"phase13 (b): simple_example.py: {out['simple_example.py']}")
    second = out["simple_example.py relaunch"]
    if "resumed from epoch 2" not in second or "simple_example: done at epoch 4 on cuda" not in second:
        raise AssertionError(f"phase13 (b): the relaunch did not resume: {second}")
    distributed = out["distributed_example.py"]
    if "distributed_example: done" not in distributed or any(
        f"rank {r}: restored step=1 bit-exactly" not in distributed for r in range(2)
    ):
        raise AssertionError(f"phase13 (b): distributed_example.py: {distributed}")
    k3 = {}
    for line in out["embedding_example.py"].splitlines():
        if " as Replicate() bit-exactly " in line:
            k3[int(line.split(":")[0].split()[1])] = int(line.rsplit(", ", 1)[1].split()[0])
    if "embedding_example: done" not in out["embedding_example.py"] or sorted(k3) != [0, 1] or min(k3.values()) < 1:
        raise AssertionError(f"phase13 (b): embedding_example.py (K3 per rank {k3}): {out['embedding_example.py']}")
    return {name: text.strip().splitlines() for name, text in out.items()}, walls, k3


def phase13(seed, root, card):
    """Phase 13: (a) in a child process (:func:`phase13a_child`) whose
    ``PYTHONPATH`` holds the plugin's site, then (b) (:func:`phase13b`).
    Returns the launches and the summary."""
    work = os.path.join(root, "phase13")
    os.makedirs(work)
    site = phase13_site(work)
    out_path = os.path.join(work, "phase13a.json")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (site, os.environ.get("PYTHONPATH")) if p))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", _PHASE13A_CHILD, str(seed), os.path.join(work, "bucket"), out_path],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env, capture_output=True, text=True, timeout=300,
    )
    a_s = time.monotonic() - t0
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"phase13 (a): the child exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_path) as f:
        plugin = json.load(f)
    if "error" in plugin:
        raise AssertionError(f"phase13 (a) child failed: {plugin['error'][-3000:]}")
    plugin["child_s"] = a_s
    log(f"phase13 (a) entry-point plugin on {card}: {json.dumps(plugin)}")
    t0 = time.monotonic()
    lines, walls, k3 = phase13b(work)
    walls["b_s"] = time.monotonic() - t0
    for name, text in lines.items():
        log(f"phase13 (b) {name} on {card}: {json.dumps(text)}")
    log(f"phase13 (b) walls on {card}: {json.dumps(walls)}; embedding restore K3 launches per rank {json.dumps(k3)}")
    shutil.rmtree(work, ignore_errors=True)
    launches = {f"phase13a_{k}": v for k, v in plugin["launches"].items()}
    for rank, n in k3.items():
        launches[f"phase13b_embedding_rank{rank}"] = {"copy_blocks": n}
    summary = {"a": {k: v for k, v in plugin.items() if k != "launches"}, "b_walls": walls, "b_k3": k3}
    return launches, summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gb", type=float, default=4.0, help="size of the main-path state")
    parser.add_argument(
        "--phase3-gb", type=float, default=2.0,
        help="size of phase 3's two-rank TP state (cut from --gb, so phase 8 fits the script's time)",
    )
    parser.add_argument(
        "--phase9-gb", type=float, default=2.0,
        help="size of phase 9 (b)'s FSDP x TP train state over four ranks (whole layers, at least one)",
    )
    parser.add_argument(
        "--phase5-codecs", default="zlib,zstd",
        help="c3's codecs in phase 5, comma-separated (none, zlib, zstd; zstd only where zstandard is installed)",
    )
    parser.add_argument(
        "--phase5-layers", type=int, default=2,
        help="depth of phase 5's fine-tune, its first half frozen (cut from 8, then 4, for the script's time)",
    )
    parser.add_argument(
        "--phase11-layers", type=int, default=8,
        help="depth of phase 11's trainer at phase 4's width (8: phase 4's 11.25 GB in 408 tensors)",
    )
    parser.add_argument(
        "--phase11-pairs", type=int, default=1,
        help="alternating on/off pairs in phase 11 (a) and (d) (1, cut from 3, then 2, for the script's time)",
    )
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    # Phase 4 runs cuBLAS deterministically, which needs this before CUDA starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import torchsnapshot_tpu_torch as tts  # noqa: F401 - fails outside a checkout
    from torchsnapshot_tpu_torch import kernels

    _become_subreaper()

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
    walls = {}

    def timed(name, fn):
        t = time.monotonic()
        out = fn()
        walls[name] = time.monotonic() - t
        log(f"{name} wall on {card}: {walls[name]:.1f} s")
        return out

    try:
        launches, rates, slab_layer, state_tensors = timed("phase2", lambda: phase2(args.gb, device, gen, root, card))
        # The main path's K1 slab is one layer's attn plus its small tensors.
        slab_members = [slab_layer[k] for k in sorted(slab_layer)]
        times = timed("kernel timing", lambda: time_kernels(device, slab_members, state_tensors))
        del slab_layer, slab_members, state_tensors
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        k3_times = timed("K3 timing", lambda: time_k3(device, args.gb, gen))
        ranks = timed("phase3", lambda: phase3(args.phase3_gb, args.seed, root, card))
        launches["phase4"], trainer = timed("phase4", lambda: phase4(args.seed, device, root, card))
        phase5_launches, finetune = timed(
            "phase5",
            lambda: phase5(args.seed, device, root, card, args.phase5_codecs.split(","), args.phase5_layers),
        )
        for codec, counts in phase5_launches.items():
            launches[f"phase5_{codec}"] = counts
        phase6_launches, serving = timed("phase6", lambda: phase6(args.seed, device, gen, args.gb, root, card))
        launches.update(phase6_launches)
        launches["phase7"], continuous = timed("phase7", lambda: phase7(args.seed, device, root, card))
        launches["phase8a"], traced = timed("phase8 (a)", lambda: phase8a(args.seed, device, root, card))
        phase8b_launches, _ = timed("phase8 (b)", lambda: phase8b(args.gb, args.seed, root, card))
        launches.update(phase8b_launches)
        launches["phase8c"], overhead = timed("phase8 (c)", lambda: phase8c(args.gb, device, gen, root, card))
        launches["phase9a"], qos_summary = timed(
            "phase9 (a)", lambda: phase9a(args.seed, device, root, card)
        )
        phase9b_launches, fsdp_tp = timed("phase9 (b)", lambda: phase9b(args.phase9_gb, args.seed, root, card))
        launches.update(phase9b_launches)
        phase10_launches, robustness = timed("phase10", lambda: phase10(args.gb, args.phase3_gb, args.seed, device, root, card))
        launches.update(phase10_launches)
        phase11_launches, controls = timed(
            "phase11", lambda: phase11(args.seed, device, root, card, args.phase11_layers, args.phase3_gb, args.phase11_pairs)
        )
        launches.update(phase11_launches)
        launches["phase12"], oom = timed("phase12", lambda: phase12(args.seed, root, card))
        phase13_launches, extension = timed("phase13", lambda: phase13(args.seed, root, card))
        launches.update(phase13_launches)
        log(f"phase walls on {card}: {json.dumps({k: round(v, 1) for k, v in walls.items()})}, total {sum(walls.values()):.1f} s")
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
    summary = {k: v for k, v in continuous.items() if k != "takes"}
    summary["takes"] = {n: {k: v for k, v in r.items() if k != "drain_stats"} for n, r in continuous["takes"].items()}
    log(f"phase7 continuous summary on {card}: {json.dumps(summary)}")
    log(f"phase8 traced trainer summary on {card}: {json.dumps(traced)}")
    log(f"phase8 overhead summary on {card}: {json.dumps(overhead)}")
    log(f"phase9 (a) QoS summary on {card}: {json.dumps(qos_summary)}")
    log(f"phase9 (b) FSDP x TP on {card}: {fsdp_tp['layers']} layer(s), {fsdp_tp['state_bytes']} bytes, wall {fsdp_tp['wall_s']:.1f} s")
    log(f"phase10 robustness summary on {card}: {json.dumps(robustness)}")
    log(f"phase11 capture and transfer controls summary on {card}: {json.dumps(controls)}")
    log(f"phase12 K1 out-of-memory summary on {card}: {json.dumps(oom)}")
    log(f"phase13 plugin and examples summary on {card}: {json.dumps(extension)}")
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
    signalled = _stop_processes()
    if signalled:
        print(f"chip_smoke: stopped processes left running: {signalled}", file=sys.stderr, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        _stop_processes()
    sys.exit(rc)

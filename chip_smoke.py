"""Drive torchsnapshot_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a host with one CUDA GPU::

    python3 chip_smoke.py [--gb 4.0] [--seed 0]

Phase 0 builds the CUDA kernels from ``torchsnapshot_tpu_torch/csrc``.
Phase 1 holds each kernel (K1 pack_slab, K2 fork_copy) byte-exactly
against its plain PyTorch version on the card, over every packable dtype,
empty, one-element, odd-sized and misaligned members, a transposed view
and a ~100 MB member; then times kernel, plain version and one library call
at the main path's shapes, beside the copy's bound (2 x bytes / 3.35 TB/s).
Phase 2 drives the main path on a transformer-shaped bf16 state
(d_model 4096, d_ff 16384, ~``--gb`` GB): a sync take with batching on,
verify, restore into zeroed CUDA tensors, read_object, then async_take
followed at once by an in-place ``add_(1)`` of every tensor, wait, and a
restore that must give the values from before the mutation. The launch
counts are set to 0 just before each drive and read just after.

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
    if any(errs.values()):
        raise AssertionError(f"kernels disagree with their plain versions: {errs}")
    log(f"phase1 kernels byte-exact on {len(members) + len(big_group)} members: {errs}")
    return errs


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gb", type=float, default=4.0, help="size of the main-path state")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

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

    t0 = time.monotonic()
    kernels.load_library()
    log(f"kernel build: {kernels.BUILD_SECONDS:.2f} s compile, {time.monotonic() - t0:.2f} s to load")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    errs = phase1(device, gen)

    root = tempfile.mkdtemp(prefix="tss_chip_smoke_")
    try:
        launches, rates, slab_layer, state_tensors = phase2(args.gb, device, gen, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # The main path's K1 slab is one layer's attn plus its small tensors.
    slab_members = [slab_layer[k] for k in sorted(slab_layer)]
    times = time_kernels(device, slab_members, state_tensors)
    for name, t in times.items():
        log(f"{name} timing on {card}: {json.dumps(t)}")
    log(f"main path on {card}: {json.dumps(rates)}")

    sources = {
        "pack_slab": ("torchsnapshot_tpu_torch/csrc/tss_kernels.cu", "torchsnapshot_tpu/batcher.py:408"),
        "fork_copy": ("torchsnapshot_tpu_torch/csrc/tss_kernels.cu", "torchsnapshot_tpu/io_preparer.py:348"),
    }
    record = {"kernels": []}
    for name, (source, replaces) in sources.items():
        t = times[name]
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(d[name] for d in launches.values()),
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

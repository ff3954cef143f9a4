"""Dry runs of the workloads: a forward check, a train step and checkpoint
of FSDP/TP-sharded state on several ranks, and a train, async checkpoint
and bit-exact resume in one process.

The counterpart of the JAX package's ``__graft_entry__.py``:

- :func:`entry` returns the flagship transformer at the JAX entry's size
  and example arguments;
- :func:`dryrun_multichip` runs the JAX ``dryrun_multichip``'s steps on
  ``n`` ranks (spawned processes, a gloo process group): it builds a
  ``("dp", "tp")`` mesh with tp=2, takes one AdamW step with parameters and
  moments sharded as DTensors by the TP/FSDP rule, takes a snapshot, and
  restores it into the same mesh, a transposed ``("tp", "dp")`` mesh and a
  flat mesh, each restore bit-exact. The forward and backward run on full
  tensors on every rank (same seed, same tokens): backward through
  DTensors would need reduce-scatter, which gloo lacks. The gradients are
  cut into DTensors by the rule and AdamW steps the sharded state, which
  must equal the full-tensor step's blocks bit for bit. Then it certifies
  the plan cache as the JAX dry run's ``_worker_plan_cache_cert`` does:
  two async takes of the sharded train state, a step apart, where the
  second must hit the plan cache and the prepared-take cache, issue no
  ``all_gather`` while ``async_take`` runs and exactly the pinned store
  operations (:func:`cert_store_ops`, counted by
  :func:`counting_store_ops`), and restore bit-exactly.
- :func:`train_checkpoint_resume` trains a transformer with AdamW, takes an
  ``async_take`` and trains on while it drains, then restores into a fresh
  model and optimizer and checks that training resumes bit-identically.
- :func:`frozen_finetune_checkpoints` trains a transformer whose embeddings
  and first blocks are frozen and checkpoints it the ways a partial
  fine-tune does: two async takes (a prepared-take miss, then a hit), an
  incremental take against the second, a compressed take, each restored
  bit-exactly, and a bit-identical resume.

Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from .convert import dtensor_from_tensor, local_shard_of
from .models.transformer import (
    Transformer,
    TransformerConfig,
    fit_dims,
    init_params,
    loss_fn,
    param_spec,
    placements_of,
    shard_module,
    shard_params,
)
from .parallel.store import Store
from .rng_state import RNGState
from .snapshot import Snapshot
from .state_dict import StateDict
from .tricks.train_state import init_optimizer_state

# The JAX entry's and dry run's sizes (``__graft_entry__.py``).
ENTRY_CFG = TransformerConfig(
    vocab_size=1024, d_model=256, n_heads=4, n_layers=2, d_ff=1024, max_seq_len=128
)
DRYRUN_CFG = TransformerConfig(
    vocab_size=512, d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq_len=64
)


def adamw(params) -> torch.optim.AdamW:
    """AdamW with optax's ``adamw(1e-3)`` defaults (torch's default weight
    decay is 0.01, optax's 1e-4); torch's default update (``foreach`` for
    CUDA parameters)."""
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def tokens_for_step(
    cfg: TransformerConfig, step: int, batch: int, seed: int, device: Any
) -> torch.Tensor:
    """The ``(batch, max_seq_len + 1)`` tokens of training step ``step``,
    from a ``torch.Generator`` on ``device`` seeded by ``seed`` and the step,
    so a resumed run sees the same tokens."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
    shape = (batch, cfg.max_seq_len + 1)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=device)


def train_step(model: Transformer, optimizer: torch.optim.Optimizer, tokens: torch.Tensor) -> torch.Tensor:
    """One step: the loss, its backward, ``optimizer.step()``; returns the
    loss (detached)."""
    loss = loss_fn(model, tokens)
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


def entry(device: Any = "cuda") -> Tuple[Transformer, Tuple[torch.Tensor]]:
    """(the flagship transformer at the JAX entry's size, example args)."""
    model = init_params(ENTRY_CFG, seed=0, device=device)
    return model, (torch.zeros((2, 64), dtype=torch.int64, device=device),)


# ---------------------------------------------------------------------------
# Bit-exact comparison of train states
# ---------------------------------------------------------------------------


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when ``a`` and ``b`` hold the same dtype, shape and bytes."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = lambda t: t.detach().contiguous().reshape(-1).view(torch.uint8)  # noqa: E731
    return torch.equal(view(a), view(b))


def train_state_tensors(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> List[Tuple[str, torch.Tensor]]:
    """(label, tensor) of every parameter and every optimizer state tensor,
    in a fixed order."""
    out = [(name, p) for name, p in model.named_parameters()]
    for name, p in model.named_parameters():
        for key, v in sorted(optimizer.state.get(p, {}).items()):
            if isinstance(v, torch.Tensor):
                out.append((f"{name}/{key}", v))
    return out


def _check_same_state(got, want, what: str) -> None:
    if [n for n, _ in got] != [n for n, _ in want]:
        raise AssertionError(f"{what}: the states hold different tensors")
    for (name, a), (_, b) in zip(got, want):
        if not same_bits(a, b):
            raise AssertionError(f"{what}: {name} differs")


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------


def cert_store_ops(rank: int, world_size: int) -> Dict[str, int]:
    """The store operations a plan-cache hit's ``async_take`` issues on
    ``rank``'s calling thread, key GC aside (``take_plan.py``): the
    preflight and the manifest delta, each a gather to rank 0 and a
    broadcast back."""
    if rank == 0:
        return {"set": 4, "get": 2 * world_size}
    return {"set": 2, "get": 2}


class _CountingStore(Store):
    """Delegates to ``inner`` and counts the operations that one thread
    issues through it: a blocking ``get`` is one operation however long it
    polls."""

    def __init__(self, inner: Store, thread_id: int) -> None:
        self.inner = inner
        self.counts: Dict[str, int] = {}
        self._thread_id = thread_id

    def _count(self, op: str) -> None:
        if threading.get_ident() == self._thread_id:
            self.counts[op] = self.counts.get(op, 0) + 1

    def set(self, key: str, value: bytes) -> None:
        self._count("set")
        self.inner.set(key, value)

    def get(self, key: str, *timeout_s: float) -> bytes:
        self._count("get")
        return self.inner.get(key, *timeout_s)

    def try_get(self, key: str) -> Optional[bytes]:
        self._count("try_get")
        return self.inner.try_get(key)

    def add(self, key: str, delta: int) -> int:
        self._count("add")
        return self.inner.add(key, delta)

    def delete(self, key: str) -> None:
        self._count("delete")
        self.inner.delete(key)

    def try_get_many(self, keys: List[str]) -> List[Optional[bytes]]:
        self._count("try_get_many")
        return self.inner.try_get_many(keys)


@contextlib.contextmanager
def counting_store_ops(coord: Any) -> Iterator[Dict[str, int]]:
    """``{op: count}`` of the store operations that ``coord`` issues on
    the calling thread inside the block (its store is wrapped meanwhile;
    other threads' operations are not counted)."""
    counting = _CountingStore(coord.store, threading.get_ident())
    coord._store = counting
    try:
        yield counting.counts
    finally:
        coord._store = counting.inner


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout_s: float = 300.0) -> None:
    """Run the multi-rank dry run on ``n_devices`` spawned ranks (gloo
    process group; with ``device="cuda"`` rank r uses card
    ``r % device_count``). Raises when any rank fails."""
    from .test_utils import run_with_processes

    with tempfile.TemporaryDirectory() as shared:
        run_with_processes(
            _dryrun_worker, n_devices, args=(shared, device), timeout_s=timeout_s, process_group=True
        )


def _local_of(full: torch.Tensor, dt: Any) -> torch.Tensor:
    mesh = dt.device_mesh
    return local_shard_of(full, mesh.shape, dt.placements, mesh.get_coordinate())


def _check_sharded_state(model, optimizer, full_model, full_optimizer, what: str) -> None:
    """Every local shard of ``model``/``optimizer`` equals its block of the
    full-tensor state (DTensors over the mesh, in place)."""
    got = train_state_tensors(model, optimizer)
    want = dict(train_state_tensors(full_model, full_optimizer))
    if sorted(n for n, _ in got) != sorted(want):
        raise AssertionError(f"{what}: the states hold different tensors")
    for name, t in got:
        if name.endswith("/step"):
            ok = same_bits(t, want[name])
        else:
            ok = type(t).__name__ == "DTensor" and same_bits(t.to_local(), _local_of(want[name], t))
        if not ok:
            raise AssertionError(f"{what}: {name} differs from the full-tensor step's block")


def _dryrun_worker(rank: int, world_size: int, shared: str, device_type: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    tp = 2 if world_size % 2 == 0 else 1
    dp = world_size // tp
    ranks = torch.arange(world_size)
    mesh = DeviceMesh(device_type, ranks.reshape(dp, tp), mesh_dim_names=("dp", "tp"))
    cfg = DRYRUN_CFG

    # One step on full tensors: every rank computes the same values.
    full = init_params(cfg, seed=0, device=device)
    tokens = torch.ones((dp * 2, 32), dtype=torch.int64, device=device)
    loss = loss_fn(full, tokens)
    loss.backward()
    if not torch.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    # The same step on the state sharded by the rule.
    model = shard_params(init_params(cfg, seed=0, device=device), mesh, fsdp=True)
    for (_, p), (_, fp) in zip(model.named_parameters(), full.named_parameters()):
        p.grad = dtensor_from_tensor(fp.grad, mesh, p.placements)
    optimizer = adamw(model.parameters())
    optimizer.step()
    full_optimizer = adamw(full.parameters())
    full_optimizer.step()
    _check_sharded_state(model, optimizer, full, full_optimizer, "sharded AdamW step")

    path = os.path.join(shared, "dryrun_ckpt")
    Snapshot.take(path, {"model": model, "optim": optimizer})

    def restore_into(new_mesh, spec: Callable[[str, Sequence[int], Any], List[Any]], what: str) -> None:
        fresh = shard_module(init_params(cfg, seed=1, device=device), new_mesh, spec)
        fresh_optimizer = init_optimizer_state(adamw(fresh.parameters()))
        before = {n: t.to_local().data_ptr() for n, t in train_state_tensors(fresh, fresh_optimizer) if not n.endswith("/step")}
        Snapshot(path).restore({"model": fresh, "optim": fresh_optimizer}, device=device)
        _check_sharded_state(fresh, fresh_optimizer, full, full_optimizer, what)
        after = {n: t.to_local().data_ptr() for n, t in train_state_tensors(fresh, fresh_optimizer) if not n.endswith("/step")}
        if after != before:
            raise AssertionError(f"{what}: a local shard was not filled in place")

    restore_into(mesh, param_spec, "same-mesh restore")
    # Cross-mesh elasticity, as the JAX dry run: per-ndim specs refit to each mesh.
    transposed = DeviceMesh(device_type, ranks.reshape(tp, dp), mesh_dim_names=("tp", "dp"))
    restore_into(
        transposed,
        lambda n, s, m: placements_of(fit_dims(("tp", "dp") if len(s) >= 2 else ("dp",) * len(s), s, m), m),
        "transposed-mesh restore",
    )
    flat = DeviceMesh(device_type, ranks, mesh_dim_names=("all",))
    restore_into(flat, lambda n, s, m: placements_of(fit_dims(("all",) * min(len(s), 1), s, m), m), "flat-mesh restore")
    _plan_cache_cert(cfg, mesh, model, optimizer, shared, rank, world_size, device)


def _plan_cache_cert(cfg, mesh, model, optimizer, shared, rank, world_size, device) -> None:
    """Two async takes of the sharded train state, one optimizer step
    apart: the second hits the plan cache and the prepared-take cache,
    issues no all_gather and exactly :func:`cert_store_ops` store
    operations while ``async_take`` runs, and restores bit-exactly."""
    from . import snapshot as snapshot_mod
    from .parallel.coordinator import get_coordinator

    app = {"model": model, "optim": optimizer}
    Snapshot.async_take(os.path.join(shared, "cert_c0"), app).wait()
    optimizer.step()  # new values, same structure
    coord = get_coordinator()
    all_gathers = [0]
    original = coord.all_gather_object

    def counting(*args, **kwargs):
        all_gathers[0] += 1
        return original(*args, **kwargs)

    coord.all_gather_object = counting
    try:
        with counting_store_ops(coord) as counted:
            pending = Snapshot.async_take(os.path.join(shared, "cert_c1"), app)
        ops = dict(counted)
        cache = dict(snapshot_mod.LAST_TAKE_CACHE)
        pending.wait()
    finally:
        del coord.all_gather_object
    ops.pop("delete", None)  # key GC of earlier collectives
    if all_gathers[0] or not cache.get("plan_cache_hit") or not cache.get("prepared_cache_hit"):
        raise AssertionError(f"plan-cache certification: not a hit ({cache}, {all_gathers[0]} all_gathers)")
    if ops != cert_store_ops(rank, world_size):
        raise AssertionError(f"plan-cache certification: store ops {ops} != {cert_store_ops(rank, world_size)}")
    fresh = shard_module(init_params(cfg, seed=1, device=device), mesh, param_spec)
    fresh_optimizer = init_optimizer_state(adamw(fresh.parameters()))
    Snapshot(os.path.join(shared, "cert_c1")).restore({"model": fresh, "optim": fresh_optimizer}, device=device)
    got, want = train_state_tensors(fresh, fresh_optimizer), train_state_tensors(model, optimizer)
    for (name, a), (_, b) in zip(got, want):
        local = (lambda t: t.to_local()) if type(a).__name__ == "DTensor" else (lambda t: t)
        if not same_bits(local(a), local(b)):
            raise AssertionError(f"plan-cache certification: restored {name} differs")


# ---------------------------------------------------------------------------
# Train, async checkpoint, resume
# ---------------------------------------------------------------------------


def _stream_record() -> Dict[str, Any]:
    """The last streaming decision and the fs plugin's scorecard
    (``stream_select``), after a take's writes have ended."""
    from . import stream_select

    return {"decision": stream_select.last_decision(), "scorecard": stream_select.scorecard("fs")}


def _state_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for _, t in tensors)


def _timed(fn, device: torch.device) -> Tuple[Any, float]:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.monotonic()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.monotonic() - t0


def _allocations(device: torch.device) -> Dict[str, Any]:
    """Growth of torch's CUDA allocators so far: device blocks (cudaMalloc
    calls), pinned host blocks and the microseconds spent creating them
    (empty on the CPU)."""
    if device.type != "cuda":
        return {}
    host = torch.cuda.host_memory_stats()
    return {
        "device_allocs": torch.cuda.memory_stats(device).get("num_device_alloc"),
        "host_allocs": host.get("num_host_alloc"),
        "host_alloc_us": host.get("host_alloc_time.total"),
    }


def _timed_step(model, optimizer, tokens, device) -> Tuple[torch.Tensor, float, Dict[str, Any]]:
    """One training step: (loss, wall seconds, allocator growth during it)."""
    before = _allocations(device)
    loss, dt = _timed(lambda: train_step(model, optimizer, tokens), device)
    after = _allocations(device)
    grown = {k: None if after[k] is None or before[k] is None else after[k] - before[k] for k in after}
    return loss, dt, grown


def train_checkpoint_resume(
    cfg: TransformerConfig, root: str, device: Any = "cuda", batch: int = 4, seed: int = 0
) -> Dict[str, Any]:
    """Train ``cfg`` with AdamW for 6 steps, checkpoint asynchronously at
    step 3 while training on, and resume bit-exactly.

    1. steps 1-3; a device copy of the state is kept;
    2. ``async_take`` of ``{"model", "optim", "progress", "rng"}``, then at
       once the next steps, whose in-place updates race the drain;
    3. ``wait()``, ``verify() == {}``;
    4. a fresh model (another seed) and optimizer, its state materialised,
       restored: every tensor equals the copy bit for bit, in place;
    5. the remaining steps again on the same tokens: every loss, parameter
       and moment is bit-identical to the uninterrupted run;
    6. a sync ``take`` of the final state, restored into the zeroed tensors
       of the fresh model in place, bit-exact;
    7. the snapshots are deleted.

    Runs with deterministic algorithms on (on CUDA, cuBLAS then needs
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts) and without
    filling uninitialised memory (every staging buffer is overwritten).
    Raises ``AssertionError`` on any mismatch. Returns the measurements:
    losses, state bytes, step times and allocator growth per step (alone
    and racing the drain), the async stall and drain with ``drain_stats``,
    the restore, sync take and sync restore times, and the stall's phases."""
    device = torch.device(device)
    return _deterministic(lambda: _train_checkpoint_resume(cfg, root, device, batch, seed))


def _deterministic(fn):
    """Run ``fn`` with deterministic algorithms on and uninitialised-memory
    filling off, restoring both after."""
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    was_filling = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        torch.utils.deterministic.fill_uninitialized_memory = was_filling


def _train_checkpoint_resume(cfg, root, device, batch, seed) -> Dict[str, Any]:
    from . import snapshot as snapshot_mod

    k, steps = 3, 6
    out: Dict[str, Any] = {}
    tokens = lambda s: tokens_for_step(cfg, s, batch, seed, device)  # noqa: E731
    model = init_params(cfg, seed=seed, device=device)
    optimizer = adamw(model.parameters())
    progress = StateDict(step=0)
    app = {"model": model, "optim": optimizer, "progress": progress, "rng": RNGState()}

    losses, step_s, step_allocs = [], [], []
    for s in range(1, k + 1):
        loss, dt, grown = _timed_step(model, optimizer, tokens(s), device)
        losses.append(loss)
        step_s.append(dt)
        step_allocs.append(grown)
        progress["step"] = s
    state = train_state_tensors(model, optimizer)
    nbytes = _state_bytes(state)
    out["n_params"] = sum(p.numel() for p in model.parameters())
    out["state_bytes"] = nbytes
    out["n_tensors"] = len(state)
    copy = [(n, t.detach().clone()) for n, t in state]

    # async_take, then train on at once: the in-place updates race the drain.
    path = os.path.join(root, "async")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.monotonic()
    pending = Snapshot.async_take(path, app)
    out["async_stall_s"] = time.monotonic() - t0
    out["async_phases"] = dict(snapshot_mod.LAST_TAKE_PHASES)
    racing_s, racing_allocs = [], []
    for s in range(k + 1, steps + 1):
        loss, dt, grown = _timed_step(model, optimizer, tokens(s), device)
        losses.append(loss)
        racing_s.append(dt)
        racing_allocs.append(grown)
        progress["step"] = s
    pending.wait()
    out["async_drain_s"] = time.monotonic() - t0 - out["async_stall_s"]
    out["async_stream"] = _stream_record()
    out["drain_stats"] = dict(pending.drain_stats)
    out["racing_step_s"] = racing_s
    out["racing_step_allocations"] = racing_allocs
    problems = Snapshot(path).verify()
    if problems:
        raise AssertionError(f"verify of the async snapshot: {problems}")

    # Restore into a fresh model and optimizer.
    model2 = init_params(cfg, seed=seed + 1, device=device)
    optimizer2 = init_optimizer_state(adamw(model2.parameters()))
    progress2 = StateDict(step=-1)
    app2 = {"model": model2, "optim": optimizer2, "progress": progress2, "rng": RNGState()}
    ptrs = [t.data_ptr() for _, t in train_state_tensors(model2, optimizer2)]
    _, out["restore_s"] = _timed(lambda: Snapshot(path).restore(app2, device=device), device)
    restored = train_state_tensors(model2, optimizer2)
    _check_same_state(restored, copy, f"restore of the step-{k} snapshot")
    if [t.data_ptr() for _, t in restored] != ptrs:
        raise AssertionError("the restore did not fill the live tensors in place")
    if progress2["step"] != k:
        raise AssertionError(f"restored progress {progress2['step']}, expected {k}")
    del copy
    shutil.rmtree(path)

    # Resume: the same tokens give the same losses and state.
    resumed = []
    for s in range(k + 1, steps + 1):
        loss, dt, grown = _timed_step(model2, optimizer2, tokens(s), device)
        resumed.append(loss)
        step_s.append(dt)
        step_allocs.append(grown)
    if not same_bits(torch.stack(resumed), torch.stack(losses[k:])):
        raise AssertionError(f"resumed losses {torch.stack(resumed).tolist()} != {torch.stack(losses[k:]).tolist()}")
    _check_same_state(train_state_tensors(model2, optimizer2), train_state_tensors(model, optimizer), "resumed run")
    out["losses"] = torch.stack(losses).tolist()
    out["step_s"] = step_s
    out["step_allocations"] = step_allocs

    # A sync take of the final state, restored into zeroed tensors in place.
    path = os.path.join(root, "sync")
    _, out["sync_take_s"] = _timed(lambda: Snapshot.take(path, app), device)
    out["sync_stream"] = _stream_record()
    with torch.no_grad():
        for _, t in train_state_tensors(model2, optimizer2):
            t.zero_()
    _, out["sync_restore_s"] = _timed(lambda: Snapshot(path).restore(app2, device=device), device)
    final = train_state_tensors(model2, optimizer2)
    _check_same_state(final, train_state_tensors(model, optimizer), "restore of the sync snapshot")
    moved = [n for (n, t), ptr in zip(final, ptrs) if t.data_ptr() != ptr]
    if moved:
        raise AssertionError(f"the sync restore did not fill these tensors in place: {moved[:5]}")
    shutil.rmtree(path)
    return out


# ---------------------------------------------------------------------------
# A partial fine-tune: caches, an incremental take, a compressed take
# ---------------------------------------------------------------------------


def frozen_names(model: torch.nn.Module, frozen_blocks: int) -> List[str]:
    """The token and position embeddings and the first ``frozen_blocks``
    blocks: the parameters a partial fine-tune leaves untouched."""
    prefixes = ("embed.", "pos_embed.") + tuple(f"block_{i}." for i in range(frozen_blocks))
    return [n for n, _ in model.named_parameters() if n.startswith(prefixes)]


def _inodes(root: str) -> Dict[str, Tuple[int, int]]:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            out[os.path.relpath(os.path.join(dirpath, f), root)] = (st.st_dev, st.st_ino)
    return out


def _disk_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def frozen_finetune_checkpoints(
    cfg: TransformerConfig,
    root: str,
    device: Any = "cuda",
    batch: int = 4,
    seed: int = 0,
    frozen_blocks: int = 4,
    codec: str = "zlib",
) -> Dict[str, Any]:
    """Fine-tune ``cfg`` with its embeddings and first ``frozen_blocks``
    blocks frozen (``requires_grad=False``, not in the optimizer), and
    checkpoint it as such a job does:

    1. steps 1-2, ``async_take`` to ``c0`` (a prepared-take miss), step 3
       racing its drain, ``wait()``;
    2. ``async_take`` to ``c1``, a hit whose values differ from ``c0``'s,
       step 4 racing its drain, ``wait()``;
    3. a sync ``take`` to ``c2`` with ``base=c1``: the frozen tensors are
       hard-linked from ``c1``;
    4. step 5, a sync ``take`` to ``c3`` with ``codec`` compression and slab
       batching (member-framed compressed slabs, packed by K1);
    5. steps 6-7 of the uninterrupted run;
    6. ``c1``, ``c2`` and ``c3`` restored into a fresh model and a
       materialised optimizer, each equal to its step's copy bit for bit;
       then steps 6-7 resumed from ``c3``, bit-identical to the
       uninterrupted run;
    7. the batched pair, on the uninterrupted run: step 8, ``async_take``
       to ``c4`` (a miss) racing step 9, ``async_take`` to ``c5`` (a hit,
       whose K1 descriptor tables must be rebuilt over its new forks)
       racing step 10, and a sync ``take`` to ``c6`` with ``base=c5``, all
       with slab batching; each restored bit-exactly.

    ``c0``-``c2`` are taken without slab batching: a slab dedups only when
    every member is unchanged, and slabs mix frozen and trained tensors.
    ``c6`` measures what that costs (its deduped bytes against the frozen
    bytes); it is not held to the frozen bytes.
    The drive starts from an empty prepared-take cache.
    Device memory allocated after each ``wait()`` must be back to its level
    before the take. Raises ``AssertionError`` on any mismatch; returns the
    measurements (stalls with their phases and cache hits, device memory
    around each take, dedup bytes and links, ``c3``'s raw and on-disk bytes
    and rates, each take's streaming decision and scorecard, ``c5``'s
    kernel launches, losses and step times). Deterministic algorithms on,
    as :func:`train_checkpoint_resume`."""
    device = torch.device(device)
    return _deterministic(
        lambda: _frozen_finetune(cfg, root, device, batch, seed, frozen_blocks, codec)
    )


def _frozen_finetune(cfg, root, device, batch, seed, frozen_blocks, codec) -> Dict[str, Any]:
    from . import kernels, prepare_cache
    from . import snapshot as snapshot_mod
    from .parallel.coordinator import get_coordinator
    from .utils import knobs

    prepare_cache.reset(get_coordinator())  # c0 must be a miss
    out: Dict[str, Any] = {}
    tokens = lambda s: tokens_for_step(cfg, s, batch, seed, device)  # noqa: E731

    def build(model_seed):
        model = init_params(cfg, seed=model_seed, device=device)
        frozen = set(frozen_names(model, frozen_blocks))
        for name, p in model.named_parameters():
            p.requires_grad_(name not in frozen)
        optimizer = adamw([p for p in model.parameters() if p.requires_grad])
        return model, optimizer

    def allocated() -> int:
        return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0

    model, optimizer = build(seed)
    progress = StateDict(step=0)
    app = {"model": model, "optim": optimizer, "progress": progress, "rng": RNGState()}
    out["frozen_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters() if not p.requires_grad)
    losses: List[torch.Tensor] = []
    step_s: List[float] = []

    def step(s):
        loss, dt, _ = _timed_step(model, optimizer, tokens(s), device)
        # On the host: a loss kept on the card would count against the
        # device memory checked around each take.
        losses.append(loss.cpu())
        step_s.append(dt)
        progress["step"] = s

    def copy_state():
        return [(n, t.detach().clone()) for n, t in train_state_tensors(model, optimizer)]

    paths = {c: os.path.join(root, c) for c in ("c0", "c1", "c2", "c3", "c4", "c5", "c6")}
    copies = {}

    def async_take(name, race_step):
        """``async_take`` to ``name``, ``race_step`` racing its drain."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        before = allocated()
        launches = dict(kernels.LAUNCHES)
        t0 = time.monotonic()
        pending = Snapshot.async_take(paths[name], app)
        stall = time.monotonic() - t0
        out[f"{name}_phases"] = dict(snapshot_mod.LAST_TAKE_PHASES)
        out[f"{name}_cache"] = dict(snapshot_mod.LAST_TAKE_CACHE)
        step(race_step)
        pending.wait()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[f"{name}_stall_s"] = stall
        out[f"{name}_drain_s"] = time.monotonic() - t0 - stall
        out[f"{name}_allocated"] = (before, allocated())
        out[f"{name}_stream"] = _stream_record()
        # The take's own launches and the racing step's (which launches none).
        out[f"{name}_launches"] = {k: v - launches.get(k, 0) for k, v in kernels.LAUNCHES.items()}
        del pending
        if out[f"{name}_allocated"][1] > before:
            raise AssertionError(f"{name}: device memory after wait() {out[f'{name}_allocated']}")

    def check_pair(miss, hit):
        if out[f"{miss}_cache"]["prepared_cache_hit"] or not out[f"{hit}_cache"]["prepared_cache_hit"]:
            raise AssertionError(f"prepared-take cache: {miss} {out[f'{miss}_cache']}, {hit} {out[f'{hit}_cache']}")

    def incremental_take(name, base):
        copies[name] = copy_state()
        before = allocated()
        _, out[f"{name}_take_s"] = _timed(lambda: Snapshot.take(paths[name], app, base=paths[base]), device)
        out[f"{name}_allocated"] = (before, allocated())
        out[f"{name}_stream"] = _stream_record()
        stats = dict(snapshot_mod.LAST_SYNC_DRAIN_STATS)
        out[f"{name}_bytes_deduped"] = stats["bytes_deduped"]
        out[f"{name}_objects_linked"] = stats["objects_linked"]
        base_inodes = set(_inodes(paths[base]).values())
        inodes = _inodes(paths[name])
        out[f"{name}_objects"] = len(inodes)
        out[f"{name}_samefile"] = sum(1 for v in inodes.values() if v in base_inodes)

    def restore_and_check(names_steps):
        for c, at_step in names_steps:
            problems = Snapshot(paths[c]).verify()
            if problems:
                raise AssertionError(f"verify of {c}: {problems}")
            _, out[f"{c}_restore_s"] = _timed(lambda: Snapshot(paths[c]).restore(app2, device=device), device)
            _check_same_state(train_state_tensors(model2, optimizer2), copies.pop(c), f"restore of {c}")
            if progress2["step"] != at_step:
                raise AssertionError(f"{c}: restored progress {progress2['step']}, expected {at_step}")

    step(1)
    step(2)
    with knobs.override_batching_enabled(False):
        async_take("c0", 3)
        copies["c1"] = copy_state()
        async_take("c1", 4)
        check_pair("c0", "c1")
        incremental_take("c2", "c1")
    if out["c2_bytes_deduped"] < out["frozen_bytes"]:
        raise AssertionError(f"c2 deduped {out['c2_bytes_deduped']} < frozen {out['frozen_bytes']} bytes")

    step(5)
    copies["c3"] = copy_state()
    state_bytes = _state_bytes(copies["c3"])
    out["state_bytes"] = state_bytes
    with knobs.override_compression(codec), knobs.override_batching_enabled(True):
        before = allocated()
        _, out["c3_take_s"] = _timed(lambda: Snapshot.take(paths["c3"], app), device)
        out["c3_allocated"] = (before, allocated())
        out["c3_stream"] = _stream_record()
    out["c3_disk_bytes"] = _disk_bytes(paths["c3"])
    step(6)
    step(7)
    final = train_state_tensors(model, optimizer)
    problems = Snapshot(paths["c0"]).verify()
    if problems:
        raise AssertionError(f"verify of c0: {problems}")

    # Restores into a fresh model, then the resume.
    model2, optimizer2 = build(seed + 1)
    optimizer2 = init_optimizer_state(optimizer2)
    progress2 = StateDict(step=-1)
    app2 = {"model": model2, "optim": optimizer2, "progress": progress2, "rng": RNGState()}
    restore_and_check((("c1", 3), ("c2", 4), ("c3", 5)))
    resumed = []
    for s in (6, 7):
        loss, dt, _ = _timed_step(model2, optimizer2, tokens(s), device)
        resumed.append(loss.cpu())
    if not same_bits(torch.stack(resumed), torch.stack(losses[5:7])):
        raise AssertionError(f"resumed losses {torch.stack(resumed).tolist()} != {torch.stack(losses[5:7]).tolist()}")
    _check_same_state(train_state_tensors(model2, optimizer2), final, "resume from c3")
    del final
    for c in ("c0", "c1", "c2", "c3"):
        shutil.rmtree(paths[c])

    # The batched pair, on the uninterrupted run.
    with knobs.override_batching_enabled(True):
        step(8)
        copies["c4"] = copy_state()
        async_take("c4", 9)
        copies["c5"] = copy_state()
        async_take("c5", 10)
        check_pair("c4", "c5")
        incremental_take("c6", "c5")
    restore_and_check((("c4", 8), ("c5", 9), ("c6", 10)))
    out["losses"] = torch.stack(losses).tolist()
    out["step_s"] = step_s
    for c in ("c4", "c5", "c6"):
        shutil.rmtree(paths[c])
    return out

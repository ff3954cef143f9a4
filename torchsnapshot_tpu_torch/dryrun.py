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
- :func:`continuous_checkpoints` checkpoints such a fine-tune continuously
  into one bucket under the catalog (``job=``, managed delta chains with a
  rebase to full), then prunes it with a retention policy, restores the
  retained snapshots bit-exactly (directly and through a read cache) and
  sweeps planted crash debris with ``Snapshot.gc``.
- :func:`traced_checkpoint` runs the trainer's async checkpoint and its
  restore under ``TSS_TORCH_TRACE``, and :func:`trace_report` reads a
  trace back: span counts, the D2H bytes and their busy time, and the io
  node's split between hashing and storage.
- :func:`fsdp_tp_checkpoints` (one rank's part, in a process group of
  four) checkpoints the transformer laid out as FSDP2 over TP
  (``_StridedShard`` placements) with AdamW state filled from a seed, and
  restores it into the same layout, into ``Shard(0)`` over a flat mesh,
  and from such a plain take back into FSDP2 over TP, bit-exact.
- :func:`qos_race` races a ``qos="foreground"`` restore of a model's
  weights against the ``qos="background"`` drain of its train state's
  ``async_take`` in one process, and reads the drain's preemptions.

Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from .convert import dtensor_from_tensor, local_shard_of
from .io_preparer import is_dtensor
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
from .parallel.store import Store, in_telemetry_op
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
    polls. Telemetry-plane operations (fleet beacons, under
    ``store.telemetry_op_scope``) are not coordination and are not
    counted."""

    def __init__(self, inner: Store, thread_id: int) -> None:
        self.inner = inner
        self.counts: Dict[str, int] = {}
        self._thread_id = thread_id

    def _count(self, op: str) -> None:
        if threading.get_ident() == self._thread_id and not in_telemetry_op():
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


def _frozen_model(cfg, device, model_seed: int, frozen_blocks: int):
    """(model, AdamW over its trained parameters), the embeddings and the
    first ``frozen_blocks`` blocks frozen."""
    model = init_params(cfg, seed=model_seed, device=device)
    frozen = set(frozen_names(model, frozen_blocks))
    for name, p in model.named_parameters():
        p.requires_grad_(name not in frozen)
    return model, adamw([p for p in model.parameters() if p.requires_grad])


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
       batching (member-framed compressed slabs, packed by K1; ``none``:
       plain slabs);
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
        return _frozen_model(cfg, device, model_seed, frozen_blocks)

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


# ---------------------------------------------------------------------------
# Continuous checkpointing: managed delta chains, retention and gc
# ---------------------------------------------------------------------------

# (snapshot, async?) of the continuous drive, one training step apart.
CONTINUOUS_TAKES = (("t1", True), ("t2", False), ("t3", True), ("t4", True), ("t5", False), ("t6", True))


def _bucket_bytes(root: str) -> Tuple[int, int]:
    """(bytes of every file under ``root``, bytes of its distinct inodes):
    hard-linked objects count once in the second."""
    files, inodes = 0, {}
    for dirpath, _, names in os.walk(root):
        for f in names:
            st = os.stat(os.path.join(dirpath, f))
            files += st.st_size
            inodes[(st.st_dev, st.st_ino)] = st.st_size
    return files, sum(inodes.values())


def continuous_checkpoints(
    cfg: TransformerConfig,
    root: str,
    device: Any = "cuda",
    batch: int = 4,
    seed: int = 0,
    frozen_blocks: int = 4,
) -> Dict[str, Any]:
    """Checkpoint a partial fine-tune continuously into one bucket under
    the catalog, then prune it by policy and sweep it:

    1. ``cfg``'s transformer with its embeddings and first
       ``frozen_blocks`` blocks frozen, AdamW; one training step before
       each take of :data:`CONTINUOUS_TAKES` (``t1``-``t6``, each with
       ``job="ft"``, ``step=`` the training step and ``max_chain_len=2``):
       an ``async_take`` is raced by the next step and ``wait()``-ed before
       the next take. Before ``t6`` the chain cache is dropped, so its base
       comes from a catalog scan. The recorded chains are 0, 1, 2, 0, 1, 2
       (``t4`` rebases to a full snapshot);
    2. ``catalog.retain(bucket, "last=2")`` as a dry run, then applied: it
       condemns ``t1``-``t4`` (``t5``'s base ``t4`` among them) and keeps
       ``t5`` and ``t6``; the catalog then holds their two records;
    3. ``t5`` and ``t6`` restored into a fresh model and a materialised
       optimizer, each bit-exact against device copies taken at their
       steps; then both again, ``t5`` first, through a fresh read cache
       (``TSS_TORCH_READ_CACHE_DIR`` under ``root``): ``t6`` reads from the
       origin only what it did not share with ``t5``;
    4. a torn ``*.tmp.*`` file in ``t6`` and an uncommitted root ``t7``
       planted; ``Snapshot.gc(bucket)`` as a dry run, then applied: exactly
       the planted files go, and ``t5`` and ``t6`` still verify clean.

    Slab batching is on. Incremental dedup needs sha256 digests on every
    take (``TSS_TORCH_DEDUP_DIGESTS``: ``auto`` is on with more than one
    core). Deterministic algorithms on, as :func:`train_checkpoint_resume`.
    Raises ``AssertionError`` on any mismatch; returns the measurements:
    each take's stall or wall time, drain, launches, cache hits and
    catalog record, the retain and gc reports with the bucket's bytes
    before and after, restore times and the read cache's origin bytes."""
    device = torch.device(device)
    return _deterministic(
        lambda: _continuous(cfg, root, device, batch, seed, frozen_blocks)
    )


def _continuous(cfg, root, device, batch, seed, frozen_blocks) -> Dict[str, Any]:
    from . import catalog, kernels, prepare_cache
    from . import snapshot as snapshot_mod
    from .parallel.coordinator import get_coordinator
    from .utils import knobs

    prepare_cache.reset(get_coordinator())
    bucket = os.path.join(root, "bucket")
    catalog.invalidate_chain_cache(bucket)
    out: Dict[str, Any] = {"takes": {}}
    tokens = lambda s: tokens_for_step(cfg, s, batch, seed, device)  # noqa: E731
    model, optimizer = _frozen_model(cfg, device, seed, frozen_blocks)
    progress = StateDict(step=0)
    app = {"model": model, "optim": optimizer, "progress": progress, "rng": RNGState()}
    out["frozen_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters() if not p.requires_grad)
    step_no = [0]
    losses: List[torch.Tensor] = []

    def step() -> None:
        step_no[0] += 1
        loss, _, _ = _timed_step(model, optimizer, tokens(step_no[0]), device)
        losses.append(loss.cpu())
        progress["step"] = step_no[0]

    copies: Dict[str, List[Tuple[str, torch.Tensor]]] = {}
    t_start = time.monotonic()
    with knobs.override_batching_enabled(True):
        step()
        for name, is_async in CONTINUOUS_TAKES:
            rec: Dict[str, Any] = {"step": step_no[0], "async": is_async}
            if name in ("t5", "t6"):
                copies[name] = [(n, t.detach().clone()) for n, t in train_state_tensors(model, optimizer)]
            if name == "t6":
                catalog.invalidate_chain_cache(bucket)
            path = os.path.join(bucket, name)
            kw = dict(job="ft", step=step_no[0], max_chain_len=2)
            launches = dict(kernels.LAUNCHES)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.monotonic()
            if is_async:
                pending = Snapshot.async_take(path, app, **kw)
                rec["stall_s"] = time.monotonic() - t0
                rec["cache"] = dict(snapshot_mod.LAST_TAKE_CACHE)
                step()  # races the drain
                pending.wait()
                rec["drain_s"] = time.monotonic() - t0 - rec["stall_s"]
                rec["drain_stats"] = dict(pending.drain_stats)
                del pending
            else:
                Snapshot.take(path, app, **kw)
                rec["take_s"] = time.monotonic() - t0
                rec["cache"] = dict(snapshot_mod.LAST_TAKE_CACHE)
                rec["drain_stats"] = dict(snapshot_mod.LAST_SYNC_DRAIN_STATS)
                step()
            rec["launches"] = {k: v - launches.get(k, 0) for k, v in kernels.LAUNCHES.items()}
            out["takes"][name] = rec
    out["takes_wall_s"] = time.monotonic() - t_start
    out["state_bytes"] = _state_bytes(copies["t6"])

    with catalog.Catalog(bucket) as cat:
        records = {r.name: r for r in cat.load(job="ft")}
    for name, _ in CONTINUOUS_TAKES:
        r = records[name]
        out["takes"][name]["record"] = {
            "base": r.base, "chain_len": r.chain_len, "bytes_total": r.bytes_total,
            "bytes_written": r.bytes_written, "bytes_deduped": r.bytes_deduped,
        }
    out["chain_lens"] = [records[n].chain_len for n, _ in CONTINUOUS_TAKES]
    want_chains = [0, 1, 2, 0, 1, 2]
    if out["chain_lens"] != want_chains:
        raise AssertionError(f"chain lengths {out['chain_lens']} != {want_chains}")
    want_bases = {"t1": None, "t2": "t1", "t3": "t2", "t4": None, "t5": "t4", "t6": "t5"}
    bases = {n: records[n].base for n, _ in CONTINUOUS_TAKES}
    if bases != want_bases:
        raise AssertionError(f"bases {bases} != {want_bases}")
    for name in ("t2", "t3", "t5", "t6"):
        if records[name].bytes_deduped <= 0:
            raise AssertionError(f"{name} deduped nothing against its base: {records[name]}")

    # Retention: keep the last two.
    policy = catalog.RetentionPolicy.parse("last=2")
    out["bucket_bytes_before"] = _bucket_bytes(bucket)
    dry = catalog.retain(bucket, policy, dry_run=True)
    t0 = time.monotonic()
    applied = catalog.retain(bucket, policy, dry_run=False)
    out["retain_s"] = time.monotonic() - t0
    out["bucket_bytes_after"] = _bucket_bytes(bucket)
    for label, rep in (("dry", dry), ("applied", applied)):
        out[f"retain_{label}"] = {
            "condemned": rep["condemned"], "retained": rep["policy"]["retained"],
            "remove": len(rep["remove"]), "remove_records": len(rep["remove_records"]),
            "keep": len(rep["keep"]), "removed": rep["removed"],
        }
    if applied["condemned"] != ["t1", "t2", "t3", "t4"] or applied["policy"]["retained"] != ["t5", "t6"]:
        raise AssertionError(f"retain condemned {applied['condemned']}, kept {applied['policy']['retained']}")
    if dry["remove"] != applied["remove"] or applied["removed"] != len(applied["remove"]) + len(applied["remove_records"]):
        raise AssertionError("the applied retain removed other files than its dry run named")
    left = sorted(n for n in os.listdir(bucket) if n != catalog.CATALOG_DIR)
    with catalog.Catalog(bucket) as cat:
        recorded = [r.name for r in cat.load()]
    if left != ["t5", "t6"] or recorded != ["t5", "t6"]:
        raise AssertionError(f"after retain: roots {left}, records {recorded}")
    catalog.validate_chain_closure(bucket, ["t5", "t6"], [])

    # Restores of the retained pair, their base collected.
    model2, optimizer2 = _frozen_model(cfg, device, seed + 1, frozen_blocks)
    optimizer2 = init_optimizer_state(optimizer2)
    progress2 = StateDict(step=-1)
    app2 = {"model": model2, "optim": optimizer2, "progress": progress2, "rng": RNGState()}

    def restore(name: str, what: str) -> float:
        _, dt = _timed(lambda: Snapshot(os.path.join(bucket, name)).restore(app2, device=device), device)
        _check_same_state(train_state_tensors(model2, optimizer2), copies[name], f"{what} of {name}")
        if progress2["step"] != out["takes"][name]["step"]:
            raise AssertionError(f"{name}: restored progress {progress2['step']}")
        return dt

    for name in ("t5", "t6"):
        out[f"{name}_restore_s"] = restore(name, "restore")
    cache_dir = os.path.join(root, "read_cache")
    env = {"TSS_TORCH_READ_CACHE_DIR": cache_dir, "TSS_TORCH_READ_CACHE_BYTES": str(64 * 1024**3)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for name in ("t5", "t6"):
            out[f"{name}_cached_restore_s"] = restore(name, "cached restore")
            out[f"{name}_cached_attribution"] = dict(snapshot_mod.LAST_RESTORE_STATS["attribution"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(cache_dir, ignore_errors=True)
    del copies

    # The debris sweep: a torn temp file in a committed snapshot and an
    # uncommitted snapshot's object, as a crash leaves them.
    planted = ["t6/0/model/torn.tmp.0a1b2c3d", "t7/0/partial"]
    for i, rel in enumerate(planted):
        debris = os.path.join(bucket, rel)
        os.makedirs(os.path.dirname(debris), exist_ok=True)
        with open(debris, "wb") as f:
            f.write(bytes([i]) * 4096)
    before = {os.path.relpath(os.path.join(d, f), bucket) for d, _, fs in os.walk(bucket) for f in fs}
    dry = Snapshot.gc(bucket)
    applied = Snapshot.gc(bucket, dry_run=False)
    after = {os.path.relpath(os.path.join(d, f), bucket) for d, _, fs in os.walk(bucket) for f in fs}
    out["gc"] = {
        label: {k: (len(v) if isinstance(v, list) and k in ("keep", "remove") else v)
                for k, v in rep.items()}
        for label, rep in (("dry", dry), ("applied", applied))
    }
    if dry["remove"] != planted or applied["removed"] != len(planted) or sorted(before - after) != planted:
        raise AssertionError(f"the debris sweep named {dry['remove']}, removed {sorted(before - after)}")
    if os.path.exists(os.path.join(bucket, "t7")):
        raise AssertionError("the uncommitted root's directories were not pruned")
    for name in ("t5", "t6"):
        problems = Snapshot(os.path.join(bucket, name)).verify()
        if problems:
            raise AssertionError(f"verify of {name} after gc: {problems}")
    out["losses"] = torch.stack(losses).tolist()
    shutil.rmtree(bucket)
    return out


# ---------------------------------------------------------------------------
# Telemetry: a traced async checkpoint and its restore
# ---------------------------------------------------------------------------


def _union_s(spans, names) -> float:
    """Seconds covered by the union of the spans named ``names``."""
    from .engine.intervals import measure, merge_intervals

    return measure(merge_intervals([(s.ts, s.ts + s.dur) for s in spans if s.name in names]))


def trace_report(trace_path: str) -> Dict[str, Any]:
    """What a Chrome trace written by the port says: span counts by name,
    dropped spans, the ``take.phase`` durations, the ``stage.d2h`` bytes
    and the union of their busy time, and the io node's split (the union
    of ``stage.hash`` and ``stage.hash_chunk`` time against the union of
    ``storage.write`` and of ``storage.read`` time)."""
    import json as json_mod

    from . import telemetry

    with open(trace_path) as f:
        obj = json_mod.load(f)
    spans = telemetry.spans_from_chrome_trace(obj)
    metrics = telemetry.metrics_from_chrome_trace(obj)
    counts: Dict[str, int] = {}
    phases: Dict[str, float] = {}
    for sp in spans:
        counts[sp.name] = counts.get(sp.name, 0) + 1
        if sp.cat == "take.phase":
            phases[sp.name] = phases.get(sp.name, 0.0) + sp.dur
    d2h = [sp for sp in spans if sp.name == "stage.d2h"]
    return {
        "spans": len(spans),
        "span_counts": counts,
        "dropped_spans": int((obj.get("otherData") or {}).get("dropped_spans", 0)),
        "spans_dropped_metric": int(metrics.get("telemetry.spans_dropped", 0)),
        "phases": phases,
        "d2h_bytes": sum(int(sp.attrs.get("nbytes", 0)) for sp in d2h),
        "d2h_busy_s": _union_s(spans, {"stage.d2h"}),
        "hash_busy_s": _union_s(spans, {"stage.hash", "stage.hash_chunk"}),
        "write_busy_s": _union_s(spans, {"storage.write", "storage.write_stream"}),
        "read_busy_s": _union_s(spans, {"storage.read"}),
        "consume_busy_s": _union_s(spans, {"scheduler.consume"}),
        "artifact_write_s": _union_s(spans, {"telemetry.artifact_write"}),
        "metrics": metrics,
    }


def traced_checkpoint(
    cfg: TransformerConfig,
    root: str,
    trace_dir: str,
    device: Any = "cuda",
    batch: int = 4,
    seed: int = 0,
) -> Dict[str, Any]:
    """The trainer's async checkpoint under ``TSS_TORCH_TRACE``: steps 1-3,
    ``async_take`` of the train state (trace ``<trace_dir>/take.json``)
    raced by step 4, ``wait()``, then a restore into a fresh model and
    optimizer (trace ``<trace_dir>/restore.json``), bit-exact against a
    device copy of the step-3 state. Returns the stall, drain and restore
    times, ``LAST_TAKE_PHASES``, the state's bytes and its CUDA bytes (what
    crosses D2H), and the two trace paths."""
    device = torch.device(device)
    return _deterministic(lambda: _traced_checkpoint(cfg, root, trace_dir, device, batch, seed))


def _traced_checkpoint(cfg, root, trace_dir, device, batch, seed) -> Dict[str, Any]:
    from . import snapshot as snapshot_mod

    out: Dict[str, Any] = {}
    tokens = lambda s: tokens_for_step(cfg, s, batch, seed, device)  # noqa: E731
    model = init_params(cfg, seed=seed, device=device)
    optimizer = adamw(model.parameters())
    progress = StateDict(step=0)
    app = {"model": model, "optim": optimizer, "progress": progress, "rng": RNGState()}
    for s in range(1, 4):
        train_step(model, optimizer, tokens(s))
        progress["step"] = s
    state = train_state_tensors(model, optimizer)
    out["state_bytes"] = _state_bytes(state)
    out["d2h_bytes"] = sum(t.numel() * t.element_size() for _, t in state if t.device.type == "cuda")
    out["n_tensors"] = len(state)
    copy = [(n, t.detach().clone()) for n, t in state]
    path = os.path.join(root, "traced")
    traces = {"take": os.path.join(trace_dir, "take.json"), "restore": os.path.join(trace_dir, "restore.json")}
    prev = os.environ.get("TSS_TORCH_TRACE")
    try:
        os.environ["TSS_TORCH_TRACE"] = traces["take"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.monotonic()
        pending = Snapshot.async_take(path, app)
        out["async_stall_s"] = time.monotonic() - t0
        out["take_phases"] = dict(snapshot_mod.LAST_TAKE_PHASES)
        train_step(model, optimizer, tokens(4))  # races the drain
        progress["step"] = 4
        pending.wait()
        out["async_drain_s"] = time.monotonic() - t0 - out["async_stall_s"]
        out["drain_stats"] = dict(pending.drain_stats)
        model2 = init_params(cfg, seed=seed + 1, device=device)
        optimizer2 = init_optimizer_state(adamw(model2.parameters()))
        app2 = {"model": model2, "optim": optimizer2, "progress": StateDict(step=-1), "rng": RNGState()}
        os.environ["TSS_TORCH_TRACE"] = traces["restore"]
        _, out["restore_s"] = _timed(lambda: Snapshot(path).restore(app2, device=device), device)
    finally:
        if prev is None:
            os.environ.pop("TSS_TORCH_TRACE", None)
        else:
            os.environ["TSS_TORCH_TRACE"] = prev
    _check_same_state(train_state_tensors(model2, optimizer2), copy, "traced restore of the step-3 snapshot")
    out["restore_stats"] = {k: v for k, v in snapshot_mod.LAST_RESTORE_STATS.items() if not isinstance(v, dict)}
    out["traces"] = traces
    shutil.rmtree(path)
    return out


# ---------------------------------------------------------------------------
# Seeded train state, FSDP2 over TP, and a QoS race
# ---------------------------------------------------------------------------


def seeded_global(name: str, shape: Sequence[int], dtype: torch.dtype, seed: int, device: Any) -> torch.Tensor:
    """The global value of train-state tensor ``name`` under ``seed``:
    standard normal draws (fp32, then cast) from a generator on ``device``
    seeded by ``seed`` and the name's crc32, the same on every rank."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + zlib.crc32(name.encode()))
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32).to(dtype)


@torch.no_grad()
def fill_from_seed(model: torch.nn.Module, optimizer: torch.optim.Optimizer, seed: int) -> int:
    """Set every parameter and optimizer moment to its block of
    :func:`seeded_global` (a DTensor's local shard in place) and every
    ``step`` to ``seed``. Returns this rank's bytes of them."""
    total = 0
    for name, t in train_state_tensors(model, optimizer):
        if name.endswith("/step"):
            t.fill_(float(seed))
            continue
        local = t.to_local() if is_dtensor(t) else t
        full = seeded_global(name, t.shape, t.dtype, seed, local.device)
        local.copy_(_local_of(full, t) if is_dtensor(t) else full)
        total += local.numel() * local.element_size()
    return total


def check_against_seed(model: torch.nn.Module, optimizer: torch.optim.Optimizer, seed: int, what: str) -> None:
    """Every parameter and moment (a DTensor's local shard) equals its block
    of :func:`seeded_global` bit for bit, and every ``step`` is ``seed``."""
    for name, t in train_state_tensors(model, optimizer):
        if name.endswith("/step"):
            ok = float(t) == float(seed)
        else:
            local = t.to_local() if is_dtensor(t) else t
            full = seeded_global(name, t.shape, t.dtype, seed, local.device)
            ok = same_bits(local, _local_of(full, t) if is_dtensor(t) else full)
        if not ok:
            raise AssertionError(f"{what}: {name} differs from its seeded value")


def fsdp_tp_checkpoints(
    cfg: TransformerConfig, root: str, device: Any = "cuda", seed: int = 0, dp: int = 2, tp: int = 2
) -> Dict[str, Any]:
    """One rank's part (call it on every rank of a process group of
    ``dp * tp`` ranks, ``root`` shared) of checkpointing FSDP2 over TP: the
    transformer laid out by ``parallelize_fsdp_tp`` on a ``("dp", "tp")``
    mesh, with AdamW state (``init_optimizer_state``), every parameter and
    moment filled from ``seed`` (gloo has no reduce-scatter: no step runs).
    ``up`` and ``lm_head`` must carry ``_StridedShard``. Then, each step
    timed and its kernel launches counted on this rank:

    - ``take``: a take of the FSDP x TP state;
    - ``restore_same``: a restore into a fresh FSDP x TP state;
    - ``restore_plain``: a restore into the state sharded ``Shard(0)`` over
      a flat mesh of every rank (``Replicate()`` where 0 does not divide);
    - ``take_plain``: a take of that plain state;
    - ``restore_from_plain``: its restore into a fresh FSDP x TP state.

    Every restore must equal the seeded values bit for bit. Returns this
    rank's bytes (``state_bytes``) and the state's (``global_bytes``), the
    strided parameters' names and placements, and per step its seconds,
    GB/s over the rank's bytes and launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from . import kernels
    from .models.transformer import parallelize_fsdp_tp

    device = torch.device(device)
    world = dp * tp
    mesh = init_device_mesh(device.type, (dp, tp), mesh_dim_names=("dp", "tp"))
    flat = init_device_mesh(device.type, (world,), mesh_dim_names=("all",))

    def fsdp_tp_state(s: int):
        model = parallelize_fsdp_tp(init_params(cfg, seed=s, device=device), mesh)
        return model, init_optimizer_state(adamw(model.parameters()))

    def plain_state(s: int):
        spec = lambda n, shape, m: placements_of(fit_dims(("all",), shape, m), m)  # noqa: E731
        model = shard_module(init_params(cfg, seed=s, device=device), flat, spec)
        return model, init_optimizer_state(adamw(model.parameters()))

    model, optimizer = fsdp_tp_state(seed)
    nbytes = fill_from_seed(model, optimizer, seed)
    placements = {n: repr(tuple(p.placements)) for n, p in model.named_parameters() if is_dtensor(p)}
    strided = sorted(n for n, p in placements.items() if "_StridedShard" in p)
    for want in ("block_0.up.weight", "lm_head.weight"):
        if want not in strided:
            raise AssertionError(f"{want} carries no _StridedShard: {placements.get(want)}")
    global_bytes = sum(t.numel() * t.element_size() for _, t in train_state_tensors(model, optimizer))
    out: Dict[str, Any] = {
        "state_bytes": nbytes,
        "global_bytes": global_bytes,
        "strided": {n: placements[n] for n in strided},
        "steps": {},
    }

    def step(label: str, fn: Callable[[], None]) -> None:
        dist.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.monotonic() - t0
        out["steps"][label] = {"s": dt, "gbps": nbytes / dt / 1e9, "launches": dict(kernels.LAUNCHES)}

    path, plain_path = os.path.join(root, "fsdp_tp"), os.path.join(root, "fsdp_tp_plain")
    step("take", lambda: Snapshot.take(path, {"model": model, "optim": optimizer}))
    del model, optimizer
    model, optimizer = fsdp_tp_state(seed + 1)
    step("restore_same", lambda: Snapshot(path).restore({"model": model, "optim": optimizer}, device=device))
    check_against_seed(model, optimizer, seed, "restore into the same FSDP x TP layout")
    del model, optimizer
    model, optimizer = plain_state(seed + 1)
    step("restore_plain", lambda: Snapshot(path).restore({"model": model, "optim": optimizer}, device=device))
    check_against_seed(model, optimizer, seed, "restore into Shard(0) over a flat mesh")
    step("take_plain", lambda: Snapshot.take(plain_path, {"model": model, "optim": optimizer}))
    del model, optimizer
    model, optimizer = fsdp_tp_state(seed + 2)
    step(
        "restore_from_plain",
        lambda: Snapshot(plain_path).restore({"model": model, "optim": optimizer}, device=device),
    )
    check_against_seed(model, optimizer, seed, "restore of a plain take into FSDP x TP")
    dist.barrier()
    return out


def qos_race(
    cfg: TransformerConfig, root: str, device: Any = "cuda", seed: int = 0, poll_s: float = 0.0005
) -> Dict[str, Any]:
    """A serving restore racing a checkpoint drain in one process. The
    trainer's state (``cfg``, AdamW, every parameter and moment from
    ``seed``) and a snapshot of its weights alone are made; the state is
    taken with ``async_take(qos="background")``, and as soon as its drain
    has staged bytes beyond those staged before ``async_take`` returned
    (for CUDA state: its first device-to-host copy of a fork),
    ``restore(qos="foreground")`` of the weights' snapshot goes into a
    fresh model's live tensors. Then the
    drain is waited for, and its snapshot restored into a fresh model and
    optimizer. Both restores must equal the live state bit for bit.
    ``TSS_TORCH_QOS`` decides whether the restore preempts the drain.

    Returns the restore's seconds and GB/s, the drain's seconds (from
    ``async_take``'s return), whether the drain was still running when the
    restore ended, and the drain engine's ``preemptions`` and
    ``preempted_wait_s`` (its artifact's ``engine`` section: pause episodes
    of the engine and of each streamed object, whose waits overlap) and
    ``paused_wall_s``, the union of those episodes."""
    from .engine.intervals import measure, merge_intervals
    from .telemetry import artifact

    device = torch.device(device)
    model = init_params(cfg, seed=seed, device=device)
    optimizer = init_optimizer_state(adamw(model.parameters()))
    state_bytes = fill_from_seed(model, optimizer, seed)
    weights_bytes = _state_bytes(list(model.named_parameters()))
    serve_path, drain_path = os.path.join(root, "qos_serving"), os.path.join(root, "qos_drain")
    Snapshot.take(serve_path, {"model": model})
    target = init_params(cfg, seed=seed + 1, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.monotonic()
    pending = Snapshot.async_take(drain_path, {"model": model, "optim": optimizer}, qos="background")
    t_returned = time.monotonic()
    captured = pending.progress()["bytes_staged"]
    while pending.progress()["bytes_staged"] == captured and not pending.done():
        time.sleep(poll_s)
    t_restore = time.monotonic()
    Snapshot(serve_path).restore({"model": target}, device=device, qos="foreground")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    restore_s = time.monotonic() - t_restore
    drain_running = not pending.done()
    pending.wait()
    drain_s = time.monotonic() - t_returned
    _check_same_state(list(target.named_parameters()), list(model.named_parameters()), "foreground restore")
    with open(os.path.join(drain_path, ".telemetry", "rank_0.json"), "rb") as f:
        engine = artifact.parse_artifact(f.read()).get("engine") or {}
    model2 = init_params(cfg, seed=seed + 2, device=device)
    optimizer2 = init_optimizer_state(adamw(model2.parameters()))
    Snapshot(drain_path).restore({"model": model2, "optim": optimizer2}, device=device)
    _check_same_state(
        train_state_tensors(model2, optimizer2), train_state_tensors(model, optimizer), "restore of the drained snapshot"
    )
    shutil.rmtree(serve_path)
    shutil.rmtree(drain_path)
    return {
        "state_bytes": state_bytes,
        "weights_bytes": weights_bytes,
        "async_stall_s": t_returned - t0,
        "restore_start_after_return_s": t_restore - t_returned,
        "restore_s": restore_s,
        "restore_gbps": weights_bytes / restore_s / 1e9,
        "drain_s": drain_s,
        "drain_running_at_restore_end": drain_running,
        "preemptions": int(engine.get("preemptions", 0)),
        "preempted_wait_s": float(engine.get("preempted_wait_s", 0.0)),
        "paused_wall_s": measure(merge_intervals([tuple(iv) for iv in engine.get("pause_intervals") or ()])),
    }

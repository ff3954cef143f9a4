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
  must equal the full-tensor step's blocks bit for bit. The JAX dry run's
  plan-cache certification (``_worker_plan_cache_cert``) is not here: the
  port has no plan cache yet.
- :func:`train_checkpoint_resume` trains a transformer with AdamW, takes an
  ``async_take`` and trains on while it drains, then restores into a fresh
  model and optimizer and checks that training resumes bit-identically.

Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# Train, async checkpoint, resume
# ---------------------------------------------------------------------------


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
    the restore, sync take and sync restore times."""
    device = torch.device(device)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    was_filling = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        return _train_checkpoint_resume(cfg, root, device, batch, seed)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        torch.utils.deterministic.fill_uninitialized_memory = was_filling


def _train_checkpoint_resume(cfg, root, device, batch, seed) -> Dict[str, Any]:
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
    racing_s, racing_allocs = [], []
    for s in range(k + 1, steps + 1):
        loss, dt, grown = _timed_step(model, optimizer, tokens(s), device)
        losses.append(loss)
        racing_s.append(dt)
        racing_allocs.append(grown)
        progress["step"] = s
    pending.wait()
    out["async_drain_s"] = time.monotonic() - t0 - out["async_stall_s"]
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

"""Distributed checkpointing of a sharded train state, on the PyTorch port
(the counterpart of ``examples/distributed_example.py``).

Run under a launcher that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT`` (``torchrun --nproc-per-node N
examples/torch/distributed_example.py``) to join its job, or alone to
spawn two ranks of a gloo process group on this host::

    python examples/torch/distributed_example.py [--device cpu]

The port's transformer at the JAX example's configuration (vocab 1024,
d_model 256, 8 heads, 2 layers, d_ff 512, 128 positions) has its
parameters and AdamW moments as DTensors over a (dp, tp) mesh
(``models.transformer.shard_params``). It takes one step, snapshots the
state, and restores it into a fresh model and optimizer laid out over the
transposed (tp, dp) mesh, where every local shard must equal its block of
the same step taken on full tensors, bit for bit. The forward and backward
run on full tensors on every rank and the gradients are cut into DTensors,
since gloo has no reduce-scatter; AdamW steps the DTensors themselves.
Each rank uses CUDA device ``rank % device_count`` unless ``--device cpu``
is given.
"""

import argparse
import contextlib
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

CONFIG = dict(vocab_size=1024, d_model=256, n_heads=8, n_layers=2, d_ff=512, max_seq_len=128)


def train_and_checkpoint(rank: int, world_size: int, root: str, device_type: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    from torchsnapshot_tpu_torch import RNGState, Snapshot, StateDict
    from torchsnapshot_tpu_torch.convert import dtensor_from_tensor, local_shard_of
    from torchsnapshot_tpu_torch.dryrun import train_state_tensors
    from torchsnapshot_tpu_torch.models.transformer import (
        TransformerConfig,
        fit_dims,
        init_params,
        loss_fn,
        placements_of,
        shard_module,
        shard_params,
    )
    from torchsnapshot_tpu_torch.tricks.train_state import init_optimizer_state

    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    cfg = TransformerConfig(**CONFIG)
    tp = 2 if world_size % 2 == 0 else 1
    ranks = torch.arange(world_size)
    mesh = DeviceMesh(device_type, ranks.reshape(world_size // tp, tp), mesh_dim_names=("dp", "tp"))

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4)

    # One step on full tensors (the same on every rank), and the same step
    # on the sharded state.
    full = init_params(cfg, seed=0, device=device)
    tokens = torch.ones((8, 64), dtype=torch.int64, device=device)
    loss = loss_fn(full, tokens)
    loss.backward()
    model = shard_params(init_params(cfg, seed=0, device=device), mesh, fsdp=True)
    for (_, p), (_, fp) in zip(model.named_parameters(), full.named_parameters()):
        p.grad = dtensor_from_tensor(fp.grad, mesh, p.placements)
    optimizer = adamw(model.parameters())
    optimizer.step()
    full_optimizer = adamw(full.parameters())
    full_optimizer.step()
    if rank == 0:
        print(f"step 0: loss={loss.item():.4f}")

    path = os.path.join(root, "ckpt")
    app_state = {"model": model, "optim": optimizer, "progress": StateDict(step=1), "rng": RNGState()}
    # async_take returns once the state is captured; training could go on.
    pending = Snapshot.async_take(path, app_state)
    snapshot = pending.wait()

    # Restore into the transposed mesh: other placements, other blocks.
    other = DeviceMesh(device_type, ranks.reshape(tp, world_size // tp), mesh_dim_names=("tp", "dp"))
    spec = lambda n, s, m: placements_of(fit_dims(("tp", "dp") if len(s) >= 2 else ("dp",) * len(s), s, m), m)  # noqa: E731
    fresh = shard_module(init_params(cfg, seed=1, device=device), other, spec)
    fresh_optimizer = init_optimizer_state(adamw(fresh.parameters()))
    progress = StateDict(step=0)
    snapshot.restore({"model": fresh, "optim": fresh_optimizer, "progress": progress, "rng": RNGState()}, device=device)
    want = dict(train_state_tensors(full, full_optimizer))
    for name, t in train_state_tensors(fresh, fresh_optimizer):
        expected = want[name]
        if type(t).__name__ == "DTensor":
            expected = local_shard_of(expected, other.shape, t.placements, other.get_coordinate())
            t = t.to_local()
        if t.dtype != expected.dtype or not torch.equal(t.reshape(-1).view(torch.uint8), expected.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"rank {rank}: restored {name} differs from the step's value")
    if progress["step"] != 1:
        raise AssertionError(f"rank {rank}: restored step {progress['step']}")
    print(f"rank {rank}: restored step={progress['step']} bit-exactly on the transposed mesh {tuple(other.shape)}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--root", default=None, help="where the snapshot goes (a shared directory under a launcher)")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    with contextlib.ExitStack() as stack:
        root = args.root or stack.enter_context(tempfile.TemporaryDirectory())
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            import torch.distributed as dist

            rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
            dist.init_process_group("nccl" if args.device == "cuda" else "gloo", rank=rank, world_size=world_size)
            try:
                train_and_checkpoint(rank, world_size, root, args.device)
            finally:
                dist.destroy_process_group()
        else:
            from torchsnapshot_tpu_torch.test_utils import run_with_processes

            run_with_processes(train_and_checkpoint, 2, args=(root, args.device), process_group=True, timeout_s=300)
    print("distributed_example: done")


if __name__ == "__main__":
    main()

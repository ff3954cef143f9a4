"""A row-sharded embedding table saved under one layout and restored under
another, on the PyTorch port (the counterpart of
``examples/embedding_example.py``).

Run:  python examples/torch/embedding_example.py [--rows N] [--dim D] [--device cpu]

Two ranks of a gloo process group are spawned on this host. The table
(``--rows`` x ``--dim`` float32 from a seed; 1,000,000 x 128, 512 MB, by
default) is a DTensor row-sharded over them (``Shard(0)``) and is taken;
it is then restored into a ``Replicate()`` DTensor on each rank, every
rank fetching both saved shards' rows and scattering them into its copy
(on the card, the port's ``copy_blocks`` kernel), and compared bit for
bit; finally ``read_object`` reads the table whole without any DTensor.
Each rank uses CUDA device ``rank % device_count`` unless ``--device cpu``
is given.
"""

import argparse
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def reshard(rank: int, world_size: int, root: str, rows: int, dim: int, device_type: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict, kernels
    from torchsnapshot_tpu_torch.convert import dtensor_from_tensor

    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    mesh = DeviceMesh(device_type, list(range(world_size)))
    gen = torch.Generator(device=device).manual_seed(0)
    table = torch.randn(rows, dim, generator=gen, device=device)
    nbytes = table.numel() * table.element_size()

    path = os.path.join(root, "ckpt")
    sharded = dtensor_from_tensor(table, mesh, [Shard(0)])
    t0 = time.monotonic()
    Snapshot.take(path, {"embeddings": StateDict(table=sharded)})
    take_s = time.monotonic() - t0
    if rank == 0:
        print(f"saved {nbytes / 1e6:.1f} MB row-sharded {world_size}-way in {take_s:.2f} s")

    # Restore under another layout: every rank holds the whole table.
    target = dtensor_from_tensor(torch.zeros_like(table), mesh, [Replicate()])
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    Snapshot(path).restore({"embeddings": StateDict(table=target)}, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    restore_s = time.monotonic() - t0
    scatters = kernels.LAUNCHES["copy_blocks"]
    got = target.to_local()
    if not torch.equal(got.view(torch.int32), table.view(torch.int32)):
        raise AssertionError(f"rank {rank}: the replicated restore differs from the saved table")
    print(
        f"rank {rank}: restored {nbytes / 1e6:.1f} MB as Replicate() bit-exactly in {restore_s:.2f} s "
        f"({nbytes / restore_s / 1e9:.3f} GB/s, {scatters} copy_blocks launches)",
        flush=True,
    )

    # Random access: the whole table without any DTensor.
    whole = Snapshot(path).read_object("0/embeddings/table", device=device)
    if not torch.equal(whole.view(torch.int32), table.view(torch.int32)):
        raise AssertionError(f"rank {rank}: read_object differs from the saved table")
    if rank == 0:
        print("read_object round-trip OK")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    with tempfile.TemporaryDirectory() as root:
        run_with_processes(reshard, 2, args=(root, args.rows, args.dim, args.device), process_group=True, timeout_s=300)
    print("embedding_example: done")


if __name__ == "__main__":
    main()

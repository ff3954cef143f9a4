"""The resume loop of ``examples/simple_example.py``, on the PyTorch port.

Run:  python examples/torch/simple_example.py [--snapshot-path PATH] [--epochs N] [--device cpu]

The state is an ``nn.Module``, its ``torch.optim.AdamW``, a ``StateDict`` of
progress and ``RNGState`` (each epoch's data is drawn from torch's global
generator, so the restored generator decides it). One snapshot is taken
per epoch under ``PATH/epoch_<n>``; a relaunch with the same path resumes
from the latest committed epoch, and kill-and-relaunch ends in the same
state, bit for bit, as an uninterrupted run. Runs on the current CUDA
device unless ``--device cpu`` is given.
"""

import argparse
import os
import random
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from torchsnapshot_tpu_torch import RNGState, Snapshot, StateDict  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--snapshot-path", default=None)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)

    # Every generator RNGState captures starts from a seed, so a relaunch
    # that restores them continues exactly where the first run stopped.
    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)
    # A tiny linear-regression model.
    model = torch.nn.Linear(16, 1).to(device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-2)
    progress = StateDict(epoch=0)
    app_state = {"model": model, "optim": optimizer, "progress": progress, "rng": RNGState()}

    # One snapshot path per epoch: a kill mid-take can never tear a
    # committed snapshot (a take commits all or nothing, but overwriting a
    # committed snapshot in place would mix its metadata with new data).
    snapshot_root = args.snapshot_path or tempfile.mkdtemp()
    latest = _latest_epoch_snapshot(snapshot_root)
    if latest is not None:
        Snapshot(latest).restore(app_state, device=device)
        print(f"resumed from epoch {progress['epoch']}")

    while progress["epoch"] < args.epochs:
        x = torch.randn(128, 16, device=device)
        y = x @ torch.ones(16, 1, device=device)
        loss = torch.nn.functional.mse_loss(model(x), y)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        progress["epoch"] += 1
        snapshot = Snapshot.take(os.path.join(snapshot_root, f"epoch_{progress['epoch']}"), app_state)
        print(f"epoch {progress['epoch']}: loss={loss.item():.6f} -> {snapshot.path}")
    print(f"simple_example: done at epoch {progress['epoch']} on {device}")


def _latest_epoch_snapshot(root: str):
    if not os.path.isdir(root):
        return None
    epochs = []
    for name in os.listdir(root):
        if not name.startswith("epoch_") or not os.path.exists(os.path.join(root, name, ".snapshot_metadata")):
            continue
        try:
            epochs.append((int(name.split("_", 1)[1]), name))
        except ValueError:
            continue  # e.g. a checkpoint copied aside as epoch_old/
    return os.path.join(root, max(epochs)[1]) if epochs else None


if __name__ == "__main__":
    main()

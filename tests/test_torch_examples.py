"""The port's examples (``examples/torch/``) run on the CPU with
``--device cpu`` at a small size: each exits 0 and prints its success line,
and ``simple_example.py`` relaunched over its snapshots ends in the state
of an uninterrupted run, bit for bit."""

import os
import subprocess
import sys

import pytest

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.test_utils import check_state_dict_eq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, *args, timeout=240, tmpdir=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TSS_TORCH_")}
    if tmpdir is not None:
        env["TMPDIR"] = tmpdir
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", name), "--device", "cpu", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _snapshot_state(path):
    snap = tts.Snapshot(path)
    return {key: snap.read_object(key, device="cpu") for key in snap.get_manifest() if key.startswith("0/")}


def test_simple_example_resumes_bit_identically(tmp_path):
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    out = _run("simple_example.py", "--snapshot-path", whole, "--epochs", "4")
    assert "simple_example: done at epoch 4 on cpu" in out and "resumed" not in out
    first = _run("simple_example.py", "--snapshot-path", parts, "--epochs", "2")
    assert "done at epoch 2" in first
    second = _run("simple_example.py", "--snapshot-path", parts, "--epochs", "4")
    assert "resumed from epoch 2" in second and "done at epoch 4" in second
    # The relaunch trains epochs 3 and 4 on the same data to the same loss...
    lines = lambda text: [ln.split(" ->")[0] for ln in text.splitlines() if ln.startswith("epoch ")]  # noqa: E731
    assert lines(second) == lines(out)[2:]
    # ...and ends in the same model, optimizer, progress and RNG state.
    got, want = _snapshot_state(os.path.join(parts, "epoch_4")), _snapshot_state(os.path.join(whole, "epoch_4"))
    assert set(got) == set(want) and any(k.startswith("0/optim/") for k in got)
    assert check_state_dict_eq(got, want)


def test_distributed_example_restores_into_another_mesh(tmp_path):
    # Without --root the snapshot goes to a temporary directory that the
    # example removes (torch's own compile cache may stay).
    out = _run("distributed_example.py", tmpdir=str(tmp_path))
    assert [n for n in os.listdir(tmp_path) if not n.startswith("torchinductor_")] == []
    for rank in range(2):
        assert f"rank {rank}: restored step=1 bit-exactly on the transposed mesh (2, 1)" in out
    assert out.rstrip().endswith("distributed_example: done")


@pytest.mark.parametrize("rows,dim", [(1000, 16), (7, 3)])
def test_embedding_example_reshards_and_reads_whole(rows, dim):
    out = _run("embedding_example.py", "--rows", str(rows), "--dim", str(dim))
    for rank in range(2):
        assert f"rank {rank}: restored {rows * dim * 4 / 1e6:.1f} MB as Replicate() bit-exactly" in out
    assert "read_object round-trip OK" in out and out.rstrip().endswith("embedding_example: done")

"""The torch port stands alone: it imports neither JAX nor the JAX package,
reads no knob of the JAX package, and never quietly runs a CUDA request on
the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import torchsnapshot_tpu_torch as tts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "torchsnapshot_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden_module(name: str) -> bool:
    # Exact matches: "torchsnapshot_tpu_torch" starts with the JAX package's
    # name and must not be caught by a prefix test.
    return (
        name == "jax"
        or name.startswith("jax.")
        or name == "torchsnapshot_tpu"
        or name.startswith("torchsnapshot_tpu.")
    )


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports_or_knobs(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            assert not _forbidden_module(name), f"{path}:{node.lineno} imports {name}"
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "TORCHSNAPSHOT_TPU_" not in node.value, f"{path}:{node.lineno}"


def test_forbidden_module_matches_exactly():
    assert _forbidden_module("torchsnapshot_tpu.snapshot")
    assert not _forbidden_module("torchsnapshot_tpu_torch")
    assert not _forbidden_module("torchsnapshot_tpu_torch.snapshot")
    assert not _forbidden_module("jaxlib_like")


def test_importing_the_port_loads_no_jax():
    modules = ["torchsnapshot_tpu_torch"] + [
        "torchsnapshot_tpu_torch." + os.path.relpath(p, PORT)[:-3].replace(os.sep, ".")
        for p in _port_files()
        if p.startswith(PORT) and not p.endswith("__init__.py")
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'torchsnapshot_tpu' or m.startswith('torchsnapshot_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_cuda_default_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    path = str(tmp_path / "ckpt")
    tts.Snapshot.take(path, {"m": tts.StateDict(x=torch.ones(3))})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tts.Snapshot(path).read_object("0/m/x")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tts.Snapshot(path).restore({"m": tts.StateDict()})

"""The torch port stands alone: it imports neither JAX, flax, optax nor
the JAX package, reads no knob of the JAX package, and never quietly runs a
CUDA request on the CPU."""

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
    return name.split(".")[0] in ("jax", "flax", "optax", "torchsnapshot_tpu")


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
    assert _forbidden_module("flax.linen") and _forbidden_module("optax")


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
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'torchsnapshot_tpu'))\n"
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


_MULTI_RANK_MODULES = [
    "torchsnapshot_tpu_torch/parallel/store.py",
    "torchsnapshot_tpu_torch/parallel/coordinator.py",
    "torchsnapshot_tpu_torch/collective_tracer.py",
    "torchsnapshot_tpu_torch/partitioner.py",
    "torchsnapshot_tpu_torch/io_preparers/sharded_array.py",
    "torchsnapshot_tpu_torch/test_utils.py",
]


def test_multi_rank_modules_are_held_to_the_import_rules():
    checked = {os.path.relpath(p, REPO) for p in _port_files()}
    assert set(_MULTI_RANK_MODULES) <= checked


_WORKLOAD_MODULES = [
    "torchsnapshot_tpu_torch/models/transformer.py",
    "torchsnapshot_tpu_torch/models/moe.py",
    "torchsnapshot_tpu_torch/tricks/train_state.py",
    "torchsnapshot_tpu_torch/dryrun.py",
]


def test_workload_modules_are_held_to_the_import_rules():
    checked = {os.path.relpath(p, REPO) for p in _port_files()}
    assert set(_WORKLOAD_MODULES) <= checked


def test_a_single_process_take_stays_light():
    """Resolving the coordinator of a single process and taking a snapshot
    load neither JAX nor DTensor (whose import pulls in sympy)."""
    code = (
        "import sys, tempfile, os, torch\n"
        "import torchsnapshot_tpu_torch as tts\n"
        "from torchsnapshot_tpu_torch.parallel.coordinator import get_coordinator\n"
        "c = get_coordinator()\n"
        "assert (c.get_rank(), c.get_world_size()) == (0, 1)\n"
        "tts.Snapshot.take(os.path.join(tempfile.mkdtemp(), 's'), {'m': tts.StateDict(x=torch.ones(2))})\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'torchsnapshot_tpu', 'torch.distributed.tensor'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_unsupported_placements_raise():
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.placement_types import _StridedShard

    from torchsnapshot_tpu_torch.io_preparers.sharded_array import placement_offsets_sizes

    for placement in (Partial(), _StridedShard(0, split_factor=2)):
        with pytest.raises(NotImplementedError, match="not supported"):
            placement_offsets_sizes((4, 4), (2,), [placement], (0,))


_A11_MODULES = [
    "torchsnapshot_tpu_torch/stream_select.py",
    "torchsnapshot_tpu_torch/take_plan.py",
    "torchsnapshot_tpu_torch/prepare_cache.py",
    "torchsnapshot_tpu_torch/serialization.py",
    "torchsnapshot_tpu_torch/batcher.py",
    "torchsnapshot_tpu_torch/scheduler.py",
    "torchsnapshot_tpu_torch/storage_plugins/fs.py",
]


def test_a11_modules_are_held_to_the_import_rules():
    checked = {os.path.relpath(p, REPO) for p in _port_files()}
    assert set(_A11_MODULES) <= checked


def test_the_uncompressed_only_guard_is_gone():
    """The port reads compressed snapshots: ``ensure_uncompressed`` and its
    call sites were removed, and the codecs run without the JAX package."""
    from torchsnapshot_tpu_torch import serialization

    assert not hasattr(serialization, "ensure_uncompressed")
    for path in _port_files():
        with open(path) as f:
            assert "ensure_uncompressed" not in f.read(), path
    payload, sizes = serialization.compress_framed(b"abc" * 100, "raw_zlib", 1, 64)
    assert len(sizes) == 5 and serialization.decode_framed_payload(payload, "raw_zlib") == b"abc" * 100


def test_a_single_process_take_with_the_caches_stays_light():
    """A compressed take and its prepared-take hit load neither JAX nor
    DTensor."""
    code = (
        "import sys, tempfile, os, torch\n"
        "os.environ['TSS_TORCH_COMPRESSION'] = 'zlib'\n"
        "import torchsnapshot_tpu_torch as tts\n"
        "from torchsnapshot_tpu_torch import snapshot\n"
        "d = tempfile.mkdtemp()\n"
        "for i in range(2):\n"
        "    tts.Snapshot.async_take(os.path.join(d, str(i)), {'m': tts.StateDict(x=torch.ones(2))}).wait()\n"
        "assert snapshot.LAST_TAKE_CACHE['prepared_cache_hit']\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'torchsnapshot_tpu', 'torch.distributed.tensor'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


_A1_A12_MODULES = [
    "torchsnapshot_tpu_torch/native/__init__.py",
    "torchsnapshot_tpu_torch/bcast.py",
    "torchsnapshot_tpu_torch/swarm.py",
    "torchsnapshot_tpu_torch/storage_plugins/cache.py",
    "torchsnapshot_tpu_torch/storage_plugins/memory.py",
]


def test_storage_and_serving_modules_are_held_to_the_import_rules():
    checked = {os.path.relpath(p, REPO) for p in _port_files()}
    assert set(_A1_A12_MODULES) <= checked
    # The engine's C++ source is the port's own copy.
    assert os.path.exists(os.path.join(PORT, "native", "tss_io.cpp"))


def test_a_cached_verified_restore_stays_light():
    """memory://, the read cache, verified reads and the serving modules
    load neither JAX nor the JAX package."""
    code = (
        "import sys, tempfile, os, torch\n"
        "os.environ['TSS_TORCH_READ_CACHE_DIR'] = tempfile.mkdtemp()\n"
        "os.environ['TSS_TORCH_VERIFY_READS'] = 'all'\n"
        "import torchsnapshot_tpu_torch as tts\n"
        "from torchsnapshot_tpu_torch import bcast, swarm, native\n"
        "from torchsnapshot_tpu_torch.storage_plugins import cache, memory\n"
        "native.load_native()\n"
        "x = torch.arange(10.0)\n"
        "tts.Snapshot.take('memory://light', {'m': tts.StateDict(x=x)})\n"
        "t = tts.StateDict(x=torch.zeros(10))\n"
        "tts.Snapshot('memory://light').restore({'m': t}, device='cpu')\n"
        "assert torch.equal(t['x'], x)\n"
        "tts.Snapshot('memory://light').restore({'m': t}, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'torchsnapshot_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr

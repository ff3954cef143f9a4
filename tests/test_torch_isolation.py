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
    # The GPU tests run on a host without JAX (``--noconftest``).
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "test_torch_cuda.py")]
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

    from torchsnapshot_tpu_torch.io_preparers.sharded_array import placement_offsets_sizes

    with pytest.raises(NotImplementedError, match="not supported: a Partial tensor is a pending reduction"):
        placement_offsets_sizes((4, 4), (2,), [Partial()], (0,))


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


_A13_MODULES = [
    "torchsnapshot_tpu_torch/catalog.py",
]


def test_a13_modules_are_held_to_the_import_rules():
    checked = {os.path.relpath(p, REPO) for p in _port_files()}
    assert set(_A13_MODULES) <= checked


def test_a_job_take_and_retention_stay_light():
    """A catalog-managed chain, retention and gc load neither JAX nor the
    JAX package."""
    code = (
        "import sys, tempfile, os, torch\n"
        "import torchsnapshot_tpu_torch as tts\n"
        "from torchsnapshot_tpu_torch import catalog\n"
        "d = tempfile.mkdtemp()\n"
        "for i in range(3):\n"
        "    tts.Snapshot.take(os.path.join(d, f's{i}'), {'m': tts.StateDict(x=torch.ones(2))}, job='j')\n"
        "rep = catalog.retain(d, catalog.RetentionPolicy.parse('last=1'), dry_run=False)\n"
        "assert rep['condemned'] == ['s0', 's1'], rep\n"
        "assert tts.Snapshot.gc(d)['remove'] == []\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'torchsnapshot_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


_A16_MODULES = [
    "torchsnapshot_tpu_torch/telemetry/__init__.py",
    "torchsnapshot_tpu_torch/telemetry/core.py",
    "torchsnapshot_tpu_torch/telemetry/metrics.py",
    "torchsnapshot_tpu_torch/telemetry/export.py",
    "torchsnapshot_tpu_torch/telemetry/progress.py",
    "torchsnapshot_tpu_torch/telemetry/artifact.py",
    "torchsnapshot_tpu_torch/telemetry/aggregate.py",
    "torchsnapshot_tpu_torch/telemetry/recorder.py",
    "torchsnapshot_tpu_torch/telemetry/steprecord.py",
    "torchsnapshot_tpu_torch/telemetry/fleet.py",
    "torchsnapshot_tpu_torch/telemetry/health.py",
    "torchsnapshot_tpu_torch/utils/rss_profiler.py",
    "torchsnapshot_tpu_torch/__main__.py",
]


@pytest.mark.parametrize("module", _A16_MODULES)
def test_a16_modules_are_held_to_the_import_rules(module):
    checked = {os.path.relpath(p, REPO) for p in _port_files()}
    assert module in checked


def test_telemetry_modules_import_no_torch():
    """As in the JAX package, the telemetry layer is stdlib-only at import
    (every layer imports it, so it must not pull torch in first)."""
    code = (
        "import sys, types\n"
        "# A bare package: the port's __init__ (which imports torch) stays out.\n"
        "stub = types.ModuleType('torchsnapshot_tpu_torch')\n"
        "stub.__path__ = ['torchsnapshot_tpu_torch']\n"
        "sys.modules['torchsnapshot_tpu_torch'] = stub\n"
        "import torchsnapshot_tpu_torch.telemetry as t\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_traced_take_and_the_cli_stay_light(tmp_path):
    """A take with a trace, its artifact, and the CLI over it load no JAX."""
    code = (
        "import sys, os, torch\n"
        f"os.environ['TSS_TORCH_TRACE'] = {str(tmp_path / 'trace.json')!r}\n"
        "import torchsnapshot_tpu_torch as tts\n"
        "from torchsnapshot_tpu_torch.__main__ import main\n"
        f"p = {str(tmp_path / 's')!r}\n"
        "tts.Snapshot.take(p, {'m': tts.StateDict(x=torch.ones(2))})\n"
        "assert main(['stats', p]) == 0 and main(['ls', p]) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'torchsnapshot_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(tmp_path / "trace.json")


def test_from_numpy_tree_defaults_to_the_card():
    """The default device is CUDA; on a host without it the call raises the
    port's "not available" error instead of returning CPU tensors."""
    import numpy as np

    from torchsnapshot_tpu_torch.convert import from_numpy_tree

    tree = {"a": np.ones(3, np.float32), "b": {"c": np.arange(2)}}
    if torch.cuda.is_available():
        out = from_numpy_tree(tree)
        assert out["a"].device.type == "cuda" and out["b"]["c"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_numpy_tree(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_numpy_tree({})  # refused before any array is converted
    out = from_numpy_tree(tree, device="cpu")
    assert out["a"].device.type == "cpu" and out["b"]["c"].dtype == torch.int64


_A14_A15_MODULES = [
    "torchsnapshot_tpu_torch/engine/qos.py",
    "torchsnapshot_tpu_torch/engine/executor.py",
    "torchsnapshot_tpu_torch/ledger.py",
]


@pytest.mark.parametrize("module", _A14_A15_MODULES)
def test_a14_a15_modules_are_held_to_the_import_rules(module):
    checked = {os.path.relpath(p, REPO) for p in _port_files()}
    assert module in checked


def test_qos_and_ledger_import_no_torch():
    """The arbiter and the ledger are stdlib modules, like telemetry: the
    engine's QoS layer loads no torch, numpy or JAX of its own."""
    code = (
        "import sys, types\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "stub = types.ModuleType('torchsnapshot_tpu_torch')\n"
        f"stub.__path__ = [{os.path.join(REPO, 'torchsnapshot_tpu_torch')!r}]\n"
        "sys.modules['torchsnapshot_tpu_torch'] = stub\n"
        "eng = types.ModuleType('torchsnapshot_tpu_torch.engine')\n"
        f"eng.__path__ = [{os.path.join(REPO, 'torchsnapshot_tpu_torch', 'engine')!r}]\n"
        "sys.modules['torchsnapshot_tpu_torch.engine'] = eng\n"
        "import torchsnapshot_tpu_torch.engine.qos, torchsnapshot_tpu_torch.ledger\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_A15_A17_MODULES = [
    "torchsnapshot_tpu_torch/storage_plugins/cloud_retry.py",
    "torchsnapshot_tpu_torch/faults.py",
    "torchsnapshot_tpu_torch/effect_journal.py",
    "torchsnapshot_tpu_torch/crash_explorer.py",
    "torchsnapshot_tpu_torch/storage_plugins/gcs.py",
    "torchsnapshot_tpu_torch/storage_plugins/s3.py",
]


@pytest.mark.parametrize("module", _A15_A17_MODULES)
def test_a15_a17_modules_are_held_to_the_import_rules(module):
    checked = {os.path.relpath(p, REPO) for p in _port_files()}
    assert module in checked


def test_a_plain_take_imports_neither_faults_nor_the_journal():
    """With both knobs off, a take and a verified restore load neither the
    fault injector nor the effect journal (nor the cloud SDKs)."""
    code = (
        "import sys, tempfile, os, torch\n"
        "os.environ['TSS_TORCH_VERIFY_READS'] = 'all'\n"
        "import torchsnapshot_tpu_torch as tts\n"
        "d = tempfile.mkdtemp()\n"
        "tts.Snapshot.take(os.path.join(d, 's'), {'m': tts.StateDict(x=torch.ones(2))}, job='j')\n"
        "t = tts.StateDict(x=torch.zeros(2))\n"
        "tts.Snapshot(os.path.join(d, 's')).restore({'m': t}, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.endswith(('.faults', '.effect_journal', '.crash_explorer'))\n"
        "             or m.split('.')[0] in ('jax', 'torchsnapshot_tpu', 'aioboto3') or m == 'google.cloud.storage')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module,sdk", [("gcs", "google"), ("s3", "aioboto3")])
def test_cloud_plugins_import_without_their_sdk(module, sdk):
    """The GPU host has neither SDK: importing the plugin module works, and
    only building a plugin raises, naming the package."""
    code = (
        "import builtins, sys\n"
        "real = builtins.__import__\n"
        f"def block(name, *a, **k):\n"
        f"    if name.split('.')[0] == {sdk!r}:\n"
        "        raise ImportError(name)\n"
        "    return real(name, *a, **k)\n"
        "builtins.__import__ = block\n"
        f"from torchsnapshot_tpu_torch.storage_plugins import {module} as mod\n"
        f"cls = getattr(mod, {('GCSStoragePlugin' if module == 'gcs' else 'S3StoragePlugin')!r})\n"
        "try:\n"
        "    cls('bucket/prefix')\n"
        "except RuntimeError as e:\n"
        f"    assert {('google-cloud-storage' if module == 'gcs' else 'aioboto3')!r} in str(e), e\n"
        "else:\n"
        "    raise AssertionError('built without the SDK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# Mutations that make a commit point: a crash right after one leaves
# whatever it did behind.
_OS_MUTATIONS = {"os.replace", "os.rename", "os.link", "os.remove", "os.unlink"}
_PLUGIN_MUTATIONS = {"write", "sync_write", "delete", "write_stream", "link_in"}
# The injection machinery, the journal and the explorer (which replays into
# directories of its own) are not commit points of the port.
_SURFACE_EXEMPT = {"faults.py", "effect_journal.py", "crash_explorer.py"}


def _commit_points(root=PORT):
    """``{"<file's basename>:<qualname>": line}`` of every top-level
    function or method under ``root`` (the port) that calls an ``os``
    mutation (or hands one to an executor), or a mutating method through a
    receiver whose name says storage or plugin. The key is the static
    analyzer's TSA1004 form; two sites under one key fail."""
    import re

    receiver = re.compile(r"storage|plugin")
    found = {}
    paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py"))
    for path in paths:
        if os.path.basename(path) in _SURFACE_EXEMPT:
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        funcs = []
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.append((node.name, node))
            elif isinstance(node, ast.ClassDef):
                funcs += [(f"{node.name}.{m.name}", m) for m in node.body
                          if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for qual, fn in funcs:
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                names = [ast.unparse(call.func)] + [ast.unparse(a) for a in call.args if isinstance(a, ast.Attribute)]
                hit = any(n in _OS_MUTATIONS for n in names)
                if not hit and isinstance(call.func, ast.Attribute) and call.func.attr in _PLUGIN_MUTATIONS:
                    hit = bool(receiver.search(ast.unparse(call.func.value).lower()))
                if hit:
                    site = f"{os.path.basename(path)}:{qual}"
                    assert site not in found, f"two commit points share the key {site}"
                    found[site] = call.lineno
                    break
    return found


def test_every_commit_point_is_on_the_crash_surface():
    """Every durable mutation in the port sits in a function that
    ``faults._CRASH_SURFACE`` names, each entry names one that exists and
    mutates, and each is pinned to an op class or ``fail-open``."""
    from torchsnapshot_tpu_torch import faults

    surface = dict(faults._CRASH_SURFACE)
    assert len(surface) == len(faults._CRASH_SURFACE), "duplicate crash-surface entries"
    found = _commit_points()
    assert sorted(set(found) - set(surface)) == [], "commit points missing from faults._CRASH_SURFACE"
    assert sorted(set(surface) - set(found)) == [], "stale faults._CRASH_SURFACE entries"
    assert set(surface.values()) <= set(faults._OPS) | {"fail-open"}


def test_the_commit_point_scan_finds_a_planted_mutation(tmp_path):
    """The scan is not vacuous: a module with a rename, a plugin write and
    an executor-run remove is reported whole."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "planted.py").write_text(
        "import os\n\n\nclass W:\n    def land(self, a, b):\n        os.replace(a, b)\n\n"
        "    async def put(self, io):\n        await self.storage.write(io)\n\n\n"
        "async def drop(loop, p):\n    await loop.run_in_executor(None, os.remove, p)\n\n\n"
        "def pure(x):\n    return x.write(1)\n"
    )
    (tmp_path / "faults.py").write_text("import os\n\n\ndef f(a):\n    os.remove(a)\n")
    assert _commit_points(str(tmp_path)) == {
        "planted.py:W.land": 6, "planted.py:W.put": 9, "planted.py:drop": 13,
    }

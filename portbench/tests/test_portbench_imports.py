"""What the harness loads and reads: no module whose top-level name,
compared whole, is ``jax``, ``jaxlib``, ``flax`` or the JAX package
``torchsnapshot_tpu`` (the port's ``torchsnapshot_tpu_torch`` is not one);
nothing under ``benchmarks/``, ``bench.py`` or ``chip_smoke.py``; and the
command's exits without a card or outside a whole checkout."""

import ast
import os
import shutil
import subprocess
import sys

from conftest import ROOT
from portbench.lib import cells, harness

FORBIDDEN = {"jax", "jaxlib", "flax", "torchsnapshot_tpu"}


def _sources():
    for dirpath, dirnames, filenames in os.walk(cells.PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not {n.partition(".")[0] for n in names} & FORBIDDEN, (path, names)


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


def test_no_source_reads_the_jax_benchmarks():
    """No import of them, and no string outside a docstring that names them."""
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert not {a.name.partition(".")[0] for a in node.names} & {"bench", "benchmarks", "chip_smoke"}
            elif isinstance(node, ast.ImportFrom) and node.module:
                assert node.module.partition(".")[0] not in {"bench", "benchmarks", "chip_smoke"}
            elif isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
                if os.path.basename(path) != os.path.basename(__file__):
                    assert not any(n in node.value for n in ("benchmarks", "bench.py", "chip_smoke")), path


def test_loaded_modules_exclude_jax_and_the_jax_package():
    """Everything the command, its readers, operations and states import,
    in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run, portbench.control\n"
        "from portbench.lib import cells, harness, workload, readers\n"
        "import torchsnapshot_tpu_torch\n"
        "b = cells.load_benchmark()\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    cells.reader(m['name'])\n"
        "for w in b['workloads']:\n"
        "    cells.op(cells.traffic(w['traffic'])['op']); cells.state(cells.config(w['config'])['state'])\n"
        "print(sorted({m.partition('.')[0] for m in sys.modules}))\n" % ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=240)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torchsnapshot_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "torchsnapshot_tpu_torch_x", sys)
    assert harness.forbidden_modules() == sorted({m.partition(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def _command(cwd):
    w = cells.load_benchmark()["workloads"][0]["name"]
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", w, "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=240,
    )


def test_command_without_a_card_exits_non_zero_and_prints_no_result():
    out = _command(ROOT)
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]


def test_command_outside_a_checkout_exits_non_zero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]

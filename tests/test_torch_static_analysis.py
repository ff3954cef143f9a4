"""The JAX package's static analyzer (``dev/analyze``) and lint
(``dev/lint.py``), run over the port.

Every pass of ``dev.analyze.core.get_passes()`` runs over
``torchsnapshot_tpu_torch/`` with the port's own knob registry, manifest,
``io_types`` and ``faults`` modules, one case per pass. A finding is
either fixed in the port, suppressed inline with ``# noqa: TSA<code> -
<reason>`` where the JAX package suppresses its counterpart for the same
reason, or listed in ``BASELINE`` below with its reason. A baseline entry
that matches no finding fails, as a stale entry of
``dev/analyze/baseline.json`` does.

Two inputs stay None: the knob catalog (``docs/utilities.md``) and the docs
scanned for dead knob names list only the JAX package's
``TORCHSNAPSHOT_TPU_*`` knobs, which the port does not read (its knobs are
``TSS_TORCH_*``; ``tests/test_torch_capture_modes.py`` pairs the two). The
knob-drift pass still checks that no ``TORCHSNAPSHOT_TPU_*`` name appears
in the port. The telemetry catalog (``docs/observability.md``) is given:
the port records the JAX package's span and metric names.
"""

import glob
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dev.analyze.core import AnalysisContext, get_passes, is_suppressed, iter_py_files, run_passes  # noqa: E402
from dev.lint import lint_file  # noqa: E402

PORT = "torchsnapshot_tpu_torch"

BASELINE = {
    f"{PORT}/crash_explorer.py:TSA1001:bare-open:_ReplayState._materialize": (
        "the crash explorer replays a journal into a scratch directory of its own; "
        "nothing it writes is snapshot state"
    ),
    f"{PORT}/crash_explorer.py:TSA1001:bare-open:_ReplayState.apply_partial": (
        "lands a torn partial payload on purpose: the state a crash leaves, for the "
        "explorer's invariants to be checked on"
    ),
    f"{PORT}/crash_explorer.py:TSA1004:unpinned:crash_explorer.py:_ReplayState.apply": (
        "the explorer's replay is not a commit point of the port (tests/test_torch_isolation.py "
        "exempts crash_explorer.py from the crash surface)"
    ),
    f"{PORT}/dryrun.py:TSA1001:bare-open:_continuous": (
        "plants crash debris on purpose, for Snapshot.gc to sweep"
    ),
    f"{PORT}/kernels.py:TSA1001:bare-open:_build": (
        "opens the build's empty flock file, which is never read; the library lands by os.replace"
    ),
    f"{PORT}/native/__init__.py:TSA1001:bare-open:_build": (
        "opens the build's empty flock file, which is never read; the library lands by os.replace"
    ),
    f"{PORT}/faults.py:TSA1004:stale:fs.py:FSStoragePlugin.delete": (
        "its os.remove runs through an executor, which tests/test_torch_isolation.py's scan "
        "counts as a commit point and the analyzer does not see"
    ),
}


def _context():
    return AnalysisContext(
        root=ROOT,
        lib_files=iter_py_files(ROOT, PORT),
        knobs_path=f"{PORT}/utils/knobs.py",
        catalog_path=None,  # docs/utilities.md lists the JAX package's knobs only
        doc_files=None,  # likewise: they name TORCHSNAPSHOT_TPU_* knobs
        telemetry_catalog_path="docs/observability.md",
        telemetry_exempt_prefixes=(f"{PORT}/telemetry/",),
        manifest_path=f"{PORT}/manifest.py",
        io_types_path=f"{PORT}/io_types.py",
        faults_path=f"{PORT}/faults.py",
    )


@pytest.fixture(scope="module")
def ctx():
    return _context()


def _render(findings):
    return "\n".join(f"{f.render()}  [{f.baseline_id}]" for f in findings)


@pytest.mark.parametrize("name, run", get_passes(), ids=[name for name, _ in get_passes()])
def test_pass_finds_nothing_outside_the_baseline(ctx, name, run):
    findings = [f for f in run(ctx) if not (f.path.endswith(".py") and is_suppressed(f, ctx.lines(f.path)))]
    findings += ctx.parse_failures
    fresh = [f for f in findings if f.baseline_id not in BASELINE]
    assert not fresh, f"{name} over the port:\n{_render(fresh)}"


def test_baseline_entries_are_live_and_give_reasons():
    found = {f.baseline_id for f in run_passes(_context())}
    stale = sorted(set(BASELINE) - found)
    assert not stale, f"stale baseline entries: {stale}"
    assert all(reason.strip() for reason in BASELINE.values())


def test_lint_finds_nothing_in_the_port_its_tests_and_chip_smoke():
    files = sorted(glob.glob(os.path.join(ROOT, PORT, "**", "*.py"), recursive=True))
    files += sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    problems = [f"{os.path.relpath(p, ROOT)}:{line}: {msg}" for p in files for line, msg in lint_file(p)]
    assert len(files) > 100
    assert not problems, "\n".join(problems)

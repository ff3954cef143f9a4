"""``python -m torchsnapshot_tpu_torch`` held against ``python -m torchsnapshot_tpu``.

One bucket holds a job's snapshots, one written by each package, each
restored once. Every subcommand runs through both CLIs on the snapshots of
both writers (mutating ones on copies of the bucket): the exit codes and
the outputs must agree, with timings, ages and pids masked.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import catalog as jcat
from torchsnapshot_tpu.__main__ import main as jax_main

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import catalog as tcat
from torchsnapshot_tpu_torch import telemetry as ttel
from torchsnapshot_tpu_torch.__main__ import main as port_main
from torchsnapshot_tpu_torch.convert import from_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITERS = {"port": "step_1", "jax": "step_2"}


def _tree(step):
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((64, 32)).astype(np.float32),
        "lora": np.full(16, step, np.float32),
        "ids": np.arange(8, dtype=np.int32),
        "step": step,
    }


def _zeros(tree):
    return {k: np.zeros_like(v) if isinstance(v, np.ndarray) else 0 for k, v in tree.items()}


@pytest.fixture(scope="module")
def bucket(tmp_path_factory):
    """step_1 by the port, step_2 by the JAX package (a delta of step_1),
    both of job "j" with step records, each restored once by its writer,
    and a flight-recorder dump of the port's."""
    env = {}
    for prefix in ("TSS_TORCH_", "TORCHSNAPSHOT_TPU_"):
        for knob, value in (("DEDUP_DIGESTS", "1"), ("ENABLE_BATCHING", "1")):
            env[prefix + knob] = value
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    tcat._CHAIN_CACHE.clear()
    jcat._CHAIN_CACHE.clear()
    root = str(tmp_path_factory.mktemp("cli") / "bucket")
    try:
        tts.Snapshot.take(f"{root}/step_1", {"m": tts.StateDict(**from_numpy_tree(_tree(1), device="cpu"))}, job="j", step=1)
        jts.Snapshot.take(f"{root}/step_2", {"m": jts.StateDict(**_tree(2))}, job="j", step=2)
        target = tts.StateDict(**from_numpy_tree(_zeros(_tree(1)), device="cpu"))
        tts.Snapshot(f"{root}/step_1").restore({"m": target}, device="cpu")
        jts.Snapshot(f"{root}/step_2").restore({"m": jts.StateDict(**_zeros(_tree(2)))})
        rec = ttel.recorder.get_recorder()
        rec.dump(f"{root}.recorder.json")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tcat._CHAIN_CACHE.clear()
        jcat._CHAIN_CACHE.clear()
    return root


_MASKS = [
    (re.compile(r"\d+\.\d+"), "<f>"),  # timings, rates, ages
    (re.compile(r"pid \d+"), "pid <p>"),
    (re.compile(r"'pid': \d+"), "'pid': <p>"),
    (re.compile(r"\d+ sample\(s\)"), "<n> sample(s)"),
]


def _mask(text, paths):
    for p in sorted(paths, key=len, reverse=True):
        text = text.replace(p, "<path>")
    for pattern, repl in _MASKS:
        text = pattern.sub(repl, text)
    return text


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv_of, tmp_path, bucket, mutates=False):
    """Run ``argv_of(root)`` through each CLI (on its own copy of the
    bucket when the command mutates it); the masked results."""
    results = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        root = bucket
        if mutates:
            root = str(tmp_path / name / "bucket")
            shutil.copytree(bucket, root)
        rc, out, err = _cli(main, argv_of(root))
        paths = [root, str(tmp_path / "jax.json"), str(tmp_path / "port.json")]
        results.append((rc, _mask(out, paths), _mask(err, paths)))
    return results


READ_ONLY = {
    "ls": lambda s: ["ls", s],
    "cat": lambda s: ["cat", s, "0/m/ids"],
    "cat_subtree": lambda s: ["cat", s, "0/m"],
    "verify": lambda s: ["verify", s],
    "scrub": lambda s: ["scrub", s],
    "scrub_json": lambda s: ["scrub", s, "--json"],
    "stats": lambda s: ["stats", s],
    "stats_restore": lambda s: ["stats", s, "--op", "restore"],
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("cmd", sorted(READ_ONLY))
def test_read_only_subcommands_agree(bucket, tmp_path, cmd, writer):
    snap = f"{bucket}/{WRITERS[writer]}"
    (jrc, jout, jerr), (trc, tout, terr) = _both(lambda _root: READ_ONLY[cmd](snap), tmp_path, bucket)
    assert (trc, tout, terr) == (jrc, jout, jerr)
    assert jrc == 0 and jout


def _trace_rows_unordered(text):
    """``trace`` output with its read rows (between ``read N object(s)``
    and ``metrics:``) sorted: both CLIs list the reads slowest first, and
    with the durations masked that order is the one thing allowed to
    differ from run to run."""
    lines = text.splitlines()
    head = next(i for i, l in enumerate(lines) if l.startswith("read ") and "object(s)" in l)
    tail = next((i for i, l in enumerate(lines) if l == "metrics:"), len(lines))
    return lines[: head + 1] + sorted(lines[head + 1 : tail]) + lines[tail:]


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_trace_agrees(bucket, tmp_path, writer):
    snap = f"{bucket}/{WRITERS[writer]}"
    (jrc, jout, _), (trc, tout, _) = [
        (rc, _mask(out, [snap, str(tmp_path / f"{n}.json")]), err)
        for n, main in (("jax", jax_main), ("port", port_main))
        for rc, out, err in [_cli(main, ["trace", snap, "-o", str(tmp_path / f"{n}.json")])]
    ]
    assert (trc, _trace_rows_unordered(tout)) == (jrc, _trace_rows_unordered(jout)) and jrc == 0
    # Each trace reads through the other package's reader.
    from torchsnapshot_tpu.telemetry import export as jexport

    import json

    with open(tmp_path / "port.json") as f:
        port_trace = json.load(f)
    with open(tmp_path / "jax.json") as f:
        jax_trace = json.load(f)
    assert {s.name for s in jexport.spans_from_chrome_trace(port_trace)} == {
        s.name for s in ttel.spans_from_chrome_trace(jax_trace)
    }


BUCKET_CMDS = {
    "gc": (lambda b: ["gc", b], False),
    "gc_apply": (lambda b: ["gc", b, "--apply"], True),
    "gc_policy": (lambda b: ["gc", b, "--policy", "last=1"], False),
    "catalog_ls": (lambda b: ["catalog", "ls", b], False),
    "catalog_ls_json": (lambda b: ["catalog", "ls", b, "--json"], False),
    "catalog_pin": (lambda b: ["catalog", "pin", b, "step_1"], True),
    "catalog_unpin": (lambda b: ["catalog", "unpin", b, "step_1"], True),
    "catalog_rebuild": (lambda b: ["catalog", "rebuild", b], True),
    "catalog_retain": (lambda b: ["catalog", "retain", b, "--policy", "last=1"], False),
    "catalog_retain_apply": (lambda b: ["catalog", "retain", b, "--policy", "last=1", "--apply"], True),
    "timeline": (lambda b: ["timeline", b, "--job", "j"], False),
    "timeline_json": (lambda b: ["timeline", b, "--job", "j", "--json"], False),
    "compare": (lambda b: ["compare", f"{b}/step_1", f"{b}/step_2"], False),
}


@pytest.mark.parametrize("cmd", sorted(BUCKET_CMDS))
def test_bucket_subcommands_agree(bucket, tmp_path, cmd):
    argv_of, mutates = BUCKET_CMDS[cmd]
    (jrc, jout, jerr), (trc, tout, terr) = _both(argv_of, tmp_path, bucket, mutates)
    assert (trc, tout, terr) == (jrc, jout, jerr)
    assert jrc == 0 and jout


@pytest.mark.parametrize("json_flag", [False, True])
def test_monitor_agrees(bucket, tmp_path, json_flag):
    argv = ["monitor", f"{bucket}.recorder.json"] + (["--json"] if json_flag else [])
    (jrc, jout, _), (trc, tout, _) = _both(lambda _root: argv, tmp_path, bucket)
    assert (trc, tout) == (jrc, jout) and jrc == 0


def test_errors_exit_2_with_one_line(bucket, tmp_path):
    argv = ["cat", f"{bucket}/step_1", "0/m/missing"]
    for main in (jax_main, port_main):
        rc, out, err = _cli(main, argv)
        assert rc == 2 and out == ""
        assert err.startswith("error: KeyError") and err.count("\n") == 1


def test_module_runs_as_a_program(bucket):
    proc = subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch", "stats", f"{bucket}/step_1"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("op=take  world_size=1  ranks_present=1")
    assert "jax" not in proc.stderr

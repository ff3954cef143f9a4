"""Seeded chaos schedules through the port, held against the JAX package.

Counterparts of ``tests/test_chaos.py``'s fast subset. Each case runs the
same fault spec (``TSS_TORCH_FAULTS`` / ``TORCHSNAPSHOT_TPU_FAULTS``) over
the same numpy state, made from a seed, through both packages, and holds
them to the same outcome: a commit, or a ``CheckpointAbortedError`` with
the same rank, phase and injected root cause, the same surviving files
after uuid normalisation, and the same ``gc`` removals. Both packages wrap
a failed take or restore at every world size, world 1 included. Every case
runs under both packages' budget-ledger and collective-lockstep sanitizers,
inherited by child ranks.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import catalog as jcat
from torchsnapshot_tpu import faults as jfaults
from torchsnapshot_tpu.storage_plugin import _resolve_storage_plugin as jresolve
from torchsnapshot_tpu.storage_plugins import cloud_retry as jretry
from torchsnapshot_tpu.test_utils import run_with_processes as jrun_with_processes

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import catalog as tcat
from torchsnapshot_tpu_torch import faults as tfaults
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.snapshot import CheckpointAbortedError as TAborted
from torchsnapshot_tpu_torch.storage_plugin import _resolve_storage_plugin as tresolve
from torchsnapshot_tpu_torch.storage_plugins import cloud_retry as tretry
from torchsnapshot_tpu_torch.test_utils import run_with_processes as trun_with_processes

PKGS = ("jax", "torch")
_PREFIX = {"jax": "TORCHSNAPSHOT_TPU_", "torch": "TSS_TORCH_"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def knobs(**values):
    """Set (or, with None, unset) a knob under both packages' prefixes."""
    saved = {}
    for name, value in values.items():
        for prefix in _PREFIX.values():
            key = prefix + name
            saved[key] = os.environ.get(key)
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = str(value)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


@pytest.fixture(autouse=True)
def _sanitizers_and_fast_backoff(monkeypatch):
    monkeypatch.setattr(jretry, "BASE_BACKOFF_S", 0.001)
    monkeypatch.setattr(tretry, "BASE_BACKOFF_S", 0.001)
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    jcat._CHAIN_CACHE.clear()
    tcat._CHAIN_CACHE.clear()
    with knobs(DEBUG_LEDGER=1, DEBUG_COLLECTIVES=1):
        yield
    jcat._CHAIN_CACHE.clear()
    tcat._CHAIN_CACHE.clear()


# ---------------------------------------------------------------------------
# One package behind one interface
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(512).astype(np.float32), "b": np.arange(64, dtype=np.int64) + seed, "step": seed}


def state(pkg, seed=0):
    if pkg == "jax":
        return {"s": jts.StateDict(_tree(seed))}
    return {"s": tts.StateDict(from_numpy_tree(_tree(seed), device="cpu"))}


def zeros(pkg):
    if pkg == "jax":
        return {"s": jts.StateDict(w=np.zeros(512, np.float32), b=np.zeros(64, np.int64), step=-1)}
    return {"s": tts.StateDict(w=torch.zeros(512), b=torch.zeros(64, dtype=torch.int64), step=-1)}


def snap(pkg):
    return jts.Snapshot if pkg == "jax" else tts.Snapshot


def restore(pkg, url, tgt, **kw):
    if pkg == "jax":
        jts.Snapshot(url).restore(tgt, **kw)
    else:
        tts.Snapshot(url).restore(tgt, device="cpu", **kw)


def assert_restores(pkg, url, seed):
    tgt = zeros(pkg)
    restore(pkg, url, tgt)
    _assert_equal(tgt, seed)


def _assert_equal(tgt, seed):
    want = _tree(seed)
    w, b = tgt["s"]["w"], tgt["s"]["b"]
    w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert np.array_equal(w.view(np.uint8), want["w"].view(np.uint8))
    assert np.array_equal(b, want["b"]) and tgt["s"]["step"] == seed


def listing(pkg, url):
    """Every object under ``url``, through a plugin without wrappers."""
    import asyncio

    plugin = (jresolve if pkg == "jax" else tresolve)(url)
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(plugin.list_prefix(""))
    finally:
        loop.run_until_complete(plugin.close())
        loop.close()


def norm(paths):
    """Paths with their random parts masked: temp-file ids, slab uuids."""
    out = [re.sub(r"\.tmp\.[0-9a-f]{8}", ".tmp.*", p) for p in paths]
    out = [re.sub(r"batched/[0-9a-f-]{8,}", "batched/*", p) for p in out]
    return sorted(out)


def norm_report(report):
    return {k: (norm(v) if isinstance(v, list) and all(isinstance(x, str) for x in v) else v) for k, v in report.items()}


def outcome(pkg, fn):
    """``("commit",)`` or ``("abort", root class, root message, rank,
    phase)`` of ``pkg``'s ``CheckpointAbortedError``; any other error
    propagates."""
    try:
        fn()
        return ("commit",)
    except (jts.CheckpointAbortedError, TAborted) as e:
        assert isinstance(e, TAborted if pkg == "torch" else jts.CheckpointAbortedError), (pkg, e)
        root = e.__cause__ if e.__cause__ is not None else e
        return ("abort", type(root).__name__, str(root), e.rank, e.phase)


def same_abort(j, t):
    """The JAX and port outcomes of one case agree: both commit, or both
    abort with the same root cause, rank and phase."""
    assert j == t, (j, t)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


@pytest.fixture
def gcs_backend(monkeypatch):
    """The fake google.cloud.storage SDK of the JAX package's GCS tests."""
    from test_gcs_storage_plugin import _install_fake_gcs

    blobs: dict = {}
    _install_fake_gcs(monkeypatch, blobs, {})
    return blobs


def backend_url(backend, pkg, tmp_path, request):
    if backend == "fs":
        return str(tmp_path / pkg / "chaos")
    if backend == "memory":
        return f"memory://chaos-{pkg}-{request.node.name}"
    if backend == "gcs":
        return f"gs://bucket/chaos-{pkg}"
    raise AssertionError(backend)


@pytest.fixture
def any_backend(request, tmp_path):
    if request.param == "gcs":
        request.getfixturevalue("gcs_backend")
    return lambda pkg: backend_url(request.param, pkg, tmp_path, request)


# ---------------------------------------------------------------------------
# Takes under faults
# ---------------------------------------------------------------------------


def chaos_round(pkg, parent, spec, expect_abort=True):
    """Commit ``prev``, run a faulted take at ``cur``, hold the crash
    invariants; returns (outcome, files after the fault, gc report)."""
    sep = "" if parent.endswith("/") else "/"
    prev, cur = f"{parent}{sep}prev", f"{parent}{sep}cur"
    snap(pkg).take(prev, state(pkg, 1))
    assert snap(pkg)(prev).verify() == {}
    assert_restores(pkg, prev, 1)
    before = set(listing(pkg, parent))
    with knobs(FAULTS=spec):
        out = outcome(pkg, lambda: snap(pkg).take(cur, state(pkg, 2)))
    after_fault = norm(listing(pkg, parent))
    report = None
    if expect_abort:
        assert out[0] == "abort", (pkg, spec, out)
        assert "cur/.snapshot_metadata" not in listing(pkg, parent)
        assert snap(pkg)(prev).verify() == {}
        assert_restores(pkg, prev, 1)
        if parent.startswith("memory://"):
            report = snap(pkg).gc(cur, dry_run=False)
            assert report["committed"] == [] and listing(pkg, cur) == []
        else:
            report = snap(pkg).gc(parent, dry_run=False)
            assert "prev" in report["committed"], report
        assert set(listing(pkg, parent)) == before
        snap(pkg).take(cur, state(pkg, 2))
        assert snap(pkg)(cur).verify() == {}
        assert_restores(pkg, cur, 2)
    else:
        assert out == ("commit",), (pkg, spec, out)
        assert snap(pkg)(cur).verify() == {}
        assert_restores(pkg, cur, 2)
    return out, after_fault, norm_report(report) if report is not None else None


def both_rounds(url_of, spec, expect_abort=True, exact=True):
    """Both packages through :func:`chaos_round`: the same outcome, files
    and gc report. With ``exact=False`` (a schedule that leaves to the
    thread pool which of two concurrent writes fails first, and how far
    the other got) only the kind of outcome is compared here."""
    j = chaos_round("jax", url_of("jax"), spec, expect_abort)
    t = chaos_round("torch", url_of("torch"), spec, expect_abort)
    assert j[0][0] == t[0][0], (j[0], t[0])
    if exact:
        same_abort(j[0], t[0])
        assert j[1] == t[1], (j[1], t[1])
        assert j[2] == t[2], (j[2], t[2])
    return j, t


@pytest.mark.parametrize("any_backend", ["fs", "memory", "gcs"], indirect=True)
def test_chaos_torn_write_fast(any_backend):
    # Both payload writes of the take are torn; which lands first is up to
    # the thread pool, so the root messages are compared up to the path.
    j, t = both_rounds(any_backend, "op=write,kind=torn,bytes=64,path=0/s", exact=False)
    torn = {f"cur/0/s/{n}.tmp.*" for n in "wb"}
    url = any_backend("jax")
    for out, files, report in (j, t):
        assert out[1] == "InjectedFault" and out[2].startswith("injected torn write after 64 bytes: 0/s/")
        debris = [f for f in files if f.startswith("cur/")]
        # Atomic backends expose nothing; fs leaves temp files, which gc
        # removes (chaos_round checks the bucket is back to its state).
        assert set(debris) <= torn and (debris != []) == ("://" not in url), debris
        assert report["committed"] == ([] if url.startswith("memory://") else ["prev"])


@pytest.mark.parametrize("any_backend", ["fs", "memory"], indirect=True)
def test_chaos_transient_storm_commits_fast(any_backend):
    both_rounds(any_backend, "backoff=0.005;op=write,kind=transient,times=4", expect_abort=False)


def test_chaos_permanent_failure_names_rank_and_phase(tmp_path):
    j, t = both_rounds(lambda p: str(tmp_path / p), "op=write,kind=fail,path=0/s", exact=False)
    assert j[1:] == t[1:]
    assert j[0][3:] == (0, "write")
    for out in (j[0], t[0]):
        assert out[1] == "InjectedFault" and out[2].startswith("injected write failure: 0/s/")


def test_chaos_commit_phase_failure(tmp_path):
    j, t = both_rounds(lambda p: str(tmp_path / p), "op=write,kind=fail,path=.snapshot_metadata")
    assert j[0][4] == "commit"
    assert t[0][2] == "injected write failure: .snapshot_metadata"


def test_chaos_torn_fs_stream_abort_unlinks_temp(tmp_path):
    """A torn append mid-stream: the stream is aborted and its temp file
    unlinked in both packages."""
    big = np.random.default_rng(0).standard_normal(2**16).astype(np.float32)
    outs = {}
    for pkg in PKGS:
        url = str(tmp_path / pkg / "t")
        app = {"s": jts.StateDict(w=big)} if pkg == "jax" else {"s": tts.StateDict(w=torch.from_numpy(big.copy()))}
        with knobs(STREAM_WRITES="on", STREAM_CHUNK_BYTES=4096,
                   FAULTS="op=append,at=2,kind=torn,bytes=100"):
            outs[pkg] = outcome(pkg, lambda: snap(pkg).take(url, app))
        assert not [f for _, _, fs in os.walk(url) for f in fs if ".tmp." in f], pkg
        assert not os.path.exists(os.path.join(url, ".snapshot_metadata"))
    same_abort(outs["jax"], outs["torch"])
    assert outs["torch"][2] == "injected torn append after 100 bytes: 0/s/w"


def test_chaos_budget_credited_on_abort(tmp_path):
    """A write fault mid-pipeline: in-flight work is cancelled and every
    budget debit credited back, in the port as in the JAX package."""
    import asyncio

    from torchsnapshot_tpu.io_preparers.array import ArrayIOPreparer as JPrep
    from torchsnapshot_tpu.scheduler import execute_write_reqs as jexecute

    from torchsnapshot_tpu_torch.io_preparers.array import ArrayIOPreparer as TPrep
    from torchsnapshot_tpu_torch.scheduler import _WritePipeline

    arrays = {f"k{i}": np.random.default_rng(i).standard_normal(1024).astype(np.float32) for i in range(6)}
    spec = "op=write,at=1,kind=fail"
    jplugin = jfaults.FaultyStoragePlugin(jresolve(str(tmp_path / "jax")), jfaults.parse_fault_spec(spec))
    jreqs = [r for name, a in arrays.items() for r in JPrep.prepare_write(name, a)[1]]

    async def jrun():
        pending = await jexecute(jreqs, jplugin, memory_budget_bytes=1 << 20, rank=0)
        with pytest.raises(Exception, match="injected write failure"):
            await pending.complete()
        return pending.budget_balanced

    loop = asyncio.new_event_loop()
    try:
        assert loop.run_until_complete(jrun())
    finally:
        loop.close()

    tplugin = tfaults.FaultyStoragePlugin(tresolve(str(tmp_path / "torch")), tfaults.parse_fault_spec(spec))
    treqs = [r for name, a in arrays.items() for r in TPrep.prepare_write(name, torch.from_numpy(a))[1]]
    pipeline = _WritePipeline(treqs, tplugin, 1 << 20, 0, None)

    async def trun():
        await pipeline.run_until_staged()
        await pipeline.run_to_completion()

    loop = asyncio.new_event_loop()
    try:
        # The fault may land before or after the capture point. Under
        # TSS_TORCH_DEBUG_LEDGER an unbalanced abort raises LedgerLeakError
        # instead of the injected fault.
        with pytest.raises(tfaults.InjectedFault, match="injected write failure"):
            loop.run_until_complete(trun())
        assert pipeline._engine.budget.balanced
    finally:
        loop.close()


def test_chaos_async_take_wait_raises_structured_abort(tmp_path):
    """A write that fails in the background drain: ``async_take`` returns
    and ``wait()`` raises the structured abort. (The sidecar is written
    only in the drain; a CPU tensor's own write may already run, and fail,
    before ``async_take`` returns, in either package.)"""
    outs = {}
    for pkg in PKGS:
        url = str(tmp_path / pkg / "a")
        with knobs(FAULTS="op=write,kind=fail,path=.checksums"):
            pending = snap(pkg).async_take(url, state(pkg))
            outs[pkg] = outcome(pkg, pending.wait)
        assert not os.path.exists(os.path.join(url, ".snapshot_metadata"))
    assert outs["torch"][1:] == ("InjectedFault", "injected write failure: .checksums.0", 0, "write")
    same_abort(outs["jax"], outs["torch"])


def test_chaos_stall_drives_watchdog(tmp_path, caplog):
    """A stall past the watchdog's threshold warns, and the take commits."""
    for pkg in PKGS:
        url = str(tmp_path / pkg / "s")
        caplog.clear()
        with knobs(STALL_WARN_S=0.2, FAULTS="op=write,kind=stall,secs=1.0,path=0/s"):
            with caplog.at_level("WARNING"):
                snap(pkg).take(url, state(pkg))
        assert any("no byte progress" in r.message or "stall" in r.message.lower() for r in caplog.records), pkg
        assert snap(pkg)(url).verify() == {}


_KILL_CHILD = {
    "jax": (
        "import os, numpy as np\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "from torchsnapshot_tpu import Snapshot, StateDict\n"
        "rng = np.random.default_rng(2)\n"
        "Snapshot.take(os.environ['CHAOS_PATH'], {'s': StateDict(\n"
        "    w=rng.standard_normal(512).astype(np.float32),\n"
        "    b=np.arange(64, dtype=np.int64) + 2, step=2)})\n"
    ),
    "torch": (
        "import os, numpy as np, torch\n"
        "from torchsnapshot_tpu_torch import Snapshot, StateDict\n"
        "rng = np.random.default_rng(2)\n"
        "Snapshot.take(os.environ['CHAOS_PATH'], {'s': StateDict(\n"
        "    w=torch.from_numpy(rng.standard_normal(512).astype(np.float32)),\n"
        "    b=torch.arange(64, dtype=torch.int64) + 2, step=2)})\n"
    ),
}


def _child(pkg, code, spec, timeout=120, **env):
    full = dict(os.environ, **env)
    full[_PREFIX[pkg] + "FAULTS"] = spec
    full.pop("TORCHSNAPSHOT_TPU_TRACE", None)
    full.pop("TSS_TORCH_TRACE", None)
    return subprocess.run([sys.executable, "-c", code], env=full, capture_output=True, text=True, cwd=REPO,
                          timeout=timeout)


def test_chaos_kill_mid_write_subprocess(tmp_path):
    """Process death at an injected crash point: the child exits 87, the
    torn take exposes no metadata, gc reclaims the same debris in both
    packages, and a retake commits."""
    leftovers, reports = {}, {}
    for pkg in PKGS:
        parent = str(tmp_path / pkg)
        prev = os.path.join(parent, "prev")
        snap(pkg).take(prev, state(pkg, 1))
        assert_restores(pkg, prev, 1)
        before = set(listing(pkg, parent))
        proc = _child(pkg, _KILL_CHILD[pkg], "op=write,at=1,kind=kill", CHAOS_PATH=os.path.join(parent, "cur"))
        assert proc.returncode == tfaults.KILL_EXIT_CODE, proc.stderr[-2000:]
        leftovers[pkg] = norm(set(listing(pkg, parent)) - before)
        assert "cur/.snapshot_metadata" not in listing(pkg, parent)
        assert_restores(pkg, prev, 1)
        reports[pkg] = norm_report(snap(pkg).gc(parent, dry_run=False))
        assert set(listing(pkg, parent)) == before
        snap(pkg).take(os.path.join(parent, "cur"), state(pkg, 2))
        assert_restores(pkg, os.path.join(parent, "cur"), 2)
    # The two payload writes run side by side: how far the first got
    # before the second one's kill is up to the thread pool, in both
    # packages. The debris is at most those objects or their temp files,
    # and gc removes exactly what there is.
    torn = {f"cur/0/s/{n}{t}" for n in "wb" for t in ("", ".tmp.*")}
    for pkg in PKGS:
        assert set(leftovers[pkg]) <= torn, leftovers
        assert reports[pkg]["remove"] == leftovers[pkg], (pkg, reports[pkg])
        assert reports[pkg]["committed"] == ["prev"]


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------


def _jworker_rank1_write_fails(rank, world_size, shared):
    import numpy as _np

    from torchsnapshot_tpu import CheckpointAbortedError as Aborted, Snapshot as Snap, StateDict as SD

    os.environ["TORCHSNAPSHOT_TPU_BARRIER_TIMEOUT_S"] = "20"
    prev = os.path.join(shared, "prev")
    Snap.take(prev, {"s": SD(v=_np.full(64, rank, _np.float32))})
    if rank == 1:
        os.environ["TORCHSNAPSHOT_TPU_FAULTS"] = "op=write,kind=fail,path=1/s"
    try:
        Snap.take(os.path.join(shared, "cur"), {"s": SD(v=_np.full(64, rank + 10, _np.float32))})
        raise AssertionError("faulted take must not commit")
    except Aborted as e:
        with open(os.path.join(shared, f"abort_{rank}.json"), "w") as f:
            json.dump([e.rank, e.phase, "injected write failure" in str(e)], f)
    assert not os.path.exists(os.path.join(shared, "cur", ".snapshot_metadata"))
    assert Snap(prev).verify() == {}


def _tworker_rank1_write_fails(rank, world_size, shared):
    import torch as _torch

    from torchsnapshot_tpu_torch import Snapshot as Snap, StateDict as SD
    from torchsnapshot_tpu_torch.snapshot import CheckpointAbortedError as Aborted

    os.environ["TSS_TORCH_BARRIER_TIMEOUT_S"] = "20"
    prev = os.path.join(shared, "prev")
    Snap.take(prev, {"s": SD(v=_torch.full((64,), float(rank)))})
    if rank == 1:
        os.environ["TSS_TORCH_FAULTS"] = "op=write,kind=fail,path=1/s"
    try:
        Snap.take(os.path.join(shared, "cur"), {"s": SD(v=_torch.full((64,), float(rank + 10)))})
        raise AssertionError("faulted take must not commit")
    except Aborted as e:
        with open(os.path.join(shared, f"abort_{rank}.json"), "w") as f:
            json.dump([e.rank, e.phase, "injected write failure" in str(e)], f)
    assert not os.path.exists(os.path.join(shared, "cur", ".snapshot_metadata"))
    assert Snap(prev).verify() == {}


@pytest.mark.multiprocess
def test_chaos_multiprocess_abort_names_failing_rank(tmp_path):
    """Rank 1's writes fail: both ranks of both packages raise the
    structured abort naming rank 1 in the write phase; nothing commits."""
    jrun_with_processes(_jworker_rank1_write_fails, nproc=2, args=(str(tmp_path / "jax"),))
    trun_with_processes(_tworker_rank1_write_fails, 2, args=(str(tmp_path / "torch"),), timeout_s=120)
    for r in range(2):
        j = json.load(open(tmp_path / "jax" / f"abort_{r}.json"))
        t = json.load(open(tmp_path / "torch" / f"abort_{r}.json"))
        assert j == t == [1, "write", True], (r, j, t)
    for pkg in PKGS:
        assert not os.path.exists(tmp_path / pkg / "cur" / ".snapshot_metadata")


# ---------------------------------------------------------------------------
# Restores under read faults
# ---------------------------------------------------------------------------


def restore_round(pkg, url, spec, expect_abort, verify="all", cache_dir=None):
    sep = "" if url.endswith("/") else "/"
    snap_url = f"{url}{sep}snap"
    snap(pkg).take(snap_url, state(pkg, 4))
    assert snap(pkg)(snap_url).verify() == {}
    tgt = zeros(pkg)
    with knobs(READ_CACHE_DIR=cache_dir, VERIFY_READS=verify, FAULTS=spec):
        out = outcome(pkg, lambda: restore(pkg, snap_url, tgt))
    if expect_abort:
        assert out[0] == "abort", (pkg, spec, out)
        if pkg == "jax":
            assert out[4].startswith("restore."), out
    else:
        assert out == ("commit",), (pkg, spec, out)
        _assert_equal(tgt, 4)
    assert snap(pkg)(snap_url).verify() == {}
    assert_restores(pkg, snap_url, 4)
    return out


def both_restores(url_of, spec, expect_abort, **kw):
    j = restore_round("jax", url_of("jax"), spec, expect_abort, **kw)
    t = restore_round("torch", url_of("torch"), spec, expect_abort, **kw)
    return j, t


@pytest.mark.parametrize("any_backend", ["fs", "memory"], indirect=True)
def test_chaos_restore_transient_read_storm_fast(any_backend):
    both_restores(any_backend, "backoff=0.005;op=read,kind=transient,times=3", expect_abort=False)


def test_chaos_restore_permanent_read_fault_aborts(tmp_path):
    j, t = both_restores(lambda p: str(tmp_path / p), "op=read,kind=fail,path=0/s/w", expect_abort=True)
    assert j[3:] == (0, "restore.read")
    same_abort(j, t)


def test_chaos_restore_corrupt_aborts_under_verification(tmp_path):
    """Persistent rot under VERIFY_READS=all: the verified re-fetch is
    corrupt too, and both packages refuse to load it."""
    j, t = both_restores(lambda p: str(tmp_path / p), "op=read,kind=corrupt,path=0/s/w", expect_abort=True)
    for out in (j, t):
        assert out[1] == "ReadVerificationError" and "0/s/w" in out[2] and "verification twice" in out[2]


def test_chaos_restore_corrupt_oneshot_healed_by_refetch(tmp_path):
    both_restores(lambda p: str(tmp_path / p), "op=read,kind=corrupt,path=0/s,at=0", expect_abort=False)


def test_chaos_restore_corrupt_through_cache(tmp_path):
    """One corrupt origin read with the read cache in the stack: the
    mismatch quarantines the entry, the re-fetch heals, and a second
    restore is served clean from the cache."""
    for pkg in PKGS:
        cache_dir = str(tmp_path / pkg / "cache")
        restore_round(pkg, str(tmp_path / pkg / "o"), "op=read,kind=corrupt,path=0/s,at=0", False, cache_dir=cache_dir)
        with knobs(READ_CACHE_DIR=cache_dir):
            assert_restores(pkg, str(tmp_path / pkg / "o" / "snap"), 4)


def test_chaos_restore_unverified_corrupt_is_the_documented_gap(tmp_path):
    """VERIFY_READS=off: persistent rot loads silently in both packages,
    and the same bytes flip (one seeded RNG each)."""
    got = {}
    for pkg in PKGS:
        url = str(tmp_path / pkg / "snap")
        snap(pkg).take(url, state(pkg, 4))
        tgt = zeros(pkg)
        with knobs(VERIFY_READS="off", FAULTS="op=read,kind=corrupt,path=0/s/w"):
            restore(pkg, url, tgt)
        w = tgt["s"]["w"]
        got[pkg] = (w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)).tobytes()
    assert got["jax"] == got["torch"] != _tree(4)["w"].tobytes()


# ---------------------------------------------------------------------------
# The swarm under peer-serve faults (two ranks)
# ---------------------------------------------------------------------------


def _swarm_state(pkg, shared):
    path = os.path.join(shared, "ckpt")
    w, v = np.arange(100000, dtype=np.float32), np.arange(50000, dtype=np.float64)
    if pkg == "jax":
        from torchsnapshot_tpu import Snapshot as Snap, StateDict as SD

        app, tgt = SD(w=w, v=v), SD(w=np.zeros_like(w), v=np.zeros_like(v))
    else:
        from torchsnapshot_tpu_torch import Snapshot as Snap, StateDict as SD

        app = SD(w=torch.from_numpy(w.copy()), v=torch.from_numpy(v.copy()))
        tgt = SD(w=torch.zeros(100000), v=torch.zeros(50000, dtype=torch.float64))
    os.environ[_PREFIX[pkg] + "HASH_CHUNK_BYTES"] = "65536"
    os.environ[_PREFIX[pkg] + "DEDUP_DIGESTS"] = "1"
    Snap.take(path, {"app": app}, replicated=["app/*"])
    os.environ.pop(_PREFIX[pkg] + "HASH_CHUNK_BYTES")
    return Snap, path, (w, v), tgt


def _swarm_restore(pkg, Snap, path, tgt, deadline_s=None):
    env = {"SWARM_RESTORE": "1", "BCAST_MAX_BYTES": "1024"}
    if deadline_s is not None:
        env["SWARM_CHUNK_DEADLINE_S"] = str(deadline_s)
    for k, v in env.items():
        os.environ[_PREFIX[pkg] + k] = v
    if pkg == "jax":
        Snap(path).restore({"app": tgt})
    else:
        Snap(path).restore({"app": tgt}, device="cpu")


def _swarm_diag(pkg):
    if pkg == "jax":
        from torchsnapshot_tpu import swarm as swarm_mod
    else:
        from torchsnapshot_tpu_torch import swarm as swarm_mod
    return dict(swarm_mod.LAST_RESTORE_SWARM)


def _np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _worker_swarm_peer_killed(rank, world_size, pkg, shared):
    os.environ[_PREFIX[pkg] + "BARRIER_TIMEOUT_S"] = "8"
    os.environ["TORCHSNAPSHOT_TPU_LAUNCHER_DRAIN_S"] = "1"
    Snap, path, (w, v), tgt = _swarm_state(pkg, shared)
    if rank == 1:
        os.environ[_PREFIX[pkg] + "FAULTS"] = "op=peer_serve,kind=kill"
    t0 = time.monotonic()
    try:
        _swarm_restore(pkg, Snap, path, tgt, deadline_s=0.5)
        raise AssertionError("the restore must abort: a peer died mid-swarm")
    except Exception as e:  # noqa: BLE001 - checked below
        assert type(e).__name__ in ("CheckpointAbortedError", "BarrierTimeout", "BarrierError"), repr(e)
        assert time.monotonic() - t0 < 60
    # The survivor holds every byte before the structured abort.
    assert np.array_equal(_np_of(tgt["w"]), w) and np.array_equal(_np_of(tgt["v"]), v)
    d = _swarm_diag(pkg)
    assert d["reelections"] + d["direct_fallbacks"] >= 1, d
    with open(os.path.join(shared, f"survivor_{rank}.json"), "w") as f:
        json.dump({"type": type(e).__name__}, f)


def _run_pair(pkg, fn, shared, timeout_s=120):
    if pkg == "jax":
        jrun_with_processes(fn, nproc=2, args=(pkg, shared))
    else:
        trun_with_processes(fn, 2, args=(pkg, shared), timeout_s=timeout_s)


@pytest.mark.multiprocess
@pytest.mark.parametrize("pkg", PKGS)
def test_chaos_swarm_peer_death_mid_serve(tmp_path, pkg):
    """Rank 1 dies at its first peer-serve point: the survivor re-elects or
    reads directly, holds every byte, and still aborts (the fleet lost a
    rank) in both packages."""
    shared = str(tmp_path / pkg)
    os.makedirs(shared)
    with pytest.raises(RuntimeError) as exc_info:
        _run_pair(pkg, _worker_swarm_peer_killed, shared)
    msg = str(exc_info.value)
    assert "rank 1" in msg and f"(exitcode {tfaults.KILL_EXIT_CODE})" in msg, msg
    assert os.path.exists(os.path.join(shared, "survivor_0.json"))


def _worker_swarm_corrupt_peer(rank, world_size, pkg, shared):
    Snap, path, (w, v), tgt = _swarm_state(pkg, shared)
    if rank == 1:
        os.environ[_PREFIX[pkg] + "FAULTS"] = "op=peer_serve,kind=corrupt"
    os.environ[_PREFIX[pkg] + "VERIFY_READS"] = "all"
    _swarm_restore(pkg, Snap, path, tgt)
    assert np.array_equal(_np_of(tgt["w"]), w) and np.array_equal(_np_of(tgt["v"]), v)
    d = _swarm_diag(pkg)
    with open(os.path.join(shared, f"diag_{rank}.json"), "w") as f:
        json.dump({"peer_verify_failures": d["peer_verify_failures"],
                   "from": sorted({c["from_rank"] for c in d["peer_corruptions"]})}, f)


@pytest.mark.multiprocess
def test_chaos_swarm_corrupt_peer_chunk_caught_and_attributed(tmp_path):
    """Rank 1 serves rotten chunks (its own copy stays clean): rank 0's
    chunk check catches every one, blames rank 1 and reads it directly; the
    same chunks fail in both packages."""
    diags = {}
    for pkg in PKGS:
        shared = str(tmp_path / pkg)
        os.makedirs(shared)
        _run_pair(pkg, _worker_swarm_corrupt_peer, shared)
        diags[pkg] = [json.load(open(os.path.join(shared, f"diag_{r}.json"))) for r in range(2)]
    assert diags["jax"] == diags["torch"], diags
    d0, d1 = diags["torch"]
    assert d0["peer_verify_failures"] >= 1 and d0["from"] == [1] and d1["peer_verify_failures"] == 0


def _worker_swarm_stalled_peer(rank, world_size, pkg, shared):
    Snap, path, (w, v), tgt = _swarm_state(pkg, shared)
    if rank == 0:
        os.environ[_PREFIX[pkg] + "FAULTS"] = "op=peer_serve,kind=stall,secs=2,times=1"
    _swarm_restore(pkg, Snap, path, tgt, deadline_s=0.3)
    assert np.array_equal(_np_of(tgt["w"]), w) and np.array_equal(_np_of(tgt["v"]), v)
    with open(os.path.join(shared, f"diag_{rank}.json"), "w") as f:
        json.dump({"reelections": _swarm_diag(pkg)["reelections"]}, f)


@pytest.mark.multiprocess
@pytest.mark.parametrize("pkg", PKGS)
def test_chaos_swarm_stalled_peer_hits_chunk_deadline(tmp_path, pkg):
    shared = str(tmp_path / pkg)
    os.makedirs(shared)
    _run_pair(pkg, _worker_swarm_stalled_peer, shared)
    diags = [json.load(open(os.path.join(shared, f"diag_{r}.json"))) for r in range(2)]
    assert sum(d["reelections"] for d in diags) >= 1, diags


# ---------------------------------------------------------------------------
# Retention gc under delete faults
# ---------------------------------------------------------------------------


def _chain_state(pkg, step):
    tree = {"frozen": np.arange(2000, dtype=np.float32), "lora": np.full((64,), step, np.float32), "step": step}
    if pkg == "jax":
        return {"s": jts.StateDict(tree)}
    return {"s": tts.StateDict(from_numpy_tree(tree, device="cpu"))}


def _take_chain(pkg, bucket, n):
    for i in range(n):
        snap(pkg).take(f"{bucket}/step_{i}", _chain_state(pkg, i), job="chaos", step=i)


def _assert_chain(pkg, bucket, steps):
    for step in steps:
        if pkg == "jax":
            out = jts.StateDict()
            jts.Snapshot(f"{bucket}/step_{step}").restore({"s": out})
        else:
            out = tts.StateDict(frozen=torch.zeros(2000), lora=torch.zeros(64), step=-1)
            tts.Snapshot(f"{bucket}/step_{step}").restore({"s": out}, device="cpu")
        assert out["step"] == step
        assert np.array_equal(_np_of(out["frozen"]), np.arange(2000, dtype=np.float32))
        assert np.array_equal(_np_of(out["lora"]), np.full((64,), step, np.float32))
        assert snap(pkg)(f"{bucket}/step_{step}").verify() == {}


def retention_round(pkg, bucket, spec, expect_raise):
    cat = jcat if pkg == "jax" else tcat
    _take_chain(pkg, bucket, 5)
    policy = cat.RetentionPolicy.parse("last=2")
    with knobs(FAULTS=spec):
        try:
            cat.retain(bucket, policy, dry_run=False)
            raised = None
        except Exception as e:  # noqa: BLE001 - compared across packages
            raised = (type(e).__name__, str(e))
    assert (raised is not None) == expect_raise, (pkg, raised)
    _assert_chain(pkg, bucket, [3, 4])
    cat.retain(bucket, policy, dry_run=False)
    _assert_chain(pkg, bucket, [3, 4])
    with cat.Catalog(bucket) as c:
        assert [r.name for r in c.load()] == ["step_3", "step_4"]
    third = cat.retain(bucket, policy, dry_run=False)
    assert third["condemned"] == [] and third["removed"] == 0, third
    # Which deletes of the faulted wave landed is up to the thread pool;
    # the converged bucket is not.
    return raised, norm(p for p in listing(pkg, bucket) if ".telemetry/" not in p)


def test_chaos_retention_gc_permanent_delete_fault(tmp_path):
    j = retention_round("jax", str(tmp_path / "jax"), "op=delete,at=2,kind=fail", True)
    t = retention_round("torch", str(tmp_path / "torch"), "op=delete,at=2,kind=fail", True)
    assert "injected delete failure" in j[0][1] and "injected delete failure" in t[0][1], (j[0], t[0])
    assert j[1] == t[1]


def test_chaos_retention_gc_transient_delete_storm(tmp_path):
    spec = "backoff=0.005;op=delete,kind=transient,times=4"
    j = retention_round("jax", str(tmp_path / "jax"), spec, False)
    t = retention_round("torch", str(tmp_path / "torch"), spec, False)
    assert j[1] == t[1]


_RETAIN_CHILD = {
    "jax": (
        "import os\nos.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "from torchsnapshot_tpu import catalog\n"
        "catalog.retain(os.environ['CHAOS_BUCKET'], catalog.RetentionPolicy.parse('last=2'), dry_run=False)\n"
    ),
    "torch": (
        "import os\n"
        "from torchsnapshot_tpu_torch import catalog\n"
        "catalog.retain(os.environ['CHAOS_BUCKET'], catalog.RetentionPolicy.parse('last=2'), dry_run=False)\n"
    ),
}


def test_chaos_retention_gc_kill_mid_delete_subprocess(tmp_path):
    """A retention run killed at its fourth delete: the retained snapshots
    whole, and a re-run converges to the same bucket in both packages."""
    left = {}
    for pkg in PKGS:
        cat = jcat if pkg == "jax" else tcat
        bucket = str(tmp_path / pkg / "bkt")
        _take_chain(pkg, bucket, 5)
        proc = _child(pkg, _RETAIN_CHILD[pkg], "op=delete,at=3,kind=kill", CHAOS_BUCKET=bucket)
        assert proc.returncode == tfaults.KILL_EXIT_CODE, proc.stderr[-2000:]
        _assert_chain(pkg, bucket, [3, 4])
        policy = cat.RetentionPolicy.parse("last=2")
        cat.retain(bucket, policy, dry_run=False)
        _assert_chain(pkg, bucket, [3, 4])
        with cat.Catalog(bucket) as c:
            assert [r.name for r in c.load()] == ["step_3", "step_4"]
        assert sorted(d for d in os.listdir(bucket) if d != cat.CATALOG_DIR) == ["step_3", "step_4"]
        report = cat.retain(bucket, policy, dry_run=False)
        assert report["condemned"] == [] and report["removed"] == 0
        left[pkg] = norm(p for p in listing(pkg, bucket) if ".telemetry/" not in p)
    assert left["jax"] == left["torch"], left


def test_chaos_torn_catalog_append_never_fails_commit(tmp_path):
    """A torn catalog record at commit: the snapshot stays committed, the
    record is missing until rebuild, in both packages."""
    for pkg in PKGS:
        cat = jcat if pkg == "jax" else tcat
        bucket = str(tmp_path / pkg / "bkt")
        with knobs(FAULTS="op=write,kind=torn,bytes=8,path=.catalog/records"):
            s = snap(pkg).take(f"{bucket}/step_0", _chain_state(pkg, 0), job="chaos", step=0)
        assert s.verify() == {}
        _assert_chain(pkg, bucket, [0])
        with cat.Catalog(bucket) as c:
            assert c.load() == []
            assert [r.name for r in c.rebuild()] == ["step_0"]


# ---------------------------------------------------------------------------
# A foreground restore beside a faulted background drain
# ---------------------------------------------------------------------------


def test_chaos_foreground_restore_rides_through_drain_write_fault(tmp_path):
    outs = {}
    for pkg in PKGS:
        fg, bg = str(tmp_path / pkg / "fg"), str(tmp_path / pkg / "bg")
        snap(pkg).take(fg, state(pkg, 3))
        with knobs(QOS_POLL_S=0.005, FAULTS="op=write,kind=fail,path=.checksums"):
            pending = snap(pkg).async_take(bg, state(pkg, 4), qos="background")
            tgt = zeros(pkg)
            restore(pkg, fg, tgt, qos="foreground")
            _assert_equal(tgt, 3)
            outs[pkg] = outcome(pkg, pending.wait)
        if pkg == "jax":
            assert pending._pending_io_work.budget_balanced
        else:
            assert pending._pending_io_work._pipeline._engine.budget.balanced
        assert not os.path.exists(os.path.join(bg, ".snapshot_metadata"))
        assert snap(pkg)(fg).verify() == {}
    assert outs["torch"][3:] == (0, "write")
    same_abort(outs["jax"], outs["torch"])


def test_chaos_foreground_transient_storm_under_background_drain(tmp_path):
    for pkg in PKGS:
        fg, bg = str(tmp_path / pkg / "fg"), str(tmp_path / pkg / "bg")
        snap(pkg).take(fg, state(pkg, 5))
        with knobs(QOS_POLL_S=0.005):
            pending = snap(pkg).async_take(bg, state(pkg, 6), qos="background")
            # The drain's plugin was built before the spec: only the
            # restore's reads are faulted.
            with knobs(FAULTS="backoff=0.005;op=read,kind=transient,times=3"):
                assert_restores(pkg, fg, 5)
            pending.wait()
        assert snap(pkg)(bg).verify() == {}
        assert_restores(pkg, bg, 6)


_BG_KILL_CHILD = {
    "jax": (
        "import os, numpy as np\nos.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "from torchsnapshot_tpu import Snapshot, StateDict\n"
        "rng = np.random.default_rng(2)\n"
        "state = {'s': StateDict(w=rng.standard_normal(512).astype(np.float32), b=np.arange(64, dtype=np.int64) + 2, step=2)}\n"
        "pending = Snapshot.async_take(os.environ['CHAOS_BG'], state, qos='background')\n"
        "tgt = {'s': StateDict(w=np.zeros(512, np.float32), b=np.zeros(64, np.int64), step=-1)}\n"
        "Snapshot(os.environ['CHAOS_FG']).restore(tgt, qos='foreground')\n"
        "pending.wait()\n"
    ),
    "torch": (
        "import os, numpy as np, torch\n"
        "from torchsnapshot_tpu_torch import Snapshot, StateDict\n"
        "rng = np.random.default_rng(2)\n"
        "state = {'s': StateDict(w=torch.from_numpy(rng.standard_normal(512).astype(np.float32)), b=torch.arange(64) + 2, step=2)}\n"
        "pending = Snapshot.async_take(os.environ['CHAOS_BG'], state, qos='background')\n"
        "tgt = {'s': StateDict(w=torch.zeros(512), b=torch.zeros(64, dtype=torch.int64), step=-1)}\n"
        "Snapshot(os.environ['CHAOS_FG']).restore(tgt, device='cpu', qos='foreground')\n"
        "pending.wait()\n"
    ),
}


def test_chaos_kill_mid_background_drain_with_foreground_restore(tmp_path):
    for pkg in PKGS:
        parent = str(tmp_path / pkg)
        fg = os.path.join(parent, "fg")
        snap(pkg).take(fg, state(pkg, 1))
        proc = _child(pkg, _BG_KILL_CHILD[pkg], "op=write,kind=kill,path=0/s", CHAOS_BG=os.path.join(parent, "bg"),
                      CHAOS_FG=fg, **{_PREFIX[pkg] + "QOS_POLL_S": "0.005"})
        assert proc.returncode == tfaults.KILL_EXIT_CODE, (pkg, proc.returncode, proc.stderr[-1500:])
        assert not os.path.exists(os.path.join(parent, "bg", ".snapshot_metadata"))
        assert snap(pkg)(fg).verify() == {}
        assert_restores(pkg, fg, 1)
        snap(pkg).gc(parent, dry_run=False)
        snap(pkg).take(os.path.join(parent, "bg2"), state(pkg, 7))
        assert_restores(pkg, os.path.join(parent, "bg2"), 7)


# ---------------------------------------------------------------------------
# The derived and local fault classes
# ---------------------------------------------------------------------------


def test_catalog_append_fault_class_fires_fail_open(tmp_path):
    for pkg in PKGS:
        cat = jcat if pkg == "jax" else tcat
        bucket = str(tmp_path / pkg / "bkt")
        with knobs(FAULTS="op=catalog_append,kind=fail,times=10"):
            snap(pkg).take(f"{bucket}/step_1", state(pkg, 1), job="j")
        assert os.path.exists(os.path.join(bucket, "step_1", ".snapshot_metadata"))
        assert_restores(pkg, f"{bucket}/step_1", 1)
        with cat.Catalog(bucket) as c:
            assert c.load() == []
        snap(pkg).take(f"{bucket}/step_2", state(pkg, 2), job="j")
        with cat.Catalog(bucket) as c:
            assert [r.name for r in c.load()] == ["step_2"]


def test_steprecord_append_fault_class_fires_fail_open(tmp_path):
    for pkg in PKGS:
        cat = jcat if pkg == "jax" else tcat
        bucket = str(tmp_path / pkg / "bkt")
        with knobs(FAULTS="op=steprecord_append,kind=fail,times=10"):
            snap(pkg).take(f"{bucket}/step_1", state(pkg, 1), job="j")
        with cat.Catalog(bucket) as c:
            assert [r.name for r in c.load()] == ["step_1"]
        assert not any(files for _, _, files in os.walk(os.path.join(bucket, cat.STEP_TELEMETRY_DIR)))
        assert_restores(pkg, f"{bucket}/step_1", 1)


@pytest.mark.parametrize("mod", [jfaults, tfaults], ids=["jax", "torch"])
def test_cache_bitmap_fault_class_reaches_local_injector(mod):
    """Derived and local classes match only rules that name them."""
    with knobs(FAULTS="op=cache_bitmap,kind=fail"):
        with pytest.raises(mod.InjectedFault):
            mod.maybe_inject_local("cache_bitmap", "objs/x.bitmap")
    with knobs(FAULTS="op=any,kind=fail"):
        mod.maybe_inject_local("cache_bitmap", "objs/x.bitmap")
    mod.maybe_inject_local("cache_bitmap", "objs/x.bitmap")


def test_cache_bitmap_rename_is_a_kill_point_of_the_port(tmp_path):
    """The port's read cache reaches the point: a ranged populate of a
    sparse entry fails at its bitmap rename under the rule, fail-open for
    the restore, and a rule that does not name the class leaves it alone."""
    from torchsnapshot_tpu_torch.storage_plugins import cache as tcache

    url = str(tmp_path / "snap")
    tts.Snapshot.take(url, state("torch", 4))
    cache = tcache.CachedStoragePlugin(tresolve(url), url, cache_dir=str(tmp_path / "cache"))
    with knobs(FAULTS="op=cache_bitmap,kind=fail"):
        with pytest.raises(tfaults.InjectedFault, match="cache_bitmap"):
            cache._replace_bitmap(os.path.join(str(tmp_path / "cache"), "x.bitmap"), b"\x01\x00")
    with knobs(FAULTS="op=write,kind=fail"):
        cache._replace_bitmap(os.path.join(str(tmp_path / "cache"), "x.bitmap"), b"\x01\x00")
    assert open(os.path.join(str(tmp_path / "cache"), "x.bitmap"), "rb").read() == b"\x01\x00"


@pytest.mark.parametrize("pkg", PKGS)
def test_beacon_fault_class_fails_open(pkg):
    """A fault at the fleet beacon's publish counts as a publish failure and
    never raises into the operation."""
    if pkg == "jax":
        from torchsnapshot_tpu.telemetry import fleet
        from torchsnapshot_tpu.parallel.store import LocalStore
    else:
        from torchsnapshot_tpu_torch.telemetry import fleet
        from torchsnapshot_tpu_torch.parallel.store import LocalStore
    bus = fleet.FleetBus(LocalStore(), None, rank=0, world_size=1, interval_s=0.0)
    with knobs(FAULTS="op=beacon,kind=fail,times=2"):
        assert bus.publish(force=True) is False
        assert bus.publish(force=True) is False
        assert bus.publish(force=True) is True
    assert (bus.publishes, bus.publish_failures) == (1, 2)

"""The port's transient retries and fault grammar, held against the JAX
package's.

- ``test_transient_oserror_retried``: a stale NFS handle (``ESTALE``) in the
  middle of a take, a restore or a ranged fetch is retried by both packages,
  and the result is bit-exact;
- the same spec strings parse to the same rules, and malformed ones fail in
  both;
- a scripted op sequence over ``memory://`` gets the same injection indices
  and the same corrupt offsets in both (one ``random.Random(seed)`` each,
  drawn in the same order);
- ``retry_transient`` clamps its backoff to the progress window.
"""

import asyncio
import dataclasses
import errno
import os
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import faults as jfaults
from torchsnapshot_tpu.io_types import ReadIO as JReadIO, ReadReq as JReadReq, StoragePlugin as JStoragePlugin
from torchsnapshot_tpu.io_types import WriteIO as JWriteIO
from torchsnapshot_tpu.scheduler import execute_read_reqs as jexecute_read_reqs
from torchsnapshot_tpu.storage_plugin import _resolve_storage_plugin as jresolve
from torchsnapshot_tpu.storage_plugins import cloud_retry as jretry
from torchsnapshot_tpu.storage_plugins import fs as jfs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import faults as tfaults
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.io_types import BufferConsumer, ReadReq as TReadReq, StoragePlugin as TStoragePlugin
from torchsnapshot_tpu_torch.io_types import ReadIO as TReadIO, WriteIO as TWriteIO
from torchsnapshot_tpu_torch.scheduler import execute_read_reqs as texecute_read_reqs
from torchsnapshot_tpu_torch.storage_plugin import _resolve_storage_plugin as tresolve
from torchsnapshot_tpu_torch.storage_plugins import cloud_retry as tretry
from torchsnapshot_tpu_torch.storage_plugins import fs as tfs


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    monkeypatch.setattr(jretry, "BASE_BACKOFF_S", 0.001)
    monkeypatch.setattr(tretry, "BASE_BACKOFF_S", 0.001)


def _tree():
    rng = np.random.default_rng(3)
    return {
        "w": rng.standard_normal((64, 33)).astype(np.float32),
        "b": np.arange(100, dtype=np.int64),
        "h": rng.standard_normal(257).astype(np.float16),
        "step": 7,
    }


def _jzeros():
    return {"s": jts.StateDict(w=np.zeros((64, 33), np.float32), b=np.zeros(100, np.int64),
                               h=np.zeros(257, np.float16), step=-1)}


def _tzeros():
    return {"s": tts.StateDict(w=torch.zeros(64, 33), b=torch.zeros(100, dtype=torch.int64),
                               h=torch.zeros(257, dtype=torch.float16), step=-1)}


def _assert_tree(got, want):
    for k, v in want.items():
        g = got[k]
        if isinstance(v, np.ndarray):
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            assert g.dtype == v.dtype and np.array_equal(g.view(np.uint8), v.view(np.uint8)), k
        else:
            assert g == v, k


def _stale_once(pkg, method, monkeypatch):
    """Patch the fs plugin's inner ``method`` (``write`` or ``read``) of one
    package to raise ``OSError(ESTALE)`` on its first call; returns the
    call counter."""
    calls = {"raised": 0, "calls": 0}
    mod = jfs if pkg == "jax" else tfs
    name = f"_{method}_inner" if pkg == "jax" else f"_{method}_file"
    orig = getattr(mod.FSStoragePlugin, name)

    def should_raise():
        calls["calls"] += 1
        if calls["raised"] == 0:
            calls["raised"] += 1
            return True
        return False

    if pkg == "jax":
        async def patched(self, *args, **kwargs):
            if should_raise():
                raise OSError(errno.ESTALE, "Stale file handle")
            return await orig(self, *args, **kwargs)
    else:
        def patched(self, *args, **kwargs):
            if should_raise():
                raise OSError(errno.ESTALE, "Stale file handle")
            return orig(self, *args, **kwargs)
    monkeypatch.setattr(mod.FSStoragePlugin, name, patched)
    return calls


def _take(pkg, path):
    if pkg == "jax":
        jts.Snapshot.take(path, {"s": jts.StateDict(_tree())})
    else:
        tts.Snapshot.take(path, {"s": tts.StateDict(from_numpy_tree(_tree(), device="cpu"))})


def _restore(pkg, path):
    if pkg == "jax":
        tgt = _jzeros()
        jts.Snapshot(path).restore(tgt)
    else:
        tgt = _tzeros()
        tts.Snapshot(path).restore(tgt, device="cpu")
    _assert_tree(tgt["s"], _tree())


class _FlakyRanged:
    """A plugin with no retry of its own: the first ranged read raises a
    transient OSError; only the read pipeline's fetch can heal it."""

    def __init__(self, inner):
        self.inner = inner
        self.failures = 0

    async def write(self, write_io):
        await self.inner.write(write_io)

    async def read(self, read_io):
        if read_io.byte_range is not None and self.failures == 0:
            self.failures += 1
            raise OSError(errno.ESTALE, "stale handle (ranged)")
        await self.inner.read(read_io)

    async def delete(self, path):
        await self.inner.delete(path)

    async def close(self):
        await self.inner.close()


class _JFlaky(_FlakyRanged, JStoragePlugin):
    pass


class _TFlaky(_FlakyRanged, TStoragePlugin):
    async def write_stream(self, path):
        return await self.inner.write_stream(path)


def _ranged(pkg, root):
    payload = bytes(range(200)) * 10
    got = {}
    if pkg == "jax":
        plugin = _JFlaky(jresolve(root))

        class Consumer:
            def get_consuming_cost_bytes(self):
                return 64

            async def consume_buffer(self, buf, executor=None):
                got["data"] = bytes(buf)

        async def run():
            await plugin.write(JWriteIO(path="obj", buf=payload))
            await jexecute_read_reqs(
                [JReadReq(path="obj", buffer_consumer=Consumer(), byte_range=(100, 164))],
                plugin, memory_budget_bytes=1 << 20, rank=0,
            )

        _run(run())
    else:
        plugin = _TFlaky(tresolve(root))

        class Consumer(BufferConsumer):
            def get_consuming_cost_bytes(self):
                return 64

            async def consume_buffer(self, buf, executor=None):
                got["data"] = bytes(buf)

        from concurrent.futures import ThreadPoolExecutor

        async def run():
            await plugin.write(TWriteIO(path="obj", buf=payload))
            with ThreadPoolExecutor(2) as ex:
                await texecute_read_reqs(
                    [TReadReq(path="obj", buffer_consumer=Consumer(), byte_range=(100, 164))],
                    plugin, 1 << 20, ex,
                )

        _run(run())
    assert plugin.failures == 1, "the transient fault never fired"
    assert got["data"] == payload[100:164]


@pytest.mark.parametrize("case", ["take", "restore", "ranged"])
def test_transient_oserror_retried(tmp_path, monkeypatch, case):
    """A stale NFS handle once, mid-take, mid-restore or in a ranged fetch
    of a plugin with no retry of its own: both packages finish, bit-exact."""
    for pkg in ("jax", "torch"):
        root = str(tmp_path / pkg)
        path = os.path.join(root, "s")
        if case == "take":
            calls = _stale_once(pkg, "write", monkeypatch)
            _take(pkg, path)
            assert calls["raised"] == 1 and calls["calls"] >= 2, (pkg, calls)
            monkeypatch.undo()
            # Committed, verified, and readable by the other package too.
            assert jts.Snapshot(path).verify() == {} and tts.Snapshot(path).verify() == {}
            _restore("jax", path)
            _restore("torch", path)
            assert not [f for _, _, fs in os.walk(root) for f in fs if ".tmp." in f]
        elif case == "restore":
            _take(pkg, path)
            calls = _stale_once(pkg, "read", monkeypatch)
            _restore(pkg, path)
            assert calls["raised"] == 1, (pkg, calls)
            monkeypatch.undo()
        else:
            _ranged(pkg, root)


# ---------------------------------------------------------------------------
# The grammar
# ---------------------------------------------------------------------------

_SPECS = [
    "seed=42;backoff=0.01;window=3.5;op=write,at=2,kind=torn,bytes=128;"
    "op=append,kind=transient,times=3,rank=1;op=read,p=0.25,kind=stall,secs=0.5,path=.snapshot_metadata",
    "op=write,every=3,kind=transient,times=6;op=append,at=1,kind=transient",
    "seed=0;backoff=0.01;op=write,every=3,kind=transient,times=6;op=append,at=1,kind=transient",
    "op=read,at=2,kind=corrupt,bytes=8",
    "op=read,after=0,kind=corrupt,path=0/s/w",
    "op=read,kind=corrupt,chunk=3,bytes=2",
    "op=peer_serve,kind=corrupt,bytes=4;op=peer_serve,kind=stall,secs=0.2",
    "op=catalog_append,kind=fail;op=steprecord_append,kind=kill,at=0",
    "op=cache_bitmap,kind=fail;op=beacon,kind=transient,times=2",
    "op=any,kind=fail,p=0.5;op=link,kind=fail;op=list,kind=transient",
    " ; op=delete,at=0,kind=kill ;",
    "op=write,path=.snapshot_metadata,kind=fail",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_spec_parses_to_the_same_rules(spec):
    j, t = jfaults.parse_fault_spec(spec), tfaults.parse_fault_spec(spec)
    assert (j.seed, j.backoff_s, j.window_s) == (t.seed, t.backoff_s, t.window_s)
    assert [dataclasses.asdict(r) for r in j.rules] == [dataclasses.asdict(r) for r in t.rules]


_BAD = [
    "op=write",
    "op=write,kind=banana",
    "op=teleport,kind=fail",
    "op=write,kind=fail,whatever=1",
    "op=read,kind=torn,bytes=4",
    "op=write,kind=corrupt",
    "op=write,kind=fail,chunk=1",
    "op=write,kind=fail,at=x",
    "op=write,kind=fail,at=1,at=2",
    "notakeyvalue",
    "seed=1,window=bad",
    "seed=1,color=red",
    "op=write,kind=",
]


@pytest.mark.parametrize("spec", _BAD)
def test_malformed_specs_fail_in_both(spec):
    with pytest.raises(jfaults.FaultSpecError) as je:
        jfaults.parse_fault_spec(spec)
    with pytest.raises(tfaults.FaultSpecError) as te:
        tfaults.parse_fault_spec(spec)
    assert str(je.value) == str(te.value)


def test_every_plugin_op_is_guarded_or_declared_passthrough():
    """Every op of the plugin interface is overridden by the wrapper; those
    without an injection point are exactly ``_PASSTHROUGH_OPS``."""
    import inspect

    ops = [n for n, f in vars(TStoragePlugin).items() if inspect.iscoroutinefunction(f)]
    assert sorted(ops) == ["close", "delete", "link_in", "list_prefix", "prune_empty", "read", "write", "write_stream"]
    for name in ops:
        impl = vars(tfaults.FaultyStoragePlugin).get(name)
        assert impl is not None, name
        guarded = "_guard(" in inspect.getsource(impl)
        assert guarded != (name in tfaults._PASSTHROUGH_OPS), name


def test_the_grammar_and_constants_agree():
    assert tfaults._OPS == jfaults._OPS
    assert tfaults._KINDS == jfaults._KINDS
    assert tfaults._DERIVED_WRITE_OPS == jfaults._DERIVED_WRITE_OPS
    assert tfaults._PASSTHROUGH_OPS == jfaults._PASSTHROUGH_OPS
    assert tfaults.KILL_EXIT_CODE == jfaults.KILL_EXIT_CODE == 87
    assert tretry.TRANSIENT_OS_ERRNOS == jretry.TRANSIENT_OS_ERRNOS
    assert (tretry.BASE_BACKOFF_S, tretry.MAX_BACKOFF_S, tretry.PROGRESS_WINDOW_S) == (
        jretry.BASE_BACKOFF_S, jretry.MAX_BACKOFF_S, jretry.PROGRESS_WINDOW_S)
    from torchsnapshot_tpu_torch import catalog

    assert tfaults._CATALOG_RECORD_PREFIX == catalog.RECORD_DIR + "/"
    assert tfaults._STEP_TELEMETRY_PREFIX == catalog.STEP_TELEMETRY_DIR + "/"


# ---------------------------------------------------------------------------
# The schedule over a scripted op sequence
# ---------------------------------------------------------------------------

_SCRIPT_SPECS = [
    "seed=7;op=write,p=0.5,kind=fail,times=100",
    "seed=7;op=read,p=0.3,kind=corrupt,bytes=3,times=100;op=write,every=4,kind=fail,times=100",
    "seed=1;op=read,kind=corrupt,chunk=1,bytes=2;op=delete,after=3,kind=fail",
    "seed=5;op=any,p=0.2,kind=fail,times=50;op=catalog_append,at=1,kind=fail",
    "seed=9;op=read,at=2,kind=corrupt,bytes=8;op=list,every=2,kind=fail,times=9",
]


def _script(pkg, spec, name):
    """64 scripted ops against a memory:// store; returns per op whether it
    failed, and the bytes every read returned."""
    if pkg == "jax":
        resolve, fault_mod, WriteIO, ReadIO = jresolve, jfaults, JWriteIO, JReadIO
    else:
        resolve, fault_mod, WriteIO, ReadIO = tresolve, tfaults, TWriteIO, TReadIO
    inner = resolve(f"memory://faults-{pkg}-{name}")
    plugin = fault_mod.FaultyStoragePlugin(inner, fault_mod.parse_fault_spec(spec))
    rng = np.random.default_rng(0)
    payloads = {f"obj{i}": bytes(rng.integers(0, 256, 700, dtype=np.uint8)) for i in range(8)}
    out = []

    async def run():
        for p, data in payloads.items():
            await inner.write(WriteIO(path=p, buf=data))
        for i in range(64):
            kind = i % 5
            p = f"obj{i % 8}"
            try:
                if kind == 0:
                    await plugin.write(WriteIO(path=p, buf=payloads[p]))
                    out.append(("write", "ok"))
                elif kind == 1:
                    rio = ReadIO(path=p)
                    await plugin.read(rio)
                    buf = rio.buf.getvalue() if pkg == "jax" else bytes(rio.buf)
                    out.append(("read", buf))
                elif kind == 2:
                    rio = ReadIO(path=p, byte_range=(100, 600))
                    await plugin.read(rio)
                    buf = rio.buf.getvalue() if pkg == "jax" else bytes(rio.buf)
                    out.append(("ranged", buf))
                elif kind == 3:
                    await plugin.write(WriteIO(path=f".catalog/records/j/{i}.json", buf=b"{}"))
                    out.append(("catalog", "ok"))
                else:
                    out.append(("list", len(await plugin.list_prefix("obj"))))
                    if i % 3 == 0:
                        await plugin.delete(f".catalog/records/j/{i - 1}.json")
                        out.append(("delete", "ok"))
            except Exception as e:  # noqa: BLE001 - the schedule is the result
                out.append(("fault", type(e).__name__, str(e)))

    _run(run())
    return out, [r.injected for r in plugin.plan.rules]


@pytest.mark.parametrize("spec", _SCRIPT_SPECS)
def test_scripted_schedule_and_corrupt_offsets_agree(spec, monkeypatch):
    with monkeypatch.context() as m:
        m.setenv("TORCHSNAPSHOT_TPU_HASH_CHUNK_BYTES", "256")
        m.setenv("TSS_TORCH_HASH_CHUNK_BYTES", "256")
        name = str(abs(hash(spec)))
        j = _script("jax", spec, name)
        t = _script("torch", spec, name)
    assert t == j
    assert any(x[0] == "fault" for x in j[0]) or any(
        x[0] in ("read", "ranged") and x[1] != b"" for x in j[0]
    )


def test_corrupt_never_touches_the_store():
    """memory:// hands out its stored object: the corrupt flips go to a
    private copy, and the next clean read is intact."""
    inner = tresolve("memory://faults-pristine")
    plugin = tfaults.FaultyStoragePlugin(inner, tfaults.parse_fault_spec("op=read,at=0,kind=corrupt,bytes=5"))

    async def run():
        await inner.write(TWriteIO(path="o", buf=bytes(range(256))))
        a, b = TReadIO(path="o"), TReadIO(path="o")
        await plugin.read(a)
        await plugin.read(b)
        return bytes(a.buf), bytes(b.buf)

    bad, good = _run(run())
    assert bad != bytes(range(256)) and good == bytes(range(256))


# ---------------------------------------------------------------------------
# The retry loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [jretry, tretry], ids=["jax", "torch"])
def test_retry_backoff_clamped_to_progress_window(mod):
    """A huge base backoff is clamped to the window's remaining time and the
    window is checked again after the sleep: the loop gives up within about
    the window, not after a full backoff period."""
    progress = mod.CollectiveProgress(window_s=0.3)
    attempts = []

    async def always_transient():
        attempts.append(time.monotonic())
        raise ConnectionError("flaky")

    async def drive():
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            await mod.retry_transient(
                always_transient, lambda e: isinstance(e, ConnectionError), progress, "clamptest",
                base_backoff_s=30.0,
            )
        return time.monotonic() - t0

    elapsed = _run(drive())
    assert elapsed < 2.0, f"gave up after {elapsed:.2f}s (window 0.3s)"
    assert len(attempts) >= 1


def test_retries_count_and_permanent_errors_do_not_retry():
    from torchsnapshot_tpu_torch import telemetry

    progress = tretry.CollectiveProgress()
    seen = []

    async def flaky():
        seen.append(1)
        if len(seen) < 3:
            raise OSError(errno.ETIMEDOUT, "timed out")
        return "done"

    async def permanent():
        seen.append(2)
        raise OSError(errno.ENOSPC, "full")

    tm = telemetry.Telemetry()
    prev = telemetry.activate(tm)
    try:
        assert _run(tretry.retry_transient(flaky, tretry.is_transient_os_error, progress, "FS")) == "done"
    finally:
        telemetry.deactivate(tm, prev)
    assert tm.metrics.as_dict()["cloud_retry.fs.retries"] == 2
    with pytest.raises(OSError):
        _run(tretry.retry_transient(permanent, tretry.is_transient_os_error, progress, "fs"))
    assert seen.count(2) == 1

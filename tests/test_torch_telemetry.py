"""The port's telemetry layer held against the JAX package's.

The same numpy tree, made from a seed, goes through both packages with the
same knobs; their sessions must record the same span and metric names
(apart from the listed differences), the port's Chrome trace must read
through the JAX package's reader, the derived views must equal what the
session recorded, and an untraced take must allocate nothing in the
telemetry modules.
"""

import asyncio
import inspect
import json
import logging
import os
import time
import tracemalloc

import numpy as np
import pytest

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import telemetry as jtel
from torchsnapshot_tpu.telemetry import export as jexport

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import snapshot as tsnap
from torchsnapshot_tpu_torch import telemetry as ttel
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.engine.intervals import measure, merge_intervals

# Span names only one package records, and why:
# - the take phases: the port keeps the phase names its LAST_TAKE_PHASES
#   always had (flatten, fingerprint, ..., rng_restore), where the JAX
#   package's are gather_keys_and_flatten, prepare_write, partition, ...;
#   both record the d2h_hint phase and its stage.prepare.d2h_hint bucket;
# - stage.prepare.plan: the port's prepare is one stager-construction pass
#   (stage.prepare.stager_construction, which the JAX package also has).
PHASES_JAX_ONLY = {
    "gather_keys_and_flatten",
    "prepare_write",
    "partition",
    "manifest_gather",
    "memory_budget",
    "stage.prepare.plan",
}
PHASES_PORT_ONLY = {
    "flatten",
    "fingerprint",
    "prepare",
    "plan",
    "stage_until_capture_point",
    "rng_restore",
}
# Port-only spans a session records only where they happen, so the sets
# compared leave them out:
# - host.gil_wait: the port's interpreter-lock probe, which an explicit
#   session runs, records a span only for a wake late by more than the
#   switch interval;
# - stage.pin_alloc: the D2H lanes' pinned allocations, none on the CPU.
SPANS_PORT_ONLY_WHEN_SEEN = {"host.gil_wait", "stage.pin_alloc"}
# The probe's counter, which every probed pipeline creates at its start.
METRICS_PORT_ONLY = {"host.gil_wait_s"}


@pytest.fixture(autouse=True)
def _same_knobs(monkeypatch):
    # tests/conftest.py pins the JAX package's digests; pin the port's too.
    for prefix in ("TSS_TORCH_", "TORCHSNAPSHOT_TPU_"):
        monkeypatch.setenv(prefix + "DEDUP_DIGESTS", "1")
        monkeypatch.setenv(prefix + "ENABLE_BATCHING", "1")


def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((128, 64)).astype(np.float32),
        "b": rng.standard_normal(16).astype(np.float32),
        "ids": np.arange(12, dtype=np.int64),
        "step": 3,
    }


def _port_state(tree):
    return {"m": tts.StateDict(**from_numpy_tree(tree, device="cpu"))}


def _jax_state(tree):
    return {"m": jts.StateDict(**{k: v.copy() if isinstance(v, np.ndarray) else v for k, v in tree.items()})}


def _names(tm):
    return {s.name for s in tm.spans()}, set(tm.metrics.as_dict())


def _run(pkg, op, root):
    """One operation of ``pkg`` ("jax" or "port") under an explicit session."""
    mod, state = (jts, _jax_state) if pkg == "jax" else (tts, _port_state)
    tree = _tree()
    tm = mod.telemetry.Telemetry()
    path = os.path.join(root, f"{pkg}_{op}")
    if op == "take":
        mod.Snapshot.take(path, state(tree), _telemetry=tm)
    elif op == "async_take":
        mod.Snapshot.async_take(path, state(tree), _telemetry=tm).wait()
    else:
        mod.Snapshot.take(path, state(tree))
        target = state({k: np.zeros_like(v) if isinstance(v, np.ndarray) else 0 for k, v in tree.items()})
        if pkg == "jax":
            mod.Snapshot(path).restore(target, _telemetry=tm)
        else:
            mod.Snapshot(path).restore(target, device="cpu", _telemetry=tm)
    return tm


@pytest.mark.parametrize("op", ["take", "async_take", "restore"])
def test_span_and_metric_names_match_jax(tmp_path, op):
    jspans, jmetrics = _names(_run("jax", op, str(tmp_path)))
    tspans, tmetrics = _names(_run("port", op, str(tmp_path)))
    assert jspans - tspans == (PHASES_JAX_ONLY if op != "restore" else set())
    assert tspans - jspans - SPANS_PORT_ONLY_WHEN_SEEN == (PHASES_PORT_ONLY if op != "restore" else set())
    assert tmetrics == jmetrics | METRICS_PORT_ONLY


def test_chrome_trace_reads_through_jax(tmp_path, monkeypatch):
    trace = str(tmp_path / "trace.json")
    monkeypatch.setenv("TSS_TORCH_TRACE", trace)
    tts.Snapshot.take(str(tmp_path / "s"), _port_state(_tree()))
    with open(trace) as f:
        obj = json.load(f)
    assert obj["otherData"]["format_version"] == jexport.TRACE_FORMAT_VERSION
    jspans = jexport.spans_from_chrome_trace(obj)
    tspans = ttel.spans_from_chrome_trace(obj)
    assert [(s.name, s.cat, s.span_id, s.parent_id) for s in jspans] == [
        (s.name, s.cat, s.span_id, s.parent_id) for s in tspans
    ]
    names = {s.name for s in jspans}
    assert {"scheduler.stage", "scheduler.io", "storage.write", "take.commit", "stage.hash"} <= names
    assert jexport.metrics_from_chrome_trace(obj)["storage.fs.write_bytes"] > 0
    # And the round trip: the live session and the parsed trace agree.
    live = tts.Snapshot.last_telemetry
    assert sorted(s.name for s in live.spans()) == sorted(s.name for s in tspans)


def test_take_views_are_derived_from_the_session(tmp_path):
    tm = ttel.Telemetry()
    tts.Snapshot.take(str(tmp_path / "s"), _port_state(_tree()), _telemetry=tm)
    phases = tm.spans(cat="take.phase")
    want = {}
    for sp in phases:
        want[sp.name] = want.get(sp.name, 0.0) + sp.dur
    assert tsnap.LAST_TAKE_PHASES == pytest.approx(want)
    assert tsnap.LAST_TAKE_CACHE == {
        "plan_cache_hit": False,
        "prepared_cache_hit": any(s.name == "stage.prepare.cache_hit" for s in phases),
    }
    # The drain stats are the merged scheduler.io spans, clipped to the drain.
    stats = tsnap.LAST_SYNC_DRAIN_STATS
    io = merge_intervals([(s.ts, s.ts + s.dur) for s in tm.spans(name="scheduler.io")])
    assert stats["io_busy_s"] <= measure(io) + 1e-9
    assert stats["io_busy_s"] > 0


def test_prepared_cache_hit_view(tmp_path):
    state = _port_state(_tree())
    for i in range(2):
        tm = ttel.Telemetry()
        tts.Snapshot.take(str(tmp_path / f"s{i}"), state, _telemetry=tm)
        hit = any(s.name == "stage.prepare.cache_hit" for s in tm.spans())
        assert tsnap.LAST_TAKE_CACHE["prepared_cache_hit"] is hit
    assert hit  # the second take of one structure rebinds the cached stagers


def test_progress_ends_at_the_payload(tmp_path):
    pending = tts.Snapshot.async_take(str(tmp_path / "a"), _port_state(_tree()))
    first = pending.progress()
    pending.wait()
    done = pending.progress()
    assert done["bytes_written"] == done["bytes_total"] > 0
    assert done["requests_done"] == done["requests_total"]
    assert done["bytes_written"] >= first["bytes_written"] and done["eta_s"] == 0.0


def test_span_disabled_is_shared_noop():
    assert ttel.get_active() is None
    assert ttel.span("x", cat="y", a=1) is ttel.NOOP_SPAN
    with ttel.span("x") as sp:
        sp.set_attrs(b=2)
    ttel.counter_add("c")  # no session: nothing to record into


def test_untraced_take_records_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("TSS_TORCH_TELEMETRY_ARTIFACTS", "0")
    monkeypatch.setenv("TSS_TORCH_RECORDER", "0")
    monkeypatch.setenv("TSS_TORCH_FLEET_TELEMETRY", "0")
    ttel.recorder.reset()
    ttel.fleet.reset()
    state = _port_state(_tree())
    tts.Snapshot.take(str(tmp_path / "warm"), state)  # imports, caches
    before = tts.Snapshot.last_telemetry
    tel_dir = os.path.dirname(ttel.__file__)
    tracemalloc.start()
    try:
        tts.Snapshot.take(str(tmp_path / "s"), state)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
        ttel.recorder.reset()
        ttel.fleet.reset()
    # Kept whether or not a session is on, as in the JAX package: the
    # pipeline's ProgressTracker (PendingSnapshot.progress()) and the
    # PhaseTracker that LAST_TAKE_PHASES is a view of. Nothing else of the
    # telemetry modules may allocate: no span, no metric, no sample.
    lines, first = inspect.getsourcelines(ttel.PhaseTracker)
    core_py = inspect.getsourcefile(ttel.PhaseTracker)
    progress_py = inspect.getsourcefile(ttel.ProgressTracker)

    def allowed(frame):
        return frame.filename == progress_py or (
            frame.filename == core_py and first <= frame.lineno < first + len(lines)
        )

    in_telemetry = [
        (st.traceback[0].filename, st.traceback[0].lineno, st.size)
        for st in snap.statistics("lineno")
        if st.traceback[0].filename.startswith(tel_dir) and not allowed(st.traceback[0])
    ]
    assert in_telemetry == []
    assert not os.path.exists(tmp_path / "s" / ".telemetry")
    assert ttel.get_active() is None
    assert tts.Snapshot.last_telemetry is before


@pytest.mark.parametrize("samples", [[0.5, 1.0, 3.0, 3.0, 100.0], [0.0, 1e-6, 2.5e9], [7.0]])
def test_histogram_matches_jax(samples):
    jreg, treg = jtel.MetricsRegistry(), ttel.MetricsRegistry()
    for v in samples:
        jreg.histogram("h").observe(v)
        treg.histogram("h").observe(v)
        jreg.gauge("g").set(v)
        treg.gauge("g").set(v)
        jreg.counter("c").add(v)
        treg.counter("c").add(v)
    assert treg.as_dict() == jreg.as_dict()


def test_stall_watchdog_fires_on_a_faked_stall(tmp_path, monkeypatch, caplog):
    """A storage write that hangs past TSS_TORCH_STALL_WARN_S: one warning
    naming the stuck stage, counted in scheduler.stall_warnings."""
    from torchsnapshot_tpu_torch.storage_plugins import fs

    real_write = fs.FSStoragePlugin.write

    async def slow_write(self, write_io):
        if not write_io.path.startswith("."):
            await asyncio.sleep(0.4)  # a wedged disk: no byte moves
        await real_write(self, write_io)

    monkeypatch.setattr(fs.FSStoragePlugin, "write", slow_write)
    monkeypatch.setenv("TSS_TORCH_STALL_WARN_S", "0.1")
    tm = ttel.Telemetry()
    with caplog.at_level(logging.WARNING, logger="torchsnapshot_tpu_torch.telemetry.progress"):
        tts.Snapshot.take(str(tmp_path / "s"), _port_state(_tree()), _telemetry=tm)
    assert tm.metrics.as_dict().get("scheduler.stall_warnings", 0) >= 1
    warned = [r for r in caplog.records if "snapshot drain stalled" in r.getMessage()]
    assert warned
    payload = json.loads(warned[0].getMessage().split(": ", 1)[1])
    assert payload["stuck_stage"] == "io" and payload["event"] == "snapshot_stall"


def test_stall_watchdog_thread_mode_matches_jax():
    for mod in (ttel, jtel):
        tracker = mod.ProgressTracker()
        fired = []
        watchdog = mod.StallWatchdog(tracker, 0.05, on_fire=lambda: fired.append(1))
        thread, stop = mod.watchdog_thread(watchdog)
        time.sleep(0.3)
        stop.set()
        thread.join()
        assert watchdog.fired == 1 and fired == [1]  # once per stall


def test_recorder_samples_the_engines(tmp_path, monkeypatch):
    dump = str(tmp_path / "rec.json")
    monkeypatch.setenv("TSS_TORCH_RECORDER_INTERVAL_S", "0")
    monkeypatch.setenv("TSS_TORCH_RECORDER_DUMP", dump)
    ttel.recorder.reset()
    try:
        tts.Snapshot.take(str(tmp_path / "s"), _port_state(_tree()))
        rec = ttel.recorder.get_recorder()
        samples = rec.series("engine.sample")
        rec.dump(dump)
    finally:
        ttel.recorder.reset()
    assert {s["engine"] for s in samples} >= {"write"}
    assert all({"occupancy", "budget_hwm", "bytes_done"} <= set(s) for s in samples)
    with open(dump) as f:
        assert json.load(f)["samples"]


def test_traced_checkpoint_drive_on_the_cpu(tmp_path):
    """chip_smoke.py phase 8 (a) at a CPU size: the traced async checkpoint
    of the trainer and its restore, read back by ``dryrun.trace_report``."""
    from torchsnapshot_tpu_torch import dryrun
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16)
    out = dryrun.traced_checkpoint(cfg, str(tmp_path / "root"), str(tmp_path), device="cpu", batch=2)
    take = dryrun.trace_report(out["traces"]["take"])
    restore = dryrun.trace_report(out["traces"]["restore"])
    assert take["phases"] == pytest.approx(out["take_phases"], abs=1e-6)
    assert take["dropped_spans"] == take["spans_dropped_metric"] == 0
    assert take["d2h_bytes"] == out["d2h_bytes"] == 0  # CPU tensors cross no D2H
    assert take["hash_busy_s"] > 0 and take["write_busy_s"] > 0
    assert take["span_counts"]["scheduler.stage"] == take["span_counts"]["scheduler.io"] - 1  # + the sidecar
    assert restore["read_busy_s"] > 0 and restore["span_counts"]["scheduler.consume"] > 0
    assert restore["span_counts"]["restore.load_stateful"] == 4

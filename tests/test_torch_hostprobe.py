"""The interpreter-lock probe (``telemetry/hostprobe.py``), the pinned
allocation spans of the D2H lanes and the memory plugin's write span.

The probe must see a C call that holds the interpreter lock, stay quiet
beside a thread that only sleeps, run only for a session that asked to
trace, and end with its pipeline, on commit and on abort. The last test
needs a CUDA device. This file imports neither JAX nor the JAX package.
"""

import asyncio
import gc
import threading
import time

import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import d2h, scheduler, telemetry
from torchsnapshot_tpu_torch.engine.intervals import merge_intervals
from torchsnapshot_tpu_torch.io_types import WriteIO
from torchsnapshot_tpu_torch.storage_plugins import memory
from torchsnapshot_tpu_torch.telemetry import hostprobe
from torchsnapshot_tpu_torch.utils import knobs


def _state():
    g = torch.Generator().manual_seed(0)
    return {"m": tts.StateDict(w=torch.randn(256, 128, generator=g), b=torch.randn(64, generator=g), step=3)}


def _probe_threads():
    return [t for t in threading.enumerate() if t.name == hostprobe.THREAD_NAME]


def _held_call_n(at_least_s: float = 0.4) -> int:
    """An ``n`` for which ``sum(range(n))``, one C call that never releases
    the interpreter lock, takes at least ``at_least_s`` here."""
    n = 1 << 20
    while True:
        t0 = time.monotonic()
        sum(range(n))
        if time.monotonic() - t0 >= at_least_s:
            return n
        n *= 2


def _covered_s(tm, lo, hi):
    spans = tm.spans(name=hostprobe.SPAN)
    merged = merge_intervals([(s.ts, s.ts + s.dur) for s in spans])
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


@pytest.fixture
def untraced(monkeypatch):
    """Artifacts on (their session exists), no trace asked for."""
    monkeypatch.delenv("TSS_TORCH_TRACE", raising=False)
    monkeypatch.setenv("TSS_TORCH_TELEMETRY_ARTIFACTS", "1")


class _Starts:
    """Counts the probes the pipelines start and the probe threads alive
    at each start."""

    def __init__(self, monkeypatch):
        self.started = 0
        self.alive_at_start = []
        real = hostprobe.HostProbe.start

        def start(probe):
            out = real(probe)
            self.started += 1
            self.alive_at_start.append(len(_probe_threads()))
            return out

        monkeypatch.setattr(hostprobe.HostProbe, "start", start)


def test_probe_covers_a_call_that_holds_the_lock():
    n = _held_call_n()
    tm = telemetry.Telemetry()
    held = {}

    def hold():
        held["t0"] = time.monotonic()
        sum(range(n))
        held["t1"] = time.monotonic()

    probe = hostprobe.HostProbe(tm).start()
    try:
        time.sleep(0.02)
        worker = threading.Thread(target=hold)
        worker.start()
        worker.join()
        time.sleep(0.02)
    finally:
        probe.stop()
    lo, hi = held["t0"], held["t1"]
    assert hi - lo >= 0.2
    assert _covered_s(tm, lo, hi) >= 0.5 * (hi - lo)
    spans = tm.spans(name=hostprobe.SPAN)
    assert all(s.cat == "host" and s.attrs["late_s"] == s.dur > probe.threshold_s for s in spans)
    assert tm.metrics.as_dict()[hostprobe.COUNTER] == pytest.approx(sum(s.dur for s in spans))
    assert not _probe_threads()


def test_probe_is_quiet_beside_a_sleeping_thread():
    """The quietest of five short rounds: other load on a shared host,
    which comes and goes, delays the probe's thread too. The cyclic
    collector, which holds the lock while it runs, is off meanwhile."""
    counts = []
    gc.disable()
    try:
        for _ in range(5):
            tm = telemetry.Telemetry()
            sleeper = threading.Thread(target=lambda: [time.sleep(0.002) for _ in range(50)])
            probe = hostprobe.HostProbe(tm).start()
            try:
                sleeper.start()
                sleeper.join()
            finally:
                probe.stop()
            counts.append(len(tm.spans(name=hostprobe.SPAN)))
            # The counter says a probe ran, late wakes or none.
            assert hostprobe.COUNTER in tm.metrics.as_dict()
    finally:
        gc.enable()
    assert min(counts) <= 1, counts


def test_untraced_operations_start_no_probe(tmp_path, untraced, monkeypatch):
    starts = _Starts(monkeypatch)
    state = _state()
    tts.Snapshot.take(str(tmp_path / "s"), state)
    tts.Snapshot.async_take(str(tmp_path / "a"), state).wait()
    tts.Snapshot(str(tmp_path / "s")).restore(_state(), device="cpu")
    # The artifact session ran, without a probe.
    assert tts.Snapshot.last_telemetry is not None
    assert tts.Snapshot.last_telemetry.probe_host is False
    assert hostprobe.COUNTER not in tts.Snapshot.last_telemetry.metrics.as_dict()
    assert starts.started == 0 and not _probe_threads()


def test_a_traced_take_probes_until_its_commit(tmp_path, untraced, monkeypatch):
    starts = _Starts(monkeypatch)
    tm = telemetry.Telemetry()
    tts.Snapshot.take(str(tmp_path / "s"), _state(), _telemetry=tm)
    assert starts.started == 1 and starts.alive_at_start == [1]
    assert not _probe_threads()
    assert hostprobe.COUNTER in tm.metrics.as_dict()
    # A trace asked for through the knob probes too.
    monkeypatch.setenv("TSS_TORCH_TRACE", str(tmp_path / "trace.json"))
    tts.Snapshot(str(tmp_path / "s")).restore(_state(), device="cpu")
    assert starts.started == 2 and not _probe_threads()
    assert hostprobe.COUNTER in tts.Snapshot.last_telemetry.metrics.as_dict()


def test_an_aborted_take_leaves_no_probe(tmp_path, untraced, monkeypatch):
    starts = _Starts(monkeypatch)
    tm = telemetry.Telemetry()
    with knobs.override_faults("op=write,kind=fail,times=100"):
        with pytest.raises(tts.CheckpointAbortedError):
            tts.Snapshot.take(str(tmp_path / "s"), _state(), _telemetry=tm)
    assert starts.started == 1 and starts.alive_at_start == [1]
    assert not _probe_threads()


def test_an_async_takes_probe_spans_land_in_its_session(tmp_path, untraced, monkeypatch):
    """The drain waits on a gate while the caller holds the lock in one C
    call under a session of its own; the wait lands in the take's session
    alone, and its probe ends with the drain."""
    n = _held_call_n()
    gate = threading.Event()
    drain = scheduler._WritePipeline.run_to_completion

    async def gated(pipeline):
        await asyncio.get_running_loop().run_in_executor(None, gate.wait)
        await drain(pipeline)

    monkeypatch.setattr(scheduler._WritePipeline, "run_to_completion", gated)
    tm, caller = telemetry.Telemetry(), telemetry.Telemetry()
    pending = tts.Snapshot.async_take(str(tmp_path / "a"), _state(), _telemetry=tm)
    assert len(_probe_threads()) == 1
    prev = telemetry.activate(caller)
    try:
        t0 = time.monotonic()
        sum(range(n))
        t1 = time.monotonic()
    finally:
        telemetry.deactivate(caller, prev)
    gate.set()
    pending.wait()
    assert _covered_s(tm, t0, t1) >= 0.5 * (t1 - t0)
    assert not caller.spans(name=hostprobe.SPAN)
    assert not _probe_threads()


def test_pin_alloc_is_a_span_that_joins_no_sub_stream(monkeypatch):
    """On the CPU the pinned flag is dropped; the span is what the lanes
    record around their allocation."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: empty(*a, **k))
    tm = telemetry.Telemetry()
    times = d2h.StageTimes(tm=tm)
    host = d2h.pinned_empty((4, 8), torch.float32, times, "0/m/w")
    assert host.shape == (4, 8) and host.dtype == torch.float32
    (span,) = tm.spans(name="stage.pin_alloc")
    assert span.cat == "stage" and span.attrs == {"path": "0/m/w", "nbytes": 128}
    # No drain stat: the sub-streams stay the three they were.
    assert times.intervals() == {"d2h": [], "serialize": [], "hash": []}
    assert d2h.pinned_empty(3, torch.uint8).shape == (3,)


def test_memory_write_span_times_the_copy(monkeypatch):
    copy = bytes

    def slow_bytes(buf):
        time.sleep(0.05)
        return copy(buf)

    monkeypatch.setattr(memory, "bytes", slow_bytes, raising=False)
    plugin = memory.MemoryStoragePlugin()
    tm = telemetry.Telemetry()
    prev = telemetry.activate(tm)
    try:
        asyncio.run(plugin.write(WriteIO(path="x", buf=b"\x01" * 1000)))
    finally:
        telemetry.deactivate(tm, prev)
    (span,) = tm.spans(name="storage.write")
    assert span.dur >= 0.05 and span.attrs["nbytes"] == 1000
    assert plugin.objects["x"] == b"\x01" * 1000

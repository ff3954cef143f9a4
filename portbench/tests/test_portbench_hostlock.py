"""The readers of the interpreter-lock probe and the pinned allocations
(``gil_wait_s.train``, ``idle_gil_share.train``, ``idle_copy_share.train``,
``pin_alloc_s.train``, ``gil_wait_s.take``) on a synthetic run: known
telemetry spans against known device events give known values, and a
program without the probe gives none."""

import time

import pytest

from portbench.lib import cells
from portbench.lib.trace import DeviceEvent
from portbench.lib.workload import Op, Run
from torchsnapshot_tpu_torch import telemetry

A, T = "opt-6.7b-pp4s-adamw.async-ckpt", "opt-6.7b-pp4s-adamw.sync-take"


def _session(spans, probed=True):
    """A session holding ``spans`` ((name, start, end) each); ``probed``:
    it ran the probe, so it has the probe's counter."""
    tm = telemetry.Telemetry()
    for name, a, b in spans:
        tm.add_span(name, "test", a, b - a)
    if probed:
        tm.metrics.counter("host.gil_wait_s").add(sum(b - a for name, a, b in spans if name == "host.gil_wait"))
    return tm


def _async_run(probed=True, device=True):
    """A window of 100 s: a reference copy at 10-12 s, takes at 12 s and
    60 s that commit at 40 s and 80 s, a third at 90 s that commits after
    the window; the device busy 0-10, 12-20, 40-60 and 70-90 s, so idle
    20-40, 60-70 and 90-100 s (40 s, the copy's 2 s out)."""
    run = Run(A, {}, {}, True, window=(0.0, 100.0))
    take_a = _session(
        [
            ("host.gil_wait", 12.2, 12.5),  # before async_take returned
            ("host.gil_wait", 20, 30),
            ("host.gil_wait", 35, 36),
            ("scheduler.io", 25, 28),
            ("storage.write", 35, 35.5),
            ("scheduler.io", 31, 33),  # a copy that held nothing
            ("stage.pin_alloc", 13.0, 13.2),
            ("stage.pin_alloc", 13.1, 13.3),
        ],
        probed,
    )
    take_b = _session([("host.gil_wait", 65, 70), ("stage.pin_alloc", 61, 61.1)], probed)
    take_c = _session([("host.gil_wait", 95, 99), ("scheduler.io", 96, 97)], probed)
    run.ops = [
        Op("copy_ref", 10, 12),
        Op("async_take", 12, 13, {"tm": take_a, "t_commit": 40.0}),
        Op("step", 13, 50),
        Op("async_take", 60, 61, {"tm": take_b, "t_commit": 80.0}),
        Op("step", 61, 85),
        Op("async_take", 90, 91, {"tm": take_c}),
    ]
    if device:
        run.device_events = [DeviceEvent(a, b, "k") for a, b in ((0, 10), (12, 20), (40, 60), (70, 90))]
    return run


def _read(metric, run):
    return cells.reader(metric).read(run)


def test_train_readers_on_known_spans():
    run = _async_run()
    # Per committed take, the late wakes after its return: 10 + 1 and 5.
    assert _read("gil_wait_s.train", run) == pytest.approx(8.0)
    # Idle under a late wake: 10 + 1 + 5 + 4 of 40 s.
    assert _read("idle_gil_share.train", run) == pytest.approx(50.0)
    # Idle under a late wake and a copy: 3 + 0.5 + 1 of 40 s.
    assert _read("idle_copy_share.train", run) == pytest.approx(11.25)
    # The union of the pinned allocations per committed take: 0.3 and 0.1.
    assert _read("pin_alloc_s.train", run) == pytest.approx(0.2)


def test_take_reader_on_known_spans():
    run = Run(T, {}, {}, True, window=(0.0, 50.0))
    run.ops = [
        Op("take", 0, 20, {"tm": _session([("host.gil_wait", 1, 2), ("host.gil_wait", 5, 8), ("scheduler.io", 1, 9)])}),
        Op("delete", 20, 21),
        Op("take", 21, 45, {"tm": _session([("host.gil_wait", 30, 34)])}),
        Op("take", 45, 60, {"tm": _session([("host.gil_wait", 50, 59)])}),  # past the window
    ]
    assert _read("gil_wait_s.take", run) == pytest.approx(4.0)
    # A probe that never woke late reads zero.
    run.ops[2].info["tm"] = _session([])
    assert _read("gil_wait_s.take", run) == pytest.approx(2.0)


def test_a_program_without_the_probe_reads_nothing():
    """The parent of the probe records neither its spans nor its counter:
    every reader returns None, and none raises."""
    run = _async_run(probed=False)
    for metric in ("gil_wait_s.train", "idle_gil_share.train", "idle_copy_share.train", "pin_alloc_s.train"):
        assert _read(metric, run) is None, metric
    take = Run(T, {}, {}, True, window=(0.0, 50.0), ops=[Op("take", 0, 20, {"tm": _session([], probed=False)})])
    assert _read("gil_wait_s.take", take) is None
    # An untraced run has no session at all.
    take.ops[0].info.clear()
    assert _read("gil_wait_s.take", take) is None


def test_shares_of_a_window_of_many_gaps():
    """A traced window holds ~120,000 device events: the shares take one
    sweep over them, not a product of the gaps and the spans."""
    n = 100_000
    run = Run(A, {}, {}, True, window=(0.0, 2.0 * n))
    run.device_events = [DeviceEvent(2.0 * i, 2.0 * i + 1, "k") for i in range(n)]
    # Late wakes over every other gap (the idle second after each event),
    # copies over every fourth.
    spans = [("host.gil_wait", 4.0 * i + 1, 4.0 * i + 2) for i in range(n // 2)]
    spans += [("scheduler.io", 8.0 * i, 8.0 * i + 2) for i in range(n // 4)]
    run.ops = [Op("async_take", 0, 1, {"tm": _session(spans), "t_commit": 2.0 * n})]
    t0 = time.monotonic()
    assert _read("idle_gil_share.train", run) == pytest.approx(50.0)
    assert _read("idle_copy_share.train", run) == pytest.approx(25.0)
    assert time.monotonic() - t0 < 30


def test_shares_need_the_device_trace():
    run = _async_run(device=False)
    assert _read("idle_gil_share.train", run) is None
    assert _read("idle_copy_share.train", run) is None
    assert _read("gil_wait_s.train", run) == pytest.approx(8.0)


def test_entries_list_their_cells():
    bench = cells.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric, cell, moves in (
        ("gil_wait_s.train", A, "train_tokens_per_s"),
        ("idle_gil_share.train", A, "train_tokens_per_s"),
        ("idle_copy_share.train", A, "train_tokens_per_s"),
        ("pin_alloc_s.train", A, "train_tokens_per_s"),
        ("gil_wait_s.take", T, "take_gbps"),
    ):
        assert entries[metric]["workloads"] == [cell] and entries[metric]["moves"] == moves
        assert metric in {m["name"] for m in cells.metrics_of(bench, cell, True)}

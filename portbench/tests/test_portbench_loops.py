"""The traffic loops at toy sizes on the CPU through the internal entry
(``harness.run_cell(device="cpu")``, which reports no metric), the metric
readers on its record, the interval arithmetic of the trace, and the
result line's schema."""

import json

import pytest

from conftest import CELLS, toy_cell
from portbench.lib import cells, harness, trace
from portbench.lib.trace import DeviceEvent

BENCH = cells.load_benchmark()
HOST_READ = {"host_clock", "program_span"}


@pytest.mark.parametrize("trace_on", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_toy_cell_runs_correct_and_reports_no_metric(cell, trace_on):
    cfg, traffic = toy_cell(cell)
    out = harness.run_cell(cell, 2**31 + 17, 0.6, trace_on, device="cpu", config=cfg, traffic=traffic)
    run = out["run"]
    assert out["metrics"] == {}
    assert out["checks"] == {"leaves_differing": 0, "bytes_differing": 0}
    assert run.failed == 0 and run.attempted >= 1 and run.device_events is None
    assert run.in_window(traffic["op"])
    # Every reader this run feeds: host-clock and span readers find
    # something, device-trace readers nothing.
    for m in cells.metrics_of(BENCH, cell, trace_on):
        value = cells.reader(m["name"]).read(run)
        if m["source"] == "device_trace":
            assert value is None, m["name"]
        elif m["name"] not in ("drain_s", "drain_step_excess_s"):
            assert value is not None and value >= 0, m["name"]


def test_async_window_is_whole_checkpoint_intervals():
    cell = "opt-6.7b-pp4s-adamw.async-ckpt"
    cfg, traffic = toy_cell(cell)
    run = harness.run_cell(cell, 5, 0.5, False, device="cpu", config=cfg, traffic=traffic)["run"]
    takes, steps = run.in_window("async_take"), run.in_window("step")
    assert takes and len(steps) == len(takes) * traffic["every_steps"]
    assert all(t.info.get("t_commit") for t in takes)


def test_storage_comes_from_the_traffic_file(tmp_path, monkeypatch):
    """A traffic file's ``storage`` moves every snapshot, with no code
    changed: here to the fs plugin under ``$TMPDIR``."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = "opt-6.7b-pp4s-adamw.sync-take"
    cfg, traffic = toy_cell(cell)
    traffic["storage"] = "fs://$TMPDIR/"
    out = harness.run_cell(cell, 21, 0.2, False, device="cpu", config=cfg, traffic=traffic)
    assert out["checks"] == {"leaves_differing": 0, "bytes_differing": 0}
    assert out["run"].in_window("take")
    # The runner deletes each snapshot through the plugin; the root stays.
    assert (tmp_path / "portbench" / cell / "21").is_dir()


def test_reference_time_is_out_of_the_window():
    """The async cell's reference copy before each take is recorded as
    ``copy_ref`` and taken out of the window's seconds."""
    cell = "opt-6.7b-pp4s-adamw.async-ckpt"
    cfg, traffic = toy_cell(cell)
    run = harness.run_cell(cell, 19, 0.3, False, device="cpu", config=cfg, traffic=traffic)["run"]
    copies = run.in_window("copy_ref")
    assert len(copies) == len(run.in_window("async_take"))
    span = run.window[1] - run.window[0]
    assert run.window_s == pytest.approx(span - sum(op.t1 - op.t0 for op in copies))


def _ev(a, b, name="k"):
    return DeviceEvent(a, b, name)


def test_interval_arithmetic():
    assert trace.merge([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert trace.union_s([(0, 1), (0.5, 2), (3, 4)], 1, 3.5) == pytest.approx(1.5)
    busy = trace.busy_intervals([_ev(1, 2), _ev(1.5, 3), _ev(5, 6)])
    assert trace.idle_gaps(busy, 0, 7) == [(0, 1), (3, 5), (6, 7)]
    assert trace.subtract([(0, 4), (6, 9)], [(1, 2), (3, 7)]) == [(0, 1), (2, 3), (7, 9)]
    spans = [("bench.step", 0, 2.5), ("bench.take", 2.5, 4)]
    assert dict(trace.idle_by_host_span([(0, 1), (3, 5), (6, 7)], spans)) == pytest.approx(
        {"bench.step": 1.0, "bench.take": 1.0, "bench.other": 2.0}
    )
    ops = trace.top_device_ops([_ev(0, 1, "a"), _ev(1, 3, "b"), _ev(3, 3.5, "a")], 0, 10)
    assert ops == [["b", 2.0], ["a", 1.5]]


def test_device_readers_on_a_synthetic_trace():
    cell = "opt-6.7b-weights.restore"
    cfg, traffic = toy_cell(cell)
    run = harness.run_cell(cell, 9, 0.3, False, device="cpu", config=cfg, traffic=traffic)["run"]
    t0, t1 = run.window
    restores = run.in_window("restore")
    # One H2D memcpy per restore, busy a quarter of the window in all.
    q = (t1 - t0) / 4 / len(restores)
    run.device_events = [_ev(op.t0, op.t0 + q, "Memcpy HtoD (Pinned -> Device)") for op in restores]
    assert cells.reader("device_idle.restore").read(run) == pytest.approx(75.0, abs=1e-6)
    want = len(restores) * run.numbers["device_state_bytes"] / (q * len(restores)) / 1e9
    assert cells.reader("h2d_gbps.restore").read(run) == pytest.approx(want)


def test_result_line_schema():
    cell = "opt-6.7b-pp4s-adamw.sync-take"
    cfg, traffic = toy_cell(cell)
    out = harness.run_cell(cell, 3, 0.3, False, device="cpu", config=cfg, traffic=traffic)
    out["metrics"] = {"take_gbps": {"value": 1.5, "unit": "GB/s"}, "setup_s": {"value": 30.0, "unit": "s"}}
    line = harness.result_line(out, 1, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["checks"] == {"leaves_differing": {"value": 0, "limit": 0}, "bytes_differing": {"value": 0, "limit": 0}}
    json.loads(json.dumps(line))
    # Traced: busy and window seconds, the breakdown, checks still last.
    out["run"].device_events = [_ev(out["run"].window[0], out["run"].window[0] + 0.01, "Memcpy DtoH")]
    traced = harness.result_line(out, 1, "NVIDIA H100 80GB HBM3")
    assert list(traced)[-2:] == ["breakdown", "checks"]
    assert traced["device"]["busy_s"] == pytest.approx(0.01)
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}

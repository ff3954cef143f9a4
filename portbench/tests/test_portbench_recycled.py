"""The readers of the memory plugin's recycled buffers
(``recycled_share.take``, ``recycled_share.train``) on traced toy runs on
the CPU, with the plugin's inline threshold lowered so that the toy
state's objects are pooled arrays: a window's first take copies into new
buffers, the takes after a deletion into recycled ones. A program without
the counters, and an untraced run, give none."""

import pytest

from conftest import toy_cell
from portbench.lib import cells, harness
from portbench.lib.recycled import share
from portbench.lib.workload import Op, Run
from torchsnapshot_tpu_torch import telemetry
from torchsnapshot_tpu_torch.storage_plugins import memory

SYNC, ASYNC = "opt-6.7b-pp4s-adamw.sync-take", "opt-6.7b-pp4s-adamw.async-ckpt"


@pytest.fixture
def pooled(monkeypatch):
    """Objects of 256 bytes or more are arrays the pool takes, in a pool of
    this test's own."""
    monkeypatch.setattr(memory, "INLINE_MAX_BYTES", 256)
    monkeypatch.setattr(memory, "RECYCLED", memory.BufferPool())
    yield
    memory.RECYCLED.release()


def _read(metric, run):
    return cells.reader(metric).read(run)


def test_takes_after_a_deletion_copy_into_recycled_buffers(pooled):
    cfg, traffic = toy_cell(SYNC)
    out = harness.run_cell(SYNC, 2**31 + 5, 2.0, True, device="cpu", config=cfg, traffic=traffic)
    assert out["checks"] == {"leaves_differing": 0, "bytes_differing": 0}
    takes = out["run"].in_window("take")
    assert len(takes) >= 3
    shares = [share(op) for op in takes]
    # Set-up's snapshot is still stored during the first take; each later
    # one finds the snapshot before the last deleted, its sizes the same.
    assert shares[0] == 0.0
    assert all(0.5 < v < 1.0 for v in shares[1:]), shares
    assert _read("recycled_share.take", out["run"]) == pytest.approx(sum(shares) / len(shares))
    recycled = [sum(s.attrs["recycled"] for s in op.info["tm"].spans(name="storage.write")) for op in takes]
    assert recycled[0] == 0 and all(r > 0 for r in recycled[1:])


def test_async_takes_after_the_first_commit_copy_into_recycled_buffers(pooled):
    cfg, traffic = toy_cell(ASYNC)
    out = harness.run_cell(ASYNC, 2**31 + 6, 3.0, True, device="cpu", config=cfg, traffic=traffic)
    assert out["checks"] == {"leaves_differing": 0, "bytes_differing": 0}
    run = out["run"]
    committed = [op for op in run.in_window("async_take") if op.info.get("t_commit") is not None and op.info["t_commit"] <= run.window[1]]
    assert len(committed) >= 2
    shares = [share(op) for op in committed]
    assert shares[0] == 0.0 and all(0.5 < v < 1.0 for v in shares[1:]), shares
    assert _read("recycled_share.train", run) == pytest.approx(sum(shares) / len(shares))


def _session(counters):
    tm = telemetry.Telemetry(probe_host=False)
    for name, n in counters.items():
        tm.metrics.counter(name).add(n)
    return tm


def test_known_counters_and_a_program_without_them():
    take = Run(SYNC, {}, {}, True, window=(0.0, 50.0))
    take.ops = [
        Op("take", 0, 10, {"tm": _session({"storage.memory.fresh_bytes": 100, "storage.memory.recycled_bytes": 0})}),
        Op("delete", 10, 11),
        Op("take", 11, 20, {"tm": _session({"storage.memory.fresh_bytes": 10, "storage.memory.recycled_bytes": 90})}),
        Op("take", 45, 55, {"tm": _session({"storage.memory.recycled_bytes": 7})}),  # past the window
    ]
    assert _read("recycled_share.take", take) == pytest.approx(0.45)
    train = Run(ASYNC, {}, {}, True, window=(0.0, 50.0))
    train.ops = [
        Op("async_take", 0, 1, {"tm": _session({"storage.memory.recycled_bytes": 30, "storage.memory.fresh_bytes": 10}), "t_commit": 8.0}),
        Op("async_take", 20, 21, {"tm": _session({"storage.memory.recycled_bytes": 5, "storage.memory.fresh_bytes": 5}), "t_commit": 30.0}),
        Op("async_take", 40, 41, {"tm": _session({"storage.memory.recycled_bytes": 9}), "t_commit": 51.0}),  # commits late
    ]
    assert _read("recycled_share.train", train) == pytest.approx(0.625)
    # The parent of the pool counts neither: no value, and no error.
    for run in (take, train):
        for op in run.ops:
            if "tm" in op.info:
                op.info["tm"] = _session({"storage.memory.write_bytes": 100})
    assert _read("recycled_share.take", take) is None and _read("recycled_share.train", train) is None
    # An untraced run has no session at all.
    for run in (take, train):
        for op in run.ops:
            op.info.pop("tm", None)
    assert _read("recycled_share.take", take) is None and _read("recycled_share.train", train) is None


def test_entries_list_their_cells():
    bench = cells.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    moon = "moonlight-16b-pp2s-ep8-adamw.async-ckpt-b1"
    for metric, listed, moves in (
        ("recycled_share.take", [SYNC], "take_gbps"),
        ("recycled_share.train", [ASYNC, moon], "train_tokens_per_s"),
    ):
        entry = entries[metric]
        assert entry["workloads"] == listed and entry["moves"] == moves
        assert entry["layer"] == "storage (storage_plugins/memory.py)" and entry["source"] == "program_counter"
        for cell in listed:
            assert metric in {m["name"] for m in cells.metrics_of(bench, cell, True)}

"""Fleet beacons of the port: a two-rank gloo take publishes one beacon per
rank on the c10d store, which ``fleet-health`` and ``monitor --fleet`` read
back from ``host:port``; the detectors and views are the JAX package's.

Ranks are spawned processes on the CPU (gloo), two per spawn.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from torchsnapshot_tpu_torch import telemetry as ttel
from torchsnapshot_tpu_torch.parallel.store import LocalStore


def _cli(argv):
    from torchsnapshot_tpu_torch.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _beacon_worker(rank, world_size, root, out_dir):
    import torch.distributed as dist

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.telemetry import fleet

    w = torch.full((64,), float(rank))
    # Fleet telemetry left at "auto": a two-rank group turns it on.
    tts.Snapshot.take(root, {"m": tts.StateDict(w=w)})
    assert fleet.enabled()
    dist.barrier()  # every rank's last (idle) beacon is published
    if rank == 0:
        store = dist.distributed_c10d._get_default_store()._underlying_non_prefix_store
        addr = f"{store.host}:{store.port}"
        rc, text = _cli(["fleet-health", addr])
        rc_json, raw = _cli(["fleet-health", addr, "--json", "--world-size", str(world_size)])
        rc_mon, mon = _cli(["monitor", "--fleet", addr, "--json"])
        with open(os.path.join(out_dir, "out.json"), "w") as f:
            json.dump({"rc": rc, "text": text, "rc_json": rc_json, "json": json.loads(raw),
                       "rc_mon": rc_mon, "monitor": json.loads(mon)}, f)
    dist.barrier()


def test_two_rank_beacons_read_back_through_fleet_health(tmp_path):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    run_with_processes(
        _beacon_worker, 2, args=(str(tmp_path / "s"), str(tmp_path)), process_group=True, timeout_s=120
    )
    with open(tmp_path / "out.json") as f:
        out = json.load(f)
    assert out["rc"] == 0 and out["rc_json"] == 0 and out["rc_mon"] == 0
    assert "fleet: world_size=2  beacons=2" in out["text"]
    assert "fleet healthy: no anomalies" in out["text"]
    view = out["json"]["view"]
    assert view["ranks"] == [0, 1] and view["missing_ranks"] == []
    assert out["json"]["anomalies"] == []
    # The last word of a finished take is an idle beacon (op None).
    assert all(view["per_rank"][str(r)]["op"] is None for r in (0, 1))
    assert out["monitor"]["ranks"] == [0, 1]
    # Both ranks' take artifacts merge through the CLI's stats.
    rc, text = _cli(["stats", str(tmp_path / "s")])
    assert rc == 0 and "op=take  world_size=2  ranks_present=2" in text


def test_bus_publishes_and_reads_over_a_store():
    store = LocalStore()

    class _Coord:
        def __init__(self):
            self.store = store
            self.deleted = []

        def defer_delete(self, key):
            self.deleted.append(key)

    coord = _Coord()
    bus = ttel.fleet.FleetBus(store=store, coordinator=coord, rank=1, world_size=2, interval_s=60.0)
    bus.note_op("take")
    bus.note_phase("capture")
    bus.note_blocked("barrier.arrive:x", [0])
    assert bus.publish(force=True)
    beacons = ttel.fleet.read_beacons(store, world_size=2)
    assert list(beacons) == [1]
    b = beacons[1]
    assert (b["op"], b["phase"], b["world_size"]) == ("take", "capture", 2)
    assert [e[:2] for e in b["blocked_on"]] == [[0, "barrier.arrive:x"]]
    bus.gc()
    assert coord.deleted == ["fleet/1"]
    # Rate limit: a second unforced publish inside the interval is skipped.
    assert not bus.publish()


def _beacon(rank, op="take", phase="capture", age=0.0, blocked=(), world=3):
    return {
        "schema_version": 1, "rank": rank, "world_size": world, "pid": 100 + rank, "seq": 1,
        "ts_unix": 1000.0 - age, "interval_s": 0.5, "op": op, "phase": phase, "engine": None,
        "anomalies": {}, "blocked_on": [list(e) for e in blocked], "progress": None, "qos": None,
    }


FLEETS = {
    "healthy": {0: _beacon(0), 1: _beacon(1), 2: _beacon(2)},
    "straggler": {0: _beacon(0, blocked=[(2, "barrier.arrive:x", 5.0)]), 1: _beacon(1, blocked=[(2, "barrier.arrive:x", 5.0)]), 2: _beacon(2, phase="write")},
    "dead": {0: _beacon(0), 1: _beacon(1, age=30.0), 2: _beacon(2)},
    "cycle": {0: _beacon(0, blocked=[(1, "s", 1.0)]), 1: _beacon(1, blocked=[(0, "s", 1.0)]), 2: _beacon(2)},
    "missing": {0: _beacon(0, blocked=[(2, "s", 3.0)]), 1: _beacon(1)},
}


@pytest.mark.parametrize("fleet_name", sorted(FLEETS))
def test_fleet_detectors_and_views_match_jax(fleet_name):
    from torchsnapshot_tpu.telemetry import aggregate as jagg
    from torchsnapshot_tpu.telemetry import health as jhealth

    beacons = FLEETS[fleet_name]
    port = ttel.health.detect_fleet_anomalies(beacons, 0.5, world_size=3, now=1000.0)
    jax = jhealth.detect_fleet_anomalies(beacons, 0.5, world_size=3, now=1000.0)
    assert port == jax
    assert bool(port) == (fleet_name != "healthy")
    pview = ttel.aggregate.fleet_view(beacons, world_size=3, now=1000.0)
    assert pview == jagg.fleet_view(beacons, world_size=3, now=1000.0)
    assert ttel.aggregate.format_fleet(pview) == jagg.format_fleet(pview)


def test_off_mode_feed_sites_allocate_nothing(monkeypatch):
    import tracemalloc

    monkeypatch.setenv("TSS_TORCH_FLEET_TELEMETRY", "0")
    monkeypatch.setenv("TSS_TORCH_RECORDER", "0")
    ttel.fleet.reset()
    ttel.recorder.reset()
    try:
        ttel.fleet.note_op("take")  # first use reads the knobs
        ttel.recorder.record_event("x", {})
        tracemalloc.start()
        for _ in range(100):
            ttel.fleet.note_phase("capture")
            ttel.fleet.note_blocked("s", [1])
            ttel.fleet.heartbeat()
            ttel.recorder.record_event("x", {})
        snap = tracemalloc.take_snapshot()
        tracemalloc.stop()
    finally:
        ttel.fleet.reset()
        ttel.recorder.reset()
    tel_dir = os.path.dirname(ttel.__file__)
    assert [s for s in snap.statistics("filename") if s.traceback[0].filename.startswith(tel_dir)] == []


def _paused_engine_beacon(eng_mod, fleet_mod, knobs_mod, store):
    """A beacon published while a BACKGROUND engine is paused under held
    FOREGROUND demand (one package's engine, bus and arbiter)."""
    import asyncio

    bus = fleet_mod.FleetBus(store=store, coordinator=None, rank=0, world_size=1, interval_s=60.0)

    async def body(_ctx, _payload):
        pass

    async def go():
        if eng_mod.__name__.startswith("torchsnapshot_tpu_torch"):
            eng = eng_mod.GraphExecutor(100, {}, owner="bg", priority=eng_mod.Priority.BACKGROUND)
        else:
            eng = eng_mod.GraphExecutor(budget_bytes=100, owner="bg", priority=eng_mod.Priority.BACKGROUND)
        eng.add(eng_mod.Node("io", body, cost_bytes=1, pool="io"))
        arb = eng_mod.get_arbiter()
        arb.register(eng_mod.Priority.FOREGROUND)
        try:
            runner = asyncio.ensure_future(eng.run())
            await asyncio.sleep(0.1)
            bus.sample_engine(eng)
            assert bus.publish(force=True)
        finally:
            arb.unregister(eng_mod.Priority.FOREGROUND)
        await asyncio.wait_for(runner, timeout=10)
        return eng

    loop = asyncio.new_event_loop()
    try:
        with knobs_mod.override_qos_poll_s(0.01):
            eng = loop.run_until_complete(go())
    finally:
        loop.close()
    return fleet_mod.read_beacons(store, world_size=1)[0], eng


def test_beacon_qos_and_engine_fields_match_jax_after_a_preempted_drain():
    from torchsnapshot_tpu import engine as jengine
    from torchsnapshot_tpu.parallel.store import LocalStore as JLocalStore
    from torchsnapshot_tpu.telemetry import fleet as jfleet
    from torchsnapshot_tpu.utils import knobs as jknobs

    from torchsnapshot_tpu_torch import engine as tengine
    from torchsnapshot_tpu_torch.utils import knobs as tknobs

    port, port_eng = _paused_engine_beacon(tengine, ttel.fleet, tknobs, LocalStore())
    jax, jax_eng = _paused_engine_beacon(jengine, jfleet, jknobs, JLocalStore())
    assert port["qos"] == jax["qos"] == {
        "enabled": True,
        "demand": {"BACKGROUND": 1, "NORMAL": 0, "FOREGROUND": 1},
        "preempted": ["BACKGROUND", "NORMAL"],
    }
    assert set(port["engine"]) == set(jax["engine"])
    timings = {"preempted_wait_s", "bytes_done", "occupancy", "admitted", "budget_hwm", "budget_available"}
    assert {k: v for k, v in port["engine"].items() if k not in timings} == {
        k: v for k, v in jax["engine"].items() if k not in timings
    }
    assert port["engine"]["paused"] is True and port["engine"]["preemptions"] == 1
    assert port_eng.preemptions == jax_eng.preemptions == 1

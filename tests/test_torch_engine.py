"""The port's engine and QoS arbiter (``torchsnapshot_tpu_torch/engine``),
held against the JAX package's (``torchsnapshot_tpu/engine``).

The counterparts of ``tests/test_engine.py``: graph execution and the
budget handoff, re-costs, over-budget admission, the abort sweep, the
BACKGROUND ``run_graph`` helper, pool caps, priority parsing and scopes,
the arbiter's preemption order, the knob off, a BACKGROUND engine paused
under FOREGROUND demand, the max-pause bound, ``pause_point``, a
foreground restore preempting a background drain, and thread safety
across event loops. Where a schedule is deterministic it is fed to both
packages' engines and arbiters, which must answer the same. Every graph
runs under both packages' budget-ledger sanitizers.
"""

import asyncio
import threading
import time
import types

import numpy as np
import pytest

from torchsnapshot_tpu import engine as jengine
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import engine as tengine
from torchsnapshot_tpu_torch.convert import from_numpy_tree
from torchsnapshot_tpu_torch.utils import knobs as tknobs


@pytest.fixture(autouse=True)
def _debug_ledger():
    with jknobs.override_debug_ledger(True), tknobs.override_debug_ledger(True):
        yield


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _pkg(name):
    """One package's engine surface behind one calling convention."""
    if name == "jax":

        def executor(budget, caps=None, priority=None):
            wrapped = {k: (lambda v=v: v) for k, v in (caps or {}).items()}
            return jengine.GraphExecutor(budget_bytes=budget, owner="t", caps=wrapped, priority=priority)

        return types.SimpleNamespace(eng=jengine, knobs=jknobs, executor=executor, wrap_caps=lambda c: {k: (lambda v=v: v) for k, v in c.items()})

    def executor(budget, caps=None, priority=None):
        return tengine.GraphExecutor(budget, caps or {}, owner="t", priority=priority)

    return types.SimpleNamespace(eng=tengine, knobs=tknobs, executor=executor, wrap_caps=lambda c: c)


PKGS = ["jax", "port"]


# ----------------------------------------------------------------- basics


@pytest.mark.parametrize("pkg", PKGS)
def test_chain_executes_in_order_with_payload_handoff(pkg):
    p = _pkg(pkg)
    events = []

    async def a(_ctx, _payload):
        events.append("a")
        return 41

    async def b(_ctx, payload):
        events.append(("b", payload))
        return payload + 1

    async def go():
        eng = p.executor(100)
        eng.add(p.eng.Node("stage", a, cost_bytes=10, pool="staging", successor=p.eng.Node("io", b, pool="io")))
        await eng.run()
        eng.assert_balanced("close")
        assert eng.budget.available == 100

    _run(go())
    assert events == ["a", ("b", 41)]


@pytest.mark.parametrize("pkg", PKGS)
def test_budget_reservation_rides_the_edge(pkg):
    p = _pkg(pkg)
    seen = {}
    holder = {}

    async def stage(_ctx, _payload):
        seen["during_stage"] = holder["eng"].budget.available
        return b"x" * 30

    async def io(_ctx, _buf):
        seen["during_io"] = holder["eng"].budget.available

    async def go():
        eng = holder["eng"] = p.executor(100)
        eng.add(p.eng.Node("stage", stage, cost_bytes=30, pool="staging", successor=p.eng.Node("io", io, pool="io")))
        await eng.run()
        assert eng.budget.available == 100
        eng.assert_balanced("close")

    _run(go())
    assert seen == {"during_stage": 70, "during_io": 70}


@pytest.mark.parametrize("pkg", PKGS)
def test_recost_corrects_estimate(pkg):
    p = _pkg(pkg)

    async def stage(ctx, _payload):
        ctx.recost(55)

    async def go():
        eng = p.executor(100)
        eng.add(p.eng.Node("stage", stage, cost_bytes=10, pool="staging"))
        await eng.run()
        assert eng.budget.available == 100
        assert eng.budget.high_water_bytes == 55
        eng.assert_balanced("close")

    _run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_over_budget_node_admitted_only_when_engine_empty(pkg):
    p = _pkg(pkg)
    order = []

    def body(name):
        async def run(_ctx, _payload):
            order.append(("start", name))
            await asyncio.sleep(0.01)
            order.append(("end", name))

        return run

    async def go():
        eng = p.executor(100)
        eng.add(p.eng.Node("stage", body("huge"), cost_bytes=10_000, pool="staging"))
        eng.add(p.eng.Node("stage", body("small"), cost_bytes=10, pool="staging"))
        await eng.run()
        eng.assert_balanced("close")

    _run(go())
    # The huge head is admitted alone (nothing in flight), and blocks the
    # small one until it ends: the same schedule in both packages.
    assert order == [("start", "huge"), ("end", "huge"), ("start", "small"), ("end", "small")]


@pytest.mark.parametrize("pkg", PKGS)
def test_failure_credits_and_abort_sweeps_balanced(pkg):
    p = _pkg(pkg)

    async def ok(_ctx, _payload):
        await asyncio.sleep(0.05)

    async def boom(_ctx, _payload):
        raise RuntimeError("node exploded")

    async def go():
        eng = p.executor(1000)
        for _ in range(4):
            eng.add(p.eng.Node("stage", ok, cost_bytes=100, pool="staging"))
        eng.add(p.eng.Node("stage", boom, cost_bytes=100, pool="staging"))
        with pytest.raises(RuntimeError, match="node exploded"):
            await eng.run()
        await eng.abort()  # the port's run() swept already: a second sweep is a no-op
        assert eng.budget.available == 1000
        eng.assert_balanced("abort")

    _run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_run_graph_background_helper_balances(pkg):
    p = _pkg(pkg)
    hits = []

    def make(i):
        async def body(_ctx, _payload):
            hits.append(i)

        return body

    async def go():
        eng = await p.eng.run_graph(
            [p.eng.Node("verify", make(i), cost_bytes=10) for i in range(8)],
            budget_bytes=25,
            owner="t-verify",
            caps=p.wrap_caps({"io": 2}),
        )
        assert eng.budget.available == 25
        assert eng.priority is p.eng.Priority.BACKGROUND

    _run(go())
    assert sorted(hits) == list(range(8))


@pytest.mark.parametrize("pkg", PKGS)
def test_pool_caps_bound_concurrency(pkg):
    p = _pkg(pkg)
    live = {"n": 0, "peak": 0}

    async def body(_ctx, _payload):
        live["n"] += 1
        live["peak"] = max(live["peak"], live["n"])
        await asyncio.sleep(0.01)
        live["n"] -= 1

    async def go():
        eng = p.executor(10**6, caps={"io": 3})
        for _ in range(12):
            eng.add(p.eng.Node("io", body, cost_bytes=1, pool="io"))
        await eng.run()
        eng.assert_balanced("close")

    _run(go())
    assert live["peak"] == 3


# ------------------------------------------------------------ QoS classes


def test_parse_priority_and_scope():
    for value in ("foreground", "NORMAL", "Background", None):
        got, want = tengine.parse_priority(value), jengine.parse_priority(value)
        assert (got is None and want is None) or (got.name, int(got)) == (want.name, int(want))
    assert tengine.parse_priority(tengine.Priority.BACKGROUND) is tengine.Priority.BACKGROUND
    with pytest.raises(ValueError, match="unknown QoS class"):
        tengine.parse_priority("turbo")
    assert [p.name for p in tengine.Priority] == [p.name for p in jengine.Priority]
    assert tengine.current_priority() is tengine.Priority.NORMAL
    with tengine.priority_scope(tengine.Priority.BACKGROUND):
        assert tengine.current_priority() is tengine.Priority.BACKGROUND
        with tengine.priority_scope(None):
            assert tengine.current_priority() is tengine.Priority.BACKGROUND
    assert tengine.current_priority() is tengine.Priority.NORMAL


# A deterministic schedule of demand registrations, fed to both arbiters.
_SCHEDULE = [
    ("register", "NORMAL"),
    ("register", "FOREGROUND"),
    ("register", "BACKGROUND"),
    ("unregister", "FOREGROUND"),
    ("register", "FOREGROUND"),
    ("unregister", "NORMAL"),
    ("unregister", "FOREGROUND"),
    ("unregister", "BACKGROUND"),
]


def _answers(eng, arb):
    out = []
    for op, cls in _SCHEDULE:
        getattr(arb, op)(eng.Priority[cls])
        out.append(
            (
                [arb.preempted(p) for p in eng.Priority],
                arb.demand_snapshot(),
                sorted(arb.introspect()["preempted_classes"]),
            )
        )
    return out


def test_arbiter_preemption_ordering():
    got = _answers(tengine, tengine.QoSArbiter())
    assert got == _answers(jengine, jengine.QoSArbiter())
    # FOREGROUND preempts both lower classes, NORMAL only BACKGROUND.
    assert got[0][0] == [True, False, False]
    assert got[1][0] == [True, True, False]
    assert got[-1][0] == [False, False, False]
    arb = tengine.get_arbiter()
    with tengine.demand_scope(tengine.Priority.NORMAL):
        assert arb.preempted(tengine.Priority.BACKGROUND)
        assert not arb.preempted(tengine.Priority.NORMAL)
    assert not arb.preempted(tengine.Priority.BACKGROUND)


def test_qos_knob_off_disables_preemption():
    for eng, knobs in ((tengine, tknobs), (jengine, jknobs)):
        arb = eng.get_arbiter()
        with eng.demand_scope(eng.Priority.FOREGROUND):
            with knobs.override_qos(False):
                assert not arb.preempted(eng.Priority.BACKGROUND)
                assert arb.introspect()["qos_enabled"] is False
            assert arb.preempted(eng.Priority.BACKGROUND)
    # Each package reads its own knob only.
    with tengine.demand_scope(tengine.Priority.FOREGROUND), jknobs.override_qos(False):
        assert tengine.get_arbiter().preempted(tengine.Priority.BACKGROUND)


@pytest.mark.parametrize("pkg", PKGS)
def test_background_engine_pauses_admission_under_foreground_demand(pkg):
    p = _pkg(pkg)
    done = []

    def make(i):
        async def body(_ctx, _payload):
            done.append(i)

        return body

    async def go():
        eng = p.executor(10**6, priority=p.eng.Priority.BACKGROUND)
        for i in range(4):
            eng.add(p.eng.Node("io", make(i), cost_bytes=1, pool="io"))
        arb = p.eng.get_arbiter()
        arb.register(p.eng.Priority.FOREGROUND)
        runner = asyncio.ensure_future(eng.run())
        await asyncio.sleep(0.15)
        paused = list(done)
        arb.unregister(p.eng.Priority.FOREGROUND)
        await asyncio.wait_for(runner, timeout=10)
        assert paused == []
        assert sorted(done) == [0, 1, 2, 3]
        assert eng.preemptions == 1
        assert eng.preempted_wait_s > 0.05
        assert len(eng.pause_intervals) == 1
        eng.assert_balanced("close")

    with p.knobs.override_qos_poll_s(0.01):
        _run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_max_pause_bounds_starvation(pkg):
    p = _pkg(pkg)
    done = []

    async def body(_ctx, _payload):
        done.append(1)

    async def go():
        eng = p.executor(10**6, priority=p.eng.Priority.BACKGROUND)
        eng.add(p.eng.Node("io", body, cost_bytes=1, pool="io"))
        arb = p.eng.get_arbiter()
        arb.register(p.eng.Priority.FOREGROUND)
        try:
            await asyncio.wait_for(eng.run(), timeout=10)
        finally:
            arb.unregister(p.eng.Priority.FOREGROUND)
        assert done == [1]
        assert eng.preemptions == 1 and eng.preempted_wait_s >= 0.1

    with p.knobs.override_qos_poll_s(0.01), p.knobs.override_qos_max_pause_s(0.1):
        _run(go())


def test_pause_point_yields_and_resumes():
    async def go():
        arb = tengine.get_arbiter()
        assert await tengine.pause_point(tengine.Priority.BACKGROUND) == 0.0
        arb.register(tengine.Priority.FOREGROUND)

        async def release():
            await asyncio.sleep(0.1)
            arb.unregister(tengine.Priority.FOREGROUND)

        rel = asyncio.ensure_future(release())
        waited = await tengine.pause_point(tengine.Priority.BACKGROUND)
        await rel
        assert waited >= 0.05
        # The ambient class is the default: NORMAL, not paused by NORMAL.
        with tengine.demand_scope(tengine.Priority.NORMAL):
            assert await tengine.pause_point() == 0.0

    with tknobs.override_qos_poll_s(0.01):
        _run(go())


# ----------------------------------------------- end-to-end QoS preemption


def test_foreground_restore_preempts_background_drain(tmp_path):
    """A BACKGROUND async-take drain and a FOREGROUND restore share one
    process; FOREGROUND demand is held from before the take (so the
    drain's preemption does not depend on timing) and released once the
    restore is done. Both operations complete, verify clean and restore
    bit-exactly, and the drain's artifact counts its pauses."""
    from torchsnapshot_tpu_torch.telemetry import artifact

    rng = np.random.default_rng(7)
    drain_tree = {f"w{i}": rng.standard_normal((64, 256)).astype(np.float32) for i in range(8)}
    fg = {"v": rng.standard_normal(1024).astype(np.float32)}
    fg_path = str(tmp_path / "fg")
    tts.Snapshot.take(fg_path, {"m": tts.StateDict(**from_numpy_tree(fg, device="cpu"))})
    with tknobs.override_qos_poll_s(0.005), tknobs.override_qos_max_pause_s(0.05):
        with tengine.demand_scope(tengine.Priority.FOREGROUND):
            pending = tts.Snapshot.async_take(
                str(tmp_path / "bg"), {"m": tts.StateDict(**from_numpy_tree(drain_tree, device="cpu"))}, qos="background"
            )
            restored = tts.StateDict(**from_numpy_tree({"v": np.zeros(1024, np.float32)}, device="cpu"))
            tts.Snapshot(fg_path).restore({"m": restored}, device="cpu", qos="foreground")
            assert np.array_equal(restored["v"].numpy(), fg["v"])
        pending.wait()
    with open(tmp_path / "bg" / ".telemetry" / "rank_0.json", "rb") as f:
        engine = artifact.parse_artifact(f.read())["engine"]
    assert engine["preemptions"] >= 1 and engine["preempted_wait_s"] > 0
    assert tts.Snapshot(str(tmp_path / "bg")).verify() == {}
    back = tts.StateDict(**from_numpy_tree({k: np.zeros_like(v) for k, v in drain_tree.items()}, device="cpu"))
    tts.Snapshot(str(tmp_path / "bg")).restore({"m": back}, device="cpu")
    for k, v in drain_tree.items():
        assert np.array_equal(back[k].numpy(), v)


def test_preemption_is_thread_safe_across_event_loops():
    """The arbiter is consulted from two event loops on two threads (a
    drain thread and the main thread) without corrupting its counts."""
    arb = tengine.get_arbiter()
    results = []

    def bg_thread():
        async def body(_ctx, _payload):
            await asyncio.sleep(0.001)

        async def go():
            eng = tengine.GraphExecutor(10**6, {}, owner="bg", priority=tengine.Priority.BACKGROUND)
            for _ in range(20):
                eng.add(tengine.Node("io", body, cost_bytes=1, pool="io"))
            await eng.run()
            eng.assert_balanced("close")
            results.append("bg-done")

        _run(go())

    with tknobs.override_qos_poll_s(0.005):
        t = threading.Thread(target=bg_thread)
        t.start()
        for _ in range(3):
            with tengine.demand_scope(tengine.Priority.FOREGROUND):
                time.sleep(0.01)
            time.sleep(0.005)
        t.join(timeout=30)
    assert results == ["bg-done"]
    assert arb.demand_snapshot() == {"BACKGROUND": 0, "NORMAL": 0, "FOREGROUND": 0}

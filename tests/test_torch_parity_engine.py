"""The engine's periodic progress report (``engine.executor.ProgressReporter``)
held against the JAX package's: the same stages, bytes and budget give
the same log line (the resident-set growth is each process's own), the
line waits out its interval, and the engine's wait loop reports while a
node stalls."""

import asyncio
import logging
import re

import pytest

from torchsnapshot_tpu import engine as jengine
from torchsnapshot_tpu.engine import executor as jexecutor
from torchsnapshot_tpu_torch import engine as tengine
from torchsnapshot_tpu_torch.engine import executor as texecutor

_LOGGERS = {"jax": "torchsnapshot_tpu.scheduler", "port": "torchsnapshot_tpu_torch.scheduler"}
_RSS = re.compile(r" \| RSS delta [+-]\d+\.\d\d GB$")

CASES = [
    ({"pending": 3, "deferred": 0, "stage": 2, "io": 4, "ready": 1}, 3_500_000_000, 8_000_000_000, 2_000_000_000),
    ({"pending": 0, "deferred": 5, "ready": 0}, 0, 1 << 30, 0),
    ({"stage": 1}, 123_456_789, 10**9, 10**9 + 5),
]


def _line(pkg, caplog, stages, done, total, debit):
    mod = jexecutor if pkg == "jax" else texecutor
    budget = mod.Budget(total, owner="t")
    budget.debit(debit)
    reporter = mod.ProgressReporter(3, "write", interval_s=0.0)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=_LOGGERS[pkg]):
        reporter.maybe_report(stages, done, budget)
    budget.credit(debit)
    (record,) = [r for r in caplog.records if r.name == _LOGGERS[pkg]]
    assert record.levelno == logging.INFO
    return record.getMessage()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_progress_line_matches_the_jax_package(caplog, case):
    stages, done, total, debit = CASES[case]
    jline = _line("jax", caplog, stages, done, total, debit)
    tline = _line("port", caplog, stages, done, total, debit)
    assert _RSS.search(tline) and _RSS.search(jline), (tline, jline)
    assert _RSS.sub("", tline) == _RSS.sub("", jline)
    assert tline.startswith(f"Rank 3 write pipeline: {' '.join(f'{k}={v}' for k, v in stages.items())} | ")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_progress_line_waits_out_its_interval(caplog, pkg):
    mod = jexecutor if pkg == "jax" else texecutor
    reporter = mod.ProgressReporter(0, "read")
    assert reporter.interval_s == 10.0
    with caplog.at_level(logging.INFO, logger=_LOGGERS[pkg]):
        reporter.maybe_report({"io": 1}, 0, mod.Budget(100, owner="t"))
    assert not [r for r in caplog.records if r.name == _LOGGERS[pkg]]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_engine_loop_reports_while_a_node_stalls(caplog, pkg):
    """One node sleeps 0.4 s; with a 0.05 s interval the wait loop wakes
    and reports several times before the node completes."""
    eng_mod = jengine if pkg == "jax" else tengine

    async def body(_ctx, _payload):
        await asyncio.sleep(0.4)

    async def go():
        if pkg == "jax":
            eng = jengine.GraphExecutor(budget_bytes=1000, owner="t", caps={}, kind="write")
        else:
            eng = tengine.GraphExecutor(1000, {}, owner="t", kind="write")
        eng.reporter.interval_s = 0.05
        eng.add(eng_mod.Node("io", body, cost_bytes=10, pool="io"))
        await eng.run()
        eng.assert_balanced("close")

    loop = asyncio.new_event_loop()
    with caplog.at_level(logging.INFO, logger=_LOGGERS[pkg]):
        try:
            loop.run_until_complete(go())
        finally:
            loop.close()
    lines = [r.getMessage() for r in caplog.records if r.name == _LOGGERS[pkg]]
    assert len(lines) >= 3, lines
    assert all(line.startswith("Rank 0 write pipeline: ") and "io=1" in line for line in lines[:-1]), lines

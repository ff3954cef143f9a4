"""The port's budget-ledger sanitizer (``TSS_TORCH_DEBUG_LEDGER``), held
against the JAX package's (``TORCHSNAPSHOT_TPU_DEBUG_LEDGER``).

The counterparts of ``tests/test_ledger.py``: the ledger off by default,
on by its knob with a quiet balanced close, a leak named by owner, site and
bytes, estimate corrections and aggregated credits, over-credit, the
outstanding bytes and open entries (each fed to both packages' ledgers,
which must agree), a leak made through a node's re-cost attributed to the
node's own line, and the write pipeline balanced at close and on abort,
with an injected leak raising ``LedgerLeakError`` naming its site.
"""

import asyncio

import pytest

from torchsnapshot_tpu import ledger as jledger
from torchsnapshot_tpu.scheduler import _Budget as JBudget
from torchsnapshot_tpu.utils import knobs as jknobs

from torchsnapshot_tpu_torch import ledger as tledger
from torchsnapshot_tpu_torch import scheduler
from torchsnapshot_tpu_torch.engine import Budget as TBudget
from torchsnapshot_tpu_torch.engine import GraphExecutor, Node
from torchsnapshot_tpu_torch.io_types import BufferStager, WriteReq
from torchsnapshot_tpu_torch.ledger import LedgerLeakError
from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin
from torchsnapshot_tpu_torch.utils import knobs as tknobs

PKGS = {
    "jax": (jledger, JBudget, jknobs),
    "port": (tledger, TBudget, tknobs),
}


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# --------------------------------------------------------------- unit level


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ledger_disabled_by_default(pkg):
    led, budget_cls, _ = PKGS[pkg]
    assert led.maybe_ledger("x") is None
    budget = budget_cls(100)
    assert budget.ledger is None
    budget.debit(10)
    budget.assert_balanced("noop")  # no ledger: no check, no raise


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ledger_enabled_by_knob_and_balanced_close_is_quiet(pkg):
    led, budget_cls, knobs = PKGS[pkg]
    with knobs.override_debug_ledger(True):
        budget = budget_cls(100, owner="unit")
        assert isinstance(budget.ledger, led.BudgetLedger)
        for n in (30, 20):
            budget.debit(n)
        for n in (20, 30):
            budget.credit(n)
        budget.assert_balanced("close")
    # Each package reads its own knob only.
    with knobs.override_debug_ledger(True):
        other = tledger if led is jledger else jledger
        assert other.maybe_ledger("x") is None


def test_ledger_leak_names_owner_site_and_bytes():
    with tknobs.override_debug_ledger(True):
        budget = TBudget(100, owner="unit-owner")

        def leaky_site():
            budget.debit(64)

        leaky_site()
        with pytest.raises(LedgerLeakError) as exc:
            budget.assert_balanced("close")
    msg = str(exc.value)
    assert "owner=unit-owner" in msg
    assert "leaked 64 bytes" in msg
    assert "leaky_site" in msg
    assert "test_torch_ledger.py" in msg


def _ops(budget):
    # Estimate correction: debit(cost) ... credit(cost); debit(nbytes).
    budget.debit(100)
    budget.credit(100)
    budget.debit(87)
    # Streamed chunks and an aggregated cleanup credit.
    budget.debit(10)
    budget.debit(10)
    budget.credit(107)  # 87 + 10 + 10, consumed most-recent-first


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ledger_estimate_correction_and_aggregate_credit(pkg):
    _, budget_cls, knobs = PKGS[pkg]
    with knobs.override_debug_ledger(True):
        budget = budget_cls(1000, owner="unit")
        _ops(budget)
        budget.assert_balanced("close")
        assert budget.ledger.outstanding_bytes == 0 and budget.available == 1000


def test_ledger_over_credit_is_reported():
    with tknobs.override_debug_ledger(True):
        budget = TBudget(100, owner="unit")
        budget.credit(5)
        with pytest.raises(LedgerLeakError) as exc:
            budget.assert_balanced("close")
    assert "over-credited 5 bytes" in str(exc.value)


def test_ledger_outstanding_and_open_entries():
    """The same debits and credits in both packages' ledgers leave the same
    outstanding bytes and open amounts; the port's sites name this file."""
    ledgers = [tledger.BudgetLedger("x"), jledger.BudgetLedger("x")]
    for led in ledgers:
        for n in (7, 3, 12, 5):
            led.record_debit(n)
        led.record_credit(3)
        led.record_credit(14)  # aggregated: 5, then 9 of the 12
    port, ref = ledgers
    assert port.outstanding_bytes == ref.outstanding_bytes == 10
    assert [n for _, n in port.open_entries()] == [n for _, n in ref.open_entries()] == [7, 3]
    assert all("test_torch_ledger.py" in site for site, _ in port.open_entries())


# ------------------------------------------------------- a node's re-cost


def test_recost_leak_attributed_to_the_node():
    """A node that re-costs its reservation and then debits outside the
    engine: the abort-free close names the rogue line, not the engine's
    plumbing (``recost`` is a shim the site skips)."""

    async def go():
        with tknobs.override_debug_ledger(True):
            eng = GraphExecutor(1 << 20, {}, owner="recost")

            async def body(ctx, _payload):
                ctx.recost(4096)
                eng.budget.debit(17)  # rogue: nobody credits it

            eng.add(Node("stage", body, cost_bytes=100, pool="staging"))
            await eng.run()
            with pytest.raises(LedgerLeakError) as exc:
                eng.assert_balanced("close")
        return str(exc.value)

    msg = _run(go())
    assert "leaked 17 bytes" in msg and "(body)" in msg
    assert "4096" not in msg and "executor.py" not in msg


# ------------------------------------------------------------ pipeline level


class _Stager(BufferStager):
    def __init__(self, nbytes: int, fail: bool = False) -> None:
        self.nbytes = nbytes
        self.fail = fail

    async def stage_buffer(self, executor=None):
        if self.fail:
            raise RuntimeError("staging blew up")
        return b"x" * self.nbytes

    def get_staging_cost_bytes(self) -> int:
        return self.nbytes


def _pipeline(reqs, name):
    loop = asyncio.new_event_loop()
    try:
        pending = scheduler.sync_execute_write_reqs(reqs, MemoryStoragePlugin(root=name), 10**6, 0, loop)
        return pending, loop
    except BaseException:
        loop.close()
        raise


def test_pipeline_close_balanced_under_ledger():
    with tknobs.override_debug_ledger(True):
        pending, loop = _pipeline([WriteReq(f"p{i}", _Stager(100)) for i in range(8)], "ledger-ok")
        try:
            pending.sync_complete(loop)  # asserts balance at close
        finally:
            loop.close()
        budget = pending._pipeline._engine.budget
        assert budget.balanced and budget.ledger is not None and budget.ledger.outstanding_bytes == 0


def test_pipeline_abort_balanced_under_ledger():
    with tknobs.override_debug_ledger(True):
        reqs = [WriteReq(f"p{i}", _Stager(100, fail=(i == 3))) for i in range(6)]
        # The staging failure propagates, not a LedgerLeakError: the abort
        # path credited every debit.
        with pytest.raises(RuntimeError, match="staging blew up"):
            pending, loop = _pipeline(reqs, "ledger-abort")
            try:
                pending.sync_complete(loop)
            finally:
                loop.close()


def test_pipeline_injected_leak_raises_at_abort_with_site():
    """A debit the abort sweep cannot see is caught by the abort-path
    assertion and named by its site."""
    with tknobs.override_debug_ledger(True):
        reqs = [
            WriteReq("ok", _Stager(100)),
            # Deferred: the failure fires in the drain, after the rogue debit.
            WriteReq("boom", _Stager(100, fail=True), defer_staging=True),
        ]
        pending, loop = _pipeline(reqs, "ledger-leak")

        def rogue_reservation():
            pending._pipeline._engine.budget.debit(4242)

        rogue_reservation()
        try:
            with pytest.raises(LedgerLeakError) as exc:
                pending.sync_complete(loop)
        finally:
            loop.close()
    msg = str(exc.value)
    assert "4242 bytes" in msg and "rogue_reservation" in msg
    assert "write pipeline abort" in msg and "owner=write@rank0" in msg
    assert isinstance(exc.value.__context__, RuntimeError)

"""The memory-budgeted, priority-classed task-graph executor.

One executor drives one operation's graph (see ``graph.py``):

- **Admission** is head-of-line over the chains' first nodes, in the order
  they were added (callers add big requests first): the head is admitted
  when its pool has a free slot and its cost fits the budget; when nothing
  is in flight it is admitted whatever its cost, so one request larger than
  the budget cannot deadlock the graph.
- **Budget handoff**: the admission reservation travels along the chain
  (a node may re-cost it to the real buffer size with ``ctx.recost``) and
  is credited back when the chain's last node completes.
- **Deferred** chains (``Node.deferred``) wait until
  :meth:`GraphExecutor.release_deferred`: an async take runs the
  non-deferred chains before it returns and the rest in the background.
- **Priority**: the executor registers demand for its class with the
  process-wide :class:`~.qos.QoSArbiter` while it runs, and admits nothing
  new (successors included, so no storage bandwidth either) while a
  strictly higher class has demand, re-checking every
  ``TSS_TORCH_QOS_POLL_S``. Work in flight finishes; a stream node yields
  between its chunks (``ctx.preemption_point``). An engine paused for
  ``TSS_TORCH_QOS_MAX_PAUSE_S`` admits one round anyway. Each pause
  episode counts in :attr:`GraphExecutor.preemptions`, its seconds in
  :attr:`GraphExecutor.preempted_wait_s` and its interval in
  :attr:`GraphExecutor.pause_intervals`.
- **Abort**: the first failing node cancels every task in flight, awaits
  them, credits every outstanding reservation and re-raises, so the budget
  is balanced on every path; under ``TSS_TORCH_DEBUG_LEDGER`` the callers
  assert it (:meth:`GraphExecutor.assert_balanced`), naming leaking sites.
- **Telemetry**: each finished node (or a sub-step a node records itself,
  such as a streamed chunk) is one ``(t0, t1)`` interval of its stream,
  and, when a session was active at construction, the span
  ``<span_prefix>.<kind>`` with ``path``, ``nbytes`` and ``rank``: the
  drain stats and the trace are one record. The wait loop feeds the flight
  recorder and the fleet beacons (:meth:`GraphExecutor.introspect`), and
  with a progress tracker and ``TSS_TORCH_STALL_WARN_S`` a watchdog warns
  once per stall. At most every 10 s the loop logs one occupancy line
  (:class:`ProgressReporter`): the nodes in each pool, the GB done, the
  budget's headroom and the resident set's growth.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .. import ledger, telemetry
from ..utils import knobs
from ..utils.rss_profiler import rss_bytes
from . import qos as qos_mod
from .graph import Node
from .intervals import Interval
from .qos import Priority

# The JAX package logs its occupancy lines on its scheduler's channel; the
# port's go to its own scheduler's, so one filter per package finds them.
_pipeline_logger = logging.getLogger("torchsnapshot_tpu_torch.scheduler")


class Budget:
    """The operation's byte budget: two adds on the hot path; under the
    debug-ledger knob every debit is journaled with its owner and call
    site, so :meth:`assert_balanced` can name a leak."""

    def __init__(self, total: int, owner: str = "pipeline") -> None:
        self.total = total
        self.available = total
        # The lowest availability seen: the high-water mark.
        self.min_available = total
        self.ledger = ledger.maybe_ledger(owner)

    def debit(self, n: int) -> None:
        self.available -= n
        if self.available < self.min_available:
            self.min_available = self.available
        if self.ledger is not None:
            self.ledger.record_debit(n)

    def credit(self, n: int) -> None:
        self.available += n
        if self.ledger is not None:
            self.ledger.record_credit(n)

    def assert_balanced(self, context: str) -> None:
        """Under the ledger knob, raise ``LedgerLeakError`` unless every
        debit was credited back; a no-op otherwise."""
        if self.ledger is not None:
            self.ledger.assert_balanced(context)

    @property
    def high_water_bytes(self) -> int:
        return self.total - self.min_available

    @property
    def balanced(self) -> bool:
        return self.available == self.total


class NodeContext:
    """What a running node body may do to its chain's reservation, the
    bytes and sub-step intervals it reports, and its preemption point."""

    def __init__(self, engine: "GraphExecutor", reservation: int) -> None:
        self._engine = engine
        self._budget = engine.budget
        self.reservation = reservation
        self.nbytes: Optional[int] = None

    def recost(self, nbytes: int) -> None:
        """Correct the chain's reservation to ``nbytes`` (the real size of
        the staged buffer that rides the edge to the next node)."""
        self._budget.credit(self.reservation)
        self._budget.debit(nbytes)
        self.reservation = nbytes

    def note_bytes(self, nbytes: int) -> None:
        """The bytes this node's span reports (default: its reservation)."""
        self.nbytes = nbytes

    def record_interval(self, kind: str, t0: float, stream: str, path: str = "", nbytes: int = 0) -> None:
        """One sub-step of a self-recording node (a streamed chunk's
        staging or append), from ``t0`` to now."""
        self._engine.record_interval(kind, t0, time.monotonic(), stream, path, nbytes)

    async def preemption_point(self) -> None:
        """A chunk-granular yield: awaits while a higher class has demand."""
        await self._engine.preemption_point()


class ProgressReporter:
    """Periodic per-rank occupancy logging: how many nodes sit in each
    pool, the bytes done, the budget's headroom and the resident set's
    growth since the engine began. Logged at INFO at most once per
    ``interval_s``, from the engine's wait loop, which wakes at least that
    often: a stalled pool shows its last occupancy."""

    def __init__(self, rank: int, kind: str, interval_s: float = 10.0) -> None:
        self.rank = rank
        self.kind = kind
        self.interval_s = interval_s
        self._last_ts = time.monotonic()
        self._rss0 = _rss_bytes()

    def maybe_report(self, stages: Dict[str, int], bytes_done: int, budget: Budget) -> None:
        now = time.monotonic()
        if now - self._last_ts < self.interval_s:
            return
        self._last_ts = now
        rss_delta = _rss_bytes() - self._rss0 if self._rss0 else 0
        occupancy = " ".join(f"{k}={v}" for k, v in stages.items())
        _pipeline_logger.info(
            "Rank %d %s pipeline: %s | %.2f GB done | budget %.2f/%.2f GB | RSS delta %+.2f GB",
            self.rank,
            self.kind,
            occupancy,
            bytes_done / 1e9,
            budget.available / 1e9,
            budget.total / 1e9,
            rss_delta / 1e9,
        )


def _rss_bytes() -> int:
    """This process's resident set, 0 where ``/proc`` cannot say."""
    try:
        return rss_bytes()
    except (OSError, ValueError):
        return 0


class GraphExecutor:
    def __init__(
        self,
        budget_bytes: int,
        caps: Dict[str, Optional[int]],
        task_context: Optional[Callable[[], Any]] = None,
        *,
        kind: str = "engine",
        span_prefix: str = "scheduler",
        rank: int = 0,
        owner: Optional[str] = None,
        priority: Optional[Priority] = None,
        arbiter: Optional[qos_mod.QoSArbiter] = None,
        progress: Optional[Any] = None,
        bytes_done: Optional[Callable[[], int]] = None,
    ) -> None:
        self.budget = Budget(budget_bytes, owner=owner or f"{kind}@rank{rank}")
        self.kind = kind
        self.rank = rank
        # Read here: an async take's drain runs on a thread that never
        # sees the planning thread's ambient class.
        self.priority = priority if priority is not None else qos_mod.current_priority()
        self._arbiter = arbiter if arbiter is not None else qos_mod.get_arbiter()
        self._span_prefix = span_prefix
        # Captured here: the engine's tasks and executor threads do not all
        # run in the activating context.
        self._tm = telemetry.get_active()
        self._progress = progress
        self._bytes_done = bytes_done or (lambda: 0)
        self.reporter = ProgressReporter(rank, kind)
        self.admitted = 0
        self._caps = caps  # pool -> max concurrent nodes (None: unbounded)
        self._task_context = task_context or contextlib.nullcontext
        self._pending: Deque[Node] = deque()
        self._deferred: List[Node] = []
        self._ready: Deque[Tuple[Node, Any, int]] = deque()
        self._inflight: Dict[asyncio.Task, Tuple[Node, NodeContext]] = {}
        self._busy: Dict[str, int] = {}
        self.intervals: Dict[str, List[Interval]] = {"stage": [], "io": []}
        # Preemption: the open pause episode's start, the episodes so far,
        # their seconds and their intervals (monotonic).
        self._paused_since: Optional[float] = None
        self.preemptions = 0
        self.preempted_wait_s = 0.0
        self.pause_intervals: List[Interval] = []

    def add(self, node: Node) -> None:
        (self._deferred if node.deferred else self._pending).append(node)

    def release_deferred(self) -> None:
        self._pending.extend(self._deferred)
        self._deferred = []

    def unfinished_in(self, pools: Tuple[str, ...]) -> int:
        """Chains whose first node in ``pools`` is pending or running
        (deferred chains are not counted until released)."""
        return sum(1 for n in self._pending if n.pool in pools) + sum(
            1 for n, _ in self._inflight.values() if n.pool in pools
        )

    def all_done(self) -> bool:
        return not self._pending and not self._ready and not self._inflight

    def _slot_free(self, pool: str) -> bool:
        cap = self._caps.get(pool)
        return cap is None or self._busy.get(pool, 0) < cap

    def _start(self, node: Node, payload: Any, reservation: int, debit: bool = False) -> None:
        """Run ``node`` as a task holding ``reservation``; ``debit``: a
        chain's first node, whose reservation is debited here, once the
        task exists (if creating it raises, nothing was reserved)."""
        ctx = NodeContext(self, reservation)
        with self._task_context():
            task = asyncio.ensure_future(self._execute(node, ctx, payload))
        if debit:
            self.budget.debit(ctx.reservation)
        self._inflight[task] = (node, ctx)
        self._busy[node.pool] = self._busy.get(node.pool, 0) + 1
        self.admitted += 1

    async def _execute(self, node: Node, ctx: NodeContext, payload: Any) -> Any:
        t0 = time.monotonic()
        try:
            return await node.run(ctx, payload)
        finally:
            if node.stream is not None:
                nbytes = ctx.nbytes if ctx.nbytes is not None else ctx.reservation
                self.record_interval(node.kind, t0, time.monotonic(), node.stream, node.path, nbytes)

    def record_interval(
        self, kind: str, t0: float, t1: float, stream: str, path: str = "", nbytes: int = 0
    ) -> None:
        """One finished node or sub-step: its interval joins ``stream``'s,
        and with a session the span ``<span_prefix>.<kind>`` records it."""
        if stream in self.intervals:
            self.intervals[stream].append((t0, t1))
        tm = self._tm
        if tm is not None:
            tm.add_span(
                f"{self._span_prefix}.{kind}",
                self._span_prefix,
                t0,
                t1 - t0,
                {"path": path, "nbytes": nbytes, "rank": self.rank},
            )

    def occupancy(self) -> Dict[str, int]:
        occ = {"pending": len(self._pending), "deferred": len(self._deferred)}
        occ.update(self._busy)
        occ["ready"] = len(self._ready)
        return occ

    def introspect(self) -> Dict[str, Any]:
        """One flight-recorder sample of this engine (values only)."""
        return {
            "engine": self.kind,
            "rank": self.rank,
            "priority": self.priority.name,
            "occupancy": self.occupancy(),
            "bytes_done": self._bytes_done(),
            "admitted": self.admitted,
            "budget_total": self.budget.total,
            "budget_available": self.budget.available,
            "budget_hwm": self.budget.high_water_bytes,
            "preemptions": self.preemptions,
            "preempted_wait_s": round(self.preempted_wait_s, 6),
            "paused": self._paused_since is not None,
            "demand": self._arbiter.demand_snapshot(),
        }

    def _spawn_watchdog(self) -> Optional[asyncio.Task]:
        """A stall watchdog around one run, when the engine has a progress
        tracker and ``TSS_TORCH_STALL_WARN_S`` is positive."""
        if self._progress is None:
            return None
        warn_s = knobs.get_stall_warn_s()
        if warn_s <= 0:
            return None

        def on_fire() -> None:
            telemetry.counter_add("scheduler.stall_warnings", 1)
            telemetry.fleet.note_anomaly("stall_warning")
            telemetry.recorder.record_event(
                "engine.stall_warning",
                {"engine": self.kind, "rank": self.rank, "occupancy": self.occupancy(), "bytes_done": self._bytes_done()},
            )

        watchdog = telemetry.StallWatchdog(
            self._progress, warn_s, occupancy=self.occupancy, rank=self.rank, on_fire=on_fire
        )
        return asyncio.ensure_future(watchdog.run())

    # ------------------------------------------------------------ preemption

    def _pause_event(self, kind: str, **fields: Any) -> None:
        telemetry.recorder.record_event(
            kind, {"engine": self.kind, "rank": self.rank, "priority": self.priority.name, **fields}
        )

    def _qos_gated(self) -> bool:
        """True while admission must pause for a higher class. An engine
        paused for the max-pause bound admits one round and re-arms."""
        if not self._arbiter.preempted(self.priority):
            self._note_resumed()
            return False
        now = time.monotonic()
        if self._paused_since is None:
            if not self._ready and not self._pending:
                return False  # nothing to admit: no pause episode
            self._paused_since = now
            self.preemptions += 1
            telemetry.counter_add("engine.preemptions")
            self._pause_event("engine.pause", demand=self._arbiter.demand_snapshot())
            return True
        max_pause = knobs.get_qos_max_pause_s()
        if max_pause > 0 and now - self._paused_since >= max_pause:
            self._note_resumed()
            self._paused_since = now  # re-armed: this round admits
            return False
        return True

    def _close_pause(self, t0: float) -> None:
        t1 = time.monotonic()
        waited = t1 - t0
        self.pause_intervals.append((t0, t1))
        self.preempted_wait_s += waited
        telemetry.counter_add("engine.preempted_wait_s", waited)
        telemetry.histogram_observe("engine.pause_s", waited)
        self._pause_event("engine.resume", paused_s=round(waited, 6))

    def _note_resumed(self) -> None:
        if self._paused_since is not None:
            t0, self._paused_since = self._paused_since, None
            self._close_pause(t0)

    async def preemption_point(self) -> None:
        """A cooperative yield for node bodies (stream producers):
        ``qos.pause_point`` under this engine's class and arbiter, counted
        as one of its pause episodes."""
        t0 = time.monotonic()
        waited = await qos_mod.pause_point(
            self.priority, self._arbiter, source={"engine": self.kind, "rank": self.rank}
        )
        if waited:
            self.preemptions += 1
            self.preempted_wait_s += waited
            self.pause_intervals.append((t0, t0 + waited))

    # ------------------------------------------------------------- admission

    def _admit(self) -> None:
        if self._qos_gated():
            return
        # Successors first: they already hold their chain's reservation.
        for _ in range(len(self._ready)):
            node, payload, reservation = self._ready.popleft()
            if self._slot_free(node.pool):
                self._start(node, payload, reservation)
            else:
                self._ready.append((node, payload, reservation))
        while self._pending:
            node = self._pending[0]
            if not self._slot_free(node.pool):
                break
            if node.cost_bytes > self.budget.available and self._inflight:
                break
            self._pending.popleft()
            self._start(node, None, node.cost_bytes, debit=True)

    async def run(self, until: Optional[Callable[[], bool]] = None) -> None:
        """Run until the graph is drained, or until ``until()`` holds."""
        watchdog = self._spawn_watchdog()
        self._arbiter.register(self.priority)
        try:
            while not (until is not None and until()):
                self._admit()
                if not self._inflight:
                    if self.all_done():
                        return
                    # Work exists but admission is paused: poll the arbiter.
                    telemetry.recorder.sample_engine(self)
                    telemetry.fleet.sample_engine(self)
                    await asyncio.sleep(knobs.get_qos_poll_s())
                    continue
                # Bounded, so the reporter also speaks during a stall.
                done, _ = await asyncio.wait(
                    list(self._inflight),
                    return_when=asyncio.FIRST_COMPLETED,
                    timeout=self.reporter.interval_s,
                )
                self.reporter.maybe_report(self.occupancy(), self._bytes_done(), self.budget)
                telemetry.recorder.sample_engine(self)
                telemetry.fleet.sample_engine(self)
                for task in done:
                    node, ctx = self._inflight.pop(task)
                    self._busy[node.pool] -= 1
                    if task.cancelled() or task.exception() is not None:
                        self.budget.credit(ctx.reservation)
                    result = task.result()  # raises the node's failure
                    if node.successor is not None:
                        self._ready.append((node.successor, result, ctx.reservation))
                    else:
                        self.budget.credit(ctx.reservation)
        except BaseException:
            await self.abort()
            raise
        finally:
            self._arbiter.unregister(self.priority)
            self._note_resumed()
            if watchdog is not None:
                watchdog.cancel()
                await asyncio.gather(watchdog, return_exceptions=True)

    async def abort(self) -> None:
        """Cancel and await everything in flight; credit every reservation."""
        tasks = list(self._inflight)
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for _node, ctx in self._inflight.values():
            self.budget.credit(ctx.reservation)
        self._inflight.clear()
        for _node, _payload, reservation in self._ready:
            self.budget.credit(reservation)
        self._ready.clear()
        self._pending.clear()
        self._deferred = []
        self._busy = {}
        self._note_resumed()

    def assert_balanced(self, context: str) -> None:
        self.budget.assert_balanced(context)


async def run_graph(
    nodes: List[Node],
    *,
    budget_bytes: int,
    owner: str,
    kind: str = "engine",
    span_prefix: str = "engine",
    rank: int = 0,
    caps: Optional[Dict[str, Optional[int]]] = None,
    priority: Priority = Priority.BACKGROUND,
) -> GraphExecutor:
    """Build and run one flat graph of the secondary consumers (verify,
    scrub, gc waves): BACKGROUND class by default, its budget asserted
    balanced at close and on abort. Returns the executor (counters,
    intervals)."""
    eng = GraphExecutor(
        budget_bytes, caps or {}, kind=kind, span_prefix=span_prefix, rank=rank, owner=owner, priority=priority
    )
    for node in nodes:
        eng.add(node)
    try:
        await eng.run()
    except BaseException:
        eng.assert_balanced(f"{owner} abort")
        raise
    eng.assert_balanced(f"{owner} close")
    return eng

"""The memory-budgeted task-graph executor.

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
- **Abort**: the first failing node cancels every task in flight, awaits
  them, credits every outstanding reservation and re-raises, so the budget
  is balanced on every path.
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .graph import Node
from .intervals import Interval


class Budget:
    """The operation's byte budget."""

    def __init__(self, total: int) -> None:
        self.total = total
        self.available = total

    def debit(self, n: int) -> None:
        self.available -= n

    def credit(self, n: int) -> None:
        self.available += n

    @property
    def balanced(self) -> bool:
        return self.available == self.total


class NodeContext:
    """What a running node body may do to its chain's reservation."""

    def __init__(self, budget: Budget, reservation: int) -> None:
        self._budget = budget
        self.reservation = reservation

    def recost(self, nbytes: int) -> None:
        """Correct the chain's reservation to ``nbytes`` (the real size of
        the staged buffer that rides the edge to the next node)."""
        self._budget.debit(nbytes - self.reservation)
        self.reservation = nbytes


class GraphExecutor:
    def __init__(
        self,
        budget_bytes: int,
        caps: Dict[str, Optional[int]],
        task_context: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.budget = Budget(budget_bytes)
        self._caps = caps  # pool -> max concurrent nodes (None: unbounded)
        self._task_context = task_context or contextlib.nullcontext
        self._pending: Deque[Node] = deque()
        self._deferred: List[Node] = []
        self._ready: Deque[Tuple[Node, Any, int]] = deque()
        self._inflight: Dict[asyncio.Task, Tuple[Node, NodeContext]] = {}
        self._busy: Dict[str, int] = {}
        self.intervals: Dict[str, List[Interval]] = {"stage": [], "io": []}

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

    def _slot_free(self, pool: str) -> bool:
        cap = self._caps.get(pool)
        return cap is None or self._busy.get(pool, 0) < cap

    def _start(self, node: Node, payload: Any, reservation: int) -> None:
        ctx = NodeContext(self.budget, reservation)
        self._busy[node.pool] = self._busy.get(node.pool, 0) + 1
        with self._task_context():
            task = asyncio.ensure_future(self._execute(node, ctx, payload))
        self._inflight[task] = (node, ctx)

    async def _execute(self, node: Node, ctx: NodeContext, payload: Any) -> Any:
        t0 = time.monotonic()
        try:
            return await node.run(ctx, payload)
        finally:
            if node.stream is not None:
                self.intervals[node.stream].append((t0, time.monotonic()))

    def _admit(self) -> None:
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
            self.budget.debit(node.cost_bytes)
            self._start(node, None, node.cost_bytes)

    async def run(self, until: Optional[Callable[[], bool]] = None) -> None:
        """Run until the graph is drained, or until ``until()`` holds."""
        try:
            while not (until is not None and until()):
                self._admit()
                if not self._inflight:
                    return
                done, _ = await asyncio.wait(
                    list(self._inflight), return_when=asyncio.FIRST_COMPLETED
                )
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

"""The task-graph model the engine executes.

A graph is a set of :class:`Node` chains. Each node is one unit of work —
``stage`` (D2H + serialize), ``io`` (hash + storage write), ``stream`` (a
whole chunk-streamed write that does its own per-chunk accounting), ``read``
(storage fetch) or ``consume`` (copy into the restore target) — with a byte
cost and a slot pool. An edge (``successor``) carries both the data handoff
(the predecessor's result becomes the successor's payload) and the budget
handoff: the reservation debited when the chain's first node was admitted
is credited back only when the chain's last node completes, or when the
graph aborts.
"""

from __future__ import annotations

from typing import Any, Awaitable, Callable, Optional

# A node body: ``async def body(ctx, payload)``; ``payload`` is the
# predecessor's result (None for the first node of a chain).
NodeBody = Callable[[Any, Any], Awaitable[Any]]


class Node:
    __slots__ = ("kind", "run", "cost_bytes", "pool", "stream", "path", "deferred", "successor")

    def __init__(
        self,
        kind: str,
        run: NodeBody,
        *,
        cost_bytes: int = 0,
        pool: str = "io",
        stream: Optional[str] = None,
        path: str = "",
        deferred: bool = False,
        successor: Optional["Node"] = None,
    ) -> None:
        self.kind = kind
        self.run = run
        self.cost_bytes = cost_bytes  # admission reservation (bytes)
        self.pool = pool  # slot pool the node occupies while it runs
        self.stream = stream  # interval stream ("stage"/"io") or None
        self.path = path
        self.deferred = deferred  # inadmissible until release_deferred()
        self.successor = successor

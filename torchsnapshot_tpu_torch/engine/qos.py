"""Priority classes and the process-wide QoS arbiter.

A port of ``torchsnapshot_tpu/engine/qos.py``. Every operation the engine
runs carries one of three classes, ``FOREGROUND > NORMAL > BACKGROUND``.
An operation *registers demand* for its class while it runs, and every
engine (and every cooperative chunk loop outside one: broadcast and swarm
origin fetches, cache populates) asks ``preempted(my_class)`` before it
admits its next unit of work. While a strictly higher class has demand,
lower-class admission pauses: budget, pool slots and storage bandwidth
yield at the next chunk boundary. Nothing in flight is cancelled, so a
foreground restore arriving mid-drain takes the drain's *next* admission
instead of waiting for the drain to end, and the drain resumes the moment
the restore's demand goes.

The arbiter is thread-safe (an async take's drain thread and a restore's
event loop on the main thread consult the same instance) and local to the
process: it arbitrates what one process multiplexes, its memory budget,
thread pools and storage connections.

Starvation is bounded: an engine paused continuously for
``TSS_TORCH_QOS_MAX_PAUSE_S`` seconds admits one round of work anyway.
``TSS_TORCH_QOS=0`` turns the arbiter off (first come, first served).

The ambient class travels in a ``contextvars.ContextVar``:
``Snapshot.take``/``async_take``/``restore`` wrap the operation in
:func:`priority_scope`, and every pipeline built inside inherits it;
scrub, verify, gc and cache populates pin ``BACKGROUND``.
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
import threading
import time
from typing import Any, Dict, Optional, Union

from .. import telemetry
from ..utils import knobs


class Priority(enum.IntEnum):
    """QoS class of one operation. A class preempts (pauses the admission
    of) every strictly lower class."""

    BACKGROUND = 0
    NORMAL = 1
    FOREGROUND = 2


def parse_priority(value: Union["Priority", str, None]) -> Optional[Priority]:
    """``"foreground" | "normal" | "background"`` (any case) or a Priority;
    None passes through (inherit the ambient class)."""
    if value is None or isinstance(value, Priority):
        return value
    try:
        return Priority[str(value).upper()]
    except KeyError:
        raise ValueError(
            f"unknown QoS class {value!r}: expected one of "
            f"{[p.name.lower() for p in Priority]}"
        ) from None


class QoSArbiter:
    """Process-wide demand registry. ``register``/``unregister`` bracket an
    operation; ``preempted(p)`` is the admission gate. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._demand = {p: 0 for p in Priority}

    def register(self, priority: Priority) -> None:
        with self._lock:
            self._demand[priority] += 1

    def unregister(self, priority: Priority) -> None:
        with self._lock:
            self._demand[priority] -= 1

    def preempted(self, priority: Priority) -> bool:
        """True while a strictly higher class has demand (and the QoS knob
        is on)."""
        if not knobs.is_qos_enabled():
            return False
        with self._lock:
            return any(self._demand[p] > 0 for p in Priority if p > priority)

    def demand_snapshot(self) -> dict:
        with self._lock:
            return {p.name: n for p, n in self._demand.items()}

    def introspect(self) -> dict:
        """One flight-recorder sample: per-class demand, and the classes
        it preempts now."""
        return {
            "demand": self.demand_snapshot(),
            "qos_enabled": knobs.is_qos_enabled(),
            "preempted_classes": [p.name for p in Priority if self.preempted(p)],
        }


_ARBITER = QoSArbiter()


def get_arbiter() -> QoSArbiter:
    return _ARBITER


@contextlib.contextmanager
def demand_scope(priority: Priority, arbiter: Optional[QoSArbiter] = None):
    """Register demand for ``priority`` for the block: the whole-operation
    bracket (a foreground restore keeps background drains paused across
    its planning and H2D gaps, not only while its read engine runs)."""
    arb = arbiter if arbiter is not None else _ARBITER
    arb.register(priority)
    try:
        yield arb
    finally:
        arb.unregister(priority)


_PRIORITY: contextvars.ContextVar[Priority] = contextvars.ContextVar(
    "torchsnapshot_tpu_torch_qos_priority", default=Priority.NORMAL
)


def current_priority() -> Priority:
    return _PRIORITY.get()


@contextlib.contextmanager
def priority_scope(priority: Optional[Priority]):
    """Set the ambient class for the block (None: leave it). Engines read it
    at construction, so an async take's drain keeps the class the take was
    planned under although its thread never sees this context."""
    if priority is None:
        yield
        return
    token = _PRIORITY.set(priority)
    try:
        yield
    finally:
        _PRIORITY.reset(token)


async def pause_point(
    priority: Optional[Priority] = None,
    arbiter: Optional[QoSArbiter] = None,
    *,
    source: Optional[Dict[str, Any]] = None,
) -> float:
    """A cooperative preemption point for chunk loops: awaits while a higher
    class has demand, bounded by the max-pause knob. Returns the seconds
    paused (0.0 on the fast path: one arbiter check). ``source``: the
    fields naming the caller in the pause and resume events (default
    ``{"engine": "pause_point"}``; an engine's node bodies pass its kind and
    rank)."""
    import asyncio

    p = priority if priority is not None else current_priority()
    arb = arbiter if arbiter is not None else _ARBITER
    if not arb.preempted(p):
        return 0.0
    who = source if source is not None else {"engine": "pause_point"}
    t0 = time.monotonic()
    max_pause = knobs.get_qos_max_pause_s()
    poll = knobs.get_qos_poll_s()
    telemetry.counter_add("engine.preemptions")
    demand = arb.demand_snapshot()
    telemetry.recorder.record_event("engine.pause", {**who, "priority": p.name, "demand": demand})
    # The fleet's wait edge names the classes holding demand above us.
    holders = [f"class:{q.name}" for q in Priority if q > p and demand.get(q.name, 0) > 0]
    telemetry.fleet.note_blocked("qos.pause", holders)
    try:
        while arb.preempted(p):
            if max_pause > 0 and time.monotonic() - t0 >= max_pause:
                break
            await asyncio.sleep(poll)
    finally:
        telemetry.fleet.clear_blocked("qos.pause")
    waited = time.monotonic() - t0
    telemetry.counter_add("engine.preempted_wait_s", waited)
    telemetry.histogram_observe("engine.pause_s", waited)
    telemetry.recorder.record_event("engine.resume", {**who, "priority": p.name, "paused_s": round(waited, 6)})
    return waited

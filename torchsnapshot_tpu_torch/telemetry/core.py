"""Span tracing core: bounded trace buffer + context-propagated nesting.

Design constraints (why this file looks the way it does):

- **Zero overhead when disabled.** The module-level :func:`span` helper
  returns a shared no-op singleton when no :class:`Telemetry` is active —
  no Span object, no buffer touch, no lock. The take/restore hot paths are
  instrumented unconditionally, so the disabled cost must be one attribute
  load and an ``is None`` check.
- **Thread-safe.** Spans are recorded from the main thread, the async-commit
  background thread, staging/IO executor threads, and whatever event loop a
  storage plugin runs on. The buffer appends under a lock; metric updates
  take per-registry locks (see ``metrics.py``).
- **Asyncio-aware nesting.** The current span id lives in a
  :class:`contextvars.ContextVar`. ``asyncio.ensure_future`` snapshots the
  caller's context at task creation, so a span opened inside a task
  automatically parents to the span that was open where the task was
  spawned — no explicit plumbing. Executor threads do not inherit context;
  spans opened there become roots (their thread id still groups them).
- **Bounded memory.** The buffer holds at most ``capacity`` spans; overflow
  drops NEW spans (keeping the coherent head of the trace) and counts them
  in ``dropped`` so exports are never silently partial.

No dependencies outside the stdlib: this module must be importable before
torch/numpy and from every layer of the package without cycles.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import fleet

# Parent span id for the calling context (thread + asyncio task). Shared by
# every Telemetry instance: activation is global, so a single var suffices
# and keeps span() allocation-free when disabled.
_CURRENT_SPAN: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "torchsnapshot_tpu_current_span", default=None
)

DEFAULT_CAPACITY = 100_000


class Span:
    """One completed (or in-flight) span. ``ts`` is ``time.monotonic()``
    seconds at begin; ``dur`` seconds (``None`` while open). Attrs are an
    arbitrary small dict of JSON-serializable values."""

    __slots__ = (
        "name",
        "cat",
        "ts",
        "dur",
        "tid",
        "span_id",
        "parent_id",
        "attrs",
    )

    def __init__(
        self,
        name: str,
        cat: str,
        ts: float,
        span_id: int,
        parent_id: Optional[int],
        attrs: Dict[str, Any],
    ) -> None:
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur: Optional[float] = None
        self.tid = threading.get_ident()
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs

    def set_attrs(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __repr__(self) -> str:  # debugging aid only
        return (
            f"Span({self.name!r}, cat={self.cat!r}, ts={self.ts:.6f}, "
            f"dur={self.dur}, id={self.span_id}, parent={self.parent_id})"
        )


class TraceBuffer:
    """Bounded, thread-safe container of completed spans.

    Overflow drops new spans (the head of a trace — planning, staging — is
    the part every consumer needs; a ring buffer would instead keep a
    window whose start is unpredictable) and counts them."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = max(1, int(capacity))
        self.dropped = 0
        self._spans: List[Span] = []
        self._lock = threading.Lock()

    def add(self, span: Span) -> bool:
        with self._lock:
            if len(self._spans) >= self.capacity:
                self.dropped += 1
                return False
            self._spans.append(span)
            return True

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


class _SpanCtx:
    """Context manager for one live span; re-entrant use is a bug (each
    ``Telemetry.span`` call makes a fresh one)."""

    __slots__ = ("_tm", "span", "_token")

    def __init__(self, tm: "Telemetry", span: Span) -> None:
        self._tm = tm
        self.span = span
        self._token: Optional[contextvars.Token] = None

    def set_attrs(self, **attrs: Any) -> None:
        self.span.set_attrs(**attrs)

    def __enter__(self) -> "_SpanCtx":
        self.span.ts = time.monotonic()
        self._token = _CURRENT_SPAN.set(self.span.span_id)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.span.dur = time.monotonic() - self.span.ts
        if exc_type is not None:
            self.span.attrs["error"] = exc_type.__name__
        if self._token is not None:
            _CURRENT_SPAN.reset(self._token)
        self._tm.buffer.add(self.span)
        return False


class _NoopSpan:
    """Shared do-nothing span: what :func:`span` hands out when telemetry is
    off. A singleton — the disabled hot path allocates nothing."""

    __slots__ = ()

    def set_attrs(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Telemetry:
    """One tracing + metrics session (typically: one take or restore).

    Holds a bounded :class:`TraceBuffer` and a
    :class:`~.metrics.MetricsRegistry`; exporters live in ``export.py``.
    ``probe_host``: the pipelines that record into this session run the
    interpreter-lock probe (``hostprobe.py``) while they run.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, probe_host: bool = True) -> None:
        from .metrics import MetricsRegistry

        self.buffer = TraceBuffer(capacity)
        self.metrics = MetricsRegistry()
        self.probe_host = probe_host
        # Export time base: span ts are monotonic; the exporter rebases on
        # this so traces start near 0.
        self.t0 = time.monotonic()
        self.pid = os.getpid()
        self.rank: Optional[int] = None
        self._id_lock = threading.Lock()
        self._next_id = 1

    def _new_id(self) -> int:
        with self._id_lock:
            sid = self._next_id
            self._next_id += 1
            return sid

    def span(self, name: str, cat: str = "", **attrs: Any) -> _SpanCtx:
        sp = Span(
            name=name,
            cat=cat,
            ts=0.0,  # stamped on __enter__
            span_id=self._new_id(),
            parent_id=_CURRENT_SPAN.get(),
            attrs=attrs,
        )
        return _SpanCtx(self, sp)

    def add_span(
        self,
        name: str,
        cat: str,
        ts: float,
        dur: float,
        attrs: Optional[Dict[str, Any]] = None,
        tid: Optional[int] = None,
    ) -> Span:
        """Record an already-measured interval as a completed span (used by
        the scheduler, whose intervals are measured whether or not telemetry
        is on — see ``scheduler.py``)."""
        sp = Span(
            name=name,
            cat=cat,
            ts=ts,
            span_id=self._new_id(),
            parent_id=_CURRENT_SPAN.get(),
            attrs=dict(attrs) if attrs else {},
        )
        sp.dur = dur
        if tid is not None:
            sp.tid = tid
        self.buffer.add(sp)
        return sp

    def spans(self, name: Optional[str] = None, cat: Optional[str] = None) -> List[Span]:
        """Completed spans, optionally filtered by exact name and/or cat."""
        out = self.buffer.snapshot()
        if name is not None:
            out = [s for s in out if s.name == name]
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        return out


# --------------------------------------------------------------------------
# Global activation. One active Telemetry per process; activate() returns
# the previous one so nested/overlapping sessions restore correctly, and
# deactivate() is guarded so a background drain finishing late can't clobber
# a newer session's activation.
# --------------------------------------------------------------------------

_active: Optional[Telemetry] = None
_active_lock = threading.Lock()


def get_active() -> Optional[Telemetry]:
    return _active


def activate(tm: Telemetry) -> Optional[Telemetry]:
    global _active
    with _active_lock:
        prev = _active
        # Remember the chain so out-of-LIFO closes (below) can walk past
        # sessions that finished in the meantime.
        tm._prev_active = prev  # type: ignore[attr-defined]
        tm._closed = False  # type: ignore[attr-defined]
        _active = tm
        return prev


def deactivate(tm: Telemetry, prev: Optional[Telemetry] = None) -> None:
    """Restore ``prev`` as the active session, but only if ``tm`` is still
    the active one (a newer activation wins over a late-finishing drain).

    Concurrent operations close out of LIFO order — a BACKGROUND drain's
    session may finish while a FOREGROUND restore's is active, or vice
    versa — so a closed ``prev`` must not be resurrected: restore the
    nearest still-open session in the activation chain instead (else the
    leaked session would silently swallow every later op's spans)."""
    global _active
    with _active_lock:
        tm._closed = True  # type: ignore[attr-defined]
        if _active is tm:
            while prev is not None and getattr(prev, "_closed", False):
                prev = getattr(prev, "_prev_active", None)
            _active = prev


def span(name: str, cat: str = "", **attrs: Any):
    """Record a span under the active session; free no-op when none is."""
    tm = _active
    if tm is None:
        return NOOP_SPAN
    return tm.span(name, cat, **attrs)


class PhaseTracker:
    """Sequential phase boundaries as spans (replaces the hand-rolled
    ``phases[name] = now - t0`` stall-decomposition dicts): ``mark(name)``
    closes the phase that began at the previous mark. The durations dict the
    old code produced is now a *view* over the recorded spans."""

    def __init__(self, cat: str = "take.phase") -> None:
        self.cat = cat
        self.spans: List[Span] = []
        self._last = time.monotonic()
        self._seq = 0

    def mark(self, name: str, **attrs: Any) -> Span:
        now = time.monotonic()
        self._seq += 1
        sp = Span(
            name=name,
            cat=self.cat,
            ts=self._last,
            span_id=-self._seq,  # local id; re-stamped if exported
            parent_id=None,
            attrs=attrs,
        )
        sp.dur = now - self._last
        self._last = now
        self.spans.append(sp)
        tm = _active
        if tm is not None:
            tm.add_span(name, self.cat, sp.ts, sp.dur, attrs, tid=sp.tid)
        # Fleet beacon feed: phase boundaries are exactly the "where is this
        # process" signal peers need. One is-None check when the bus is off.
        fleet.note_phase(name)
        return sp

    def note(self, name: str, dur_s: float, ts: Optional[float] = None,
             **attrs: Any) -> Span:
        """An out-of-band SUB-span: a duration measured inside a phase
        (e.g. ``stage.prepare.*`` attributing ``prepare_write``'s stall)
        recorded without moving the sequential phase boundary. It rides the
        same spans list, so it persists in the telemetry artifact's
        ``phase_spans``/``phases_s`` beside the phases it decomposes."""
        self._seq += 1
        sp = Span(
            name=name,
            cat=self.cat,
            ts=ts if ts is not None else self._last - dur_s,
            span_id=-self._seq,
            parent_id=None,
            attrs=attrs,
        )
        sp.dur = dur_s
        self.spans.append(sp)
        tm = _active
        if tm is not None:
            tm.add_span(name, self.cat, sp.ts, sp.dur, attrs, tid=sp.tid)
        return sp

    @property
    def durations(self) -> Dict[str, float]:
        """{phase name: seconds} — the exact dict the stall decomposition
        used to hand-roll."""
        out: Dict[str, float] = {}
        for sp in self.spans:
            out[sp.name] = out.get(sp.name, 0.0) + (sp.dur or 0.0)
        return out

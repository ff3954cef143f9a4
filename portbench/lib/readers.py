"""What the per-metric readers (``metrics/<name>.py``) share: means over a
window's operations, the union of the port's telemetry spans, and the
device's idle share from the trace. A reader returns None where the run
holds nothing to read."""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

from . import trace
from .workload import Op, Run


def mean(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def mean_over(run: Run, kind: str, value: Callable[[Op], Optional[float]]) -> Optional[float]:
    """Mean of ``value(op)`` over the window's ``kind`` operations for which
    it is not None."""
    return mean(v for v in (value(op) for op in run.in_window(kind)) if v is not None)


def span_union_s(op: Op, names: Iterable[str]) -> Optional[float]:
    """Seconds covered by the union of the port's telemetry spans named
    ``names`` in ``op``'s session (traced runs only)."""
    tm = op.info.get("tm")
    if tm is None:
        return None
    names = set(names)
    return trace.union_s((s.ts, s.ts + s.dur) for s in tm.spans() if s.name in names and s.dur is not None)


def device_busy_s(run: Run) -> float:
    """Seconds of the window, less the reference's, in which the device
    ran an operation (the union of its kernels, memcpys and memsets)."""
    t0, t1 = run.window
    busy = trace.clip(trace.busy_intervals(run.device_events or []), t0, t1)
    return trace.length(trace.subtract(busy, run.excluded()))


def device_idle_pct(run: Run) -> Optional[float]:
    """100 x (1 - the device's busy seconds over the window's)."""
    if not run.device_events:
        return None
    return 100.0 * (1.0 - device_busy_s(run) / run.window_s)


def committed_in_window(run: Run) -> List[Op]:
    """The window's async takes whose commit came before it closed."""
    return [op for op in run.in_window("async_take") if op.info.get("t_commit") is not None and op.info["t_commit"] <= run.window[1]]


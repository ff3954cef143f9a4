"""Unified snapshot telemetry: span tracing, metrics, Perfetto export.

Every layer of the take/restore pipeline reports into this subsystem — phase
spans in ``snapshot.py``, per-task stage/io spans in ``scheduler.py``, D2H
spans in the io_preparers, per-request spans in the storage plugins, plan
metrics in the batcher/partitioner, retry counters in ``cloud_retry`` — so
"where did the time go" is answered by ONE trace instead of a pile of ad-hoc
dicts. The legacy views (``snapshot.LAST_TAKE_PHASES``, drain stats) are
derived from the same recorded intervals.

Enabling it (pick one):

- ``TSS_TORCH_TRACE=/path/trace.json`` — every take/restore records
  a session and writes a Chrome/Perfetto trace there (non-zero ranks append
  ``.rank<N>``). Open it at https://ui.perfetto.dev.
- ``Snapshot.take(path, app_state, _telemetry=telemetry.Telemetry())`` —
  programmatic capture; inspect ``tm.spans()`` / ``tm.metrics.as_dict()``
  or ``Snapshot.last_telemetry`` afterwards.
- ``python -m torchsnapshot_tpu_torch trace <snapshot>`` — traced read of an
  existing snapshot, trace written to ``--output``.

Beyond the in-process session, every take/async_take/restore also persists
a compact per-rank artifact at ``.telemetry/rank_<k>.json`` inside the
snapshot (``artifact.py``; knob ``TSS_TORCH_TELEMETRY_ARTIFACTS``,
on by default, fail-open), merged across ranks by ``aggregate.py`` and the
``stats``/``compare`` CLI subcommands; ``progress.py`` holds the live
progress counters behind ``PendingSnapshot.progress()`` and the opt-in
stall watchdog (``TSS_TORCH_STALL_WARN_S``).

When nothing is active, :func:`span` returns a shared no-op singleton and
the metric helpers return after one ``is None`` check — the instrumented
hot paths allocate nothing.

See ``docs/observability.md`` for the span/metric catalog and the artifact
schema. This package is the port's copy of ``torchsnapshot_tpu/telemetry``:
the same span and metric names, trace format (``TRACE_FORMAT_VERSION``) and
artifact schema, so each package reads the other's traces and artifacts.
Stdlib-only, like the original: no module here imports torch.
"""

from __future__ import annotations

from typing import Union

from .core import (
    NOOP_SPAN,
    PhaseTracker,
    Span,
    Telemetry,
    TraceBuffer,
    activate,
    deactivate,
    get_active,
    span,
)
from .export import (
    metrics_from_chrome_trace,
    spans_from_chrome_trace,
    to_chrome_trace,
    write_chrome_trace,
)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .progress import ProgressTracker, StallWatchdog, watchdog_thread
from . import aggregate, artifact, fleet, health, recorder, steprecord

__all__ = [
    "aggregate",
    "artifact",
    "fleet",
    "health",
    "recorder",
    "steprecord",
    "ProgressTracker",
    "StallWatchdog",
    "Telemetry",
    "Span",
    "TraceBuffer",
    "PhaseTracker",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "NOOP_SPAN",
    "span",
    "activate",
    "deactivate",
    "get_active",
    "counter_add",
    "gauge_set",
    "gauge_max",
    "histogram_observe",
    "to_chrome_trace",
    "write_chrome_trace",
    "spans_from_chrome_trace",
    "metrics_from_chrome_trace",
    "watchdog_thread",
]


# Cheap metric helpers: one None-check when telemetry is off. Instrumented
# call sites use these instead of reaching for the registry so the disabled
# path never allocates.

def counter_add(name: str, n: Union[int, float] = 1) -> None:
    tm = get_active()
    if tm is not None:
        tm.metrics.counter(name).add(n)


def gauge_set(name: str, v: Union[int, float]) -> None:
    tm = get_active()
    if tm is not None:
        tm.metrics.gauge(name).set(v)


def gauge_max(name: str, v: Union[int, float]) -> None:
    tm = get_active()
    if tm is not None:
        tm.metrics.gauge(name).set_max(v)


def histogram_observe(name: str, v: Union[int, float]) -> None:
    tm = get_active()
    if tm is not None:
        tm.metrics.histogram(name).observe(v)

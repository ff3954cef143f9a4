"""Metrics registry: counters, gauges, histograms.

Deliberately tiny — no labels-as-dimensions machinery, no export protocol.
A metric name is a flat dotted string (``storage.fs.write_bytes``); callers
that want a per-plugin dimension bake it into the name. The registry
aggregates in-process and exports one flat dict, which rides the Perfetto
trace's ``otherData`` and the CLI's summary output.

Thread-safety: get-or-create takes the registry lock; per-instrument updates
take the instrument's own lock (updates from staging/IO executor threads and
two event loops are the norm, not the exception).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Union


class Counter:
    """Monotonic accumulator (bytes written, retries, backoff seconds)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Union[int, float] = 0
        self._lock = threading.Lock()

    def add(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-set value, with the observed maximum kept alongside (the
    memory-budget high-water mark is a max, the partitioner balance is a
    last-value — one instrument serves both)."""

    __slots__ = ("name", "value", "max", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Union[int, float] = 0
        self.max: Union[int, float] = 0
        self._lock = threading.Lock()

    def set(self, v: Union[int, float]) -> None:
        with self._lock:
            self.value = v
            if v > self.max:
                self.max = v

    def set_max(self, v: Union[int, float]) -> None:
        """Keep the maximum of all observations (value tracks it too)."""
        with self._lock:
            if v > self.max:
                self.max = v
                self.value = v


# Fixed log-bucket resolution: 4 buckets per power of 2 (~19% relative
# width), scale-free — the same buckets serve seconds and bytes. The bucket
# map is sparse (a dict keyed by index), so memory tracks the observed
# dynamic range, not a preallocated axis.
_BUCKETS_PER_OCTAVE = 4


class Histogram:
    """Count/sum/min/max summary plus fixed log-bucket percentiles.

    The buckets are geometric (``_BUCKETS_PER_OCTAVE`` per power of 2), so a
    percentile is exact to one bucket's relative width (~19%) at any scale —
    good enough to tell a p99 storage write from the median without keeping
    the full distribution. The trace still carries every sample as a span;
    the histogram is the cheap aggregate that survives in the persisted
    artifact."""

    __slots__ = ("name", "count", "sum", "min", "max", "_buckets", "_nonpos", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.sum: float = 0.0
        self.min: float = float("inf")
        self.max: float = 0.0
        self._buckets: Dict[int, int] = {}
        self._nonpos = 0  # v <= 0: no log bucket; reported as 0.0
        self._lock = threading.Lock()

    def observe(self, v: Union[int, float]) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if v > 0:
                idx = math.floor(math.log2(v) * _BUCKETS_PER_OCTAVE)
                self._buckets[idx] = self._buckets.get(idx, 0) + 1
            else:
                self._nonpos += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]) from the log buckets:
        the upper edge of the bucket where the cumulative count crosses
        q% of observations, clamped into [min, max]."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = max(1.0, (q / 100.0) * self.count)
            cum = self._nonpos
            if cum >= target:
                return min(max(0.0, self.min), self.max)
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                if cum >= target:
                    upper = 2.0 ** ((idx + 1) / _BUCKETS_PER_OCTAVE)
                    return min(max(upper, self.min), self.max)
            return self.max


class MetricsRegistry:
    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def as_dict(self) -> Dict[str, Union[int, float]]:
        """Flat {name: value} snapshot. Counters/gauges export one entry;
        gauges with a distinct max add ``<name>.max``; histograms export
        ``<name>.{count,sum,min,max,mean,p50,p95,p99}``."""
        out: Dict[str, Union[int, float]] = {}
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())
        for c in counters:
            out[c.name] = c.value
        for g in gauges:
            out[g.name] = g.value
            if g.max != g.value:
                out[f"{g.name}.max"] = g.max
        for h in histograms:
            out[f"{h.name}.count"] = h.count
            out[f"{h.name}.sum"] = h.sum
            out[f"{h.name}.min"] = h.min if h.count else 0.0
            out[f"{h.name}.max"] = h.max
            out[f"{h.name}.mean"] = h.mean
            out[f"{h.name}.p50"] = h.percentile(50)
            out[f"{h.name}.p95"] = h.percentile(95)
            out[f"{h.name}.p99"] = h.percentile(99)
        return out

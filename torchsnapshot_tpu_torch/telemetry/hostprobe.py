"""The interpreter-lock probe: who holds the host while a pipeline runs.

A pipeline's threads (staging, hashing, storage copies, the D2H lanes) and
the caller's own thread (a training loop racing an async take's drain)
share one interpreter lock. CPython makes running bytecode hand the lock
over within ``sys.getswitchinterval()`` (5 ms) of another thread asking
for it, but a C call that does not release it (a ``bytes`` copy of a
large buffer, a ``bytearray.extend``) holds it to its end.

:class:`HostProbe` is one daemon thread, ``tss-gil-probe``, that sleeps
1 ms at a time (``time.sleep`` releases the lock) and reads the clock
again once it holds the lock. A wake later than the switch interval past
its due time means that a C call held the lock longer than CPython lets
running bytecode hold it (one long span), that bytecode held it for the
switch interval and the hand-over took a little more (spans just over
5 ms), or that the probe's thread got no CPU. Each such wake is a ``host.gil_wait`` span (cat ``host``) from the due time to
the wake, with ``late_s``, and adds its seconds to the counter
``host.gil_wait_s``; wakes under the threshold record nothing. The
counter is created when the probe starts, so a session that ran a probe
always carries it.

The pipelines start a probe only for a session that asked for one
(``Telemetry(probe_host=True)``, the default of an explicit session;
the artifact-only session of an untraced operation does not). It costs
the probed process one wake a millisecond. Stdlib only.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Optional

THREAD_NAME = "tss-gil-probe"
SLEEP_S = 0.001
SPAN = "host.gil_wait"
COUNTER = "host.gil_wait_s"


class HostProbe:
    """The probe of one session: :meth:`start`, then :meth:`stop`, which
    joins the thread. The thread also ends on its own once its session
    has closed, so an operation that fails between its pipeline's runs
    leaves no probe behind."""

    def __init__(self, tm: Any) -> None:
        self._tm = tm
        self.threshold_s = sys.getswitchinterval()
        self._counter = tm.metrics.counter(COUNTER)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HostProbe":
        self._thread = threading.Thread(target=self._loop, name=THREAD_NAME, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        tm, counter, threshold = self._tm, self._counter, self.threshold_s
        while not self._stop.is_set() and not getattr(tm, "_closed", False):
            due = time.monotonic() + SLEEP_S
            time.sleep(SLEEP_S)
            late = time.monotonic() - due
            if late > threshold:
                tm.add_span(SPAN, "host", due, late, {"late_s": late})
                counter.add(late)


def start_for(tm: Any) -> Optional[HostProbe]:
    """A started probe writing into ``tm`` when it is a session that asked
    for one, else None."""
    if tm is None or not tm.probe_host:
        return None
    return HostProbe(tm).start()

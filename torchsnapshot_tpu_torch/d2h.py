"""Device<->host transfers on explicit CUDA streams.

T1 (device to host): :class:`TransferLanes` runs each transfer on a lane
thread. The lane enqueues the work on a dedicated copy stream of the
source's device — after the event that marks the source ready, so it never
reads bytes the producer has not written — copies into a pinned host
tensor with ``non_blocking=True``, records an event, and waits for that
event *on the lane thread* before it hands the host tensor on. Nothing
downstream (hasher, writer) can therefore see a buffer whose copy is still
in flight. Pinned buffers come from PyTorch's caching host allocator,
which pools them across transfers; a miss of its cache calls
``cudaHostAlloc``, so each allocation is timed as a ``stage.pin_alloc``
span (:func:`pinned_empty`). A byte window bounds the transfers in
flight (``TSS_TORCH_D2H_WINDOW_BYTES``, over ``TSS_TORCH_D2H_LANES``
threads); every byte of it belongs to a staging reservation already
debited against the pipeline's memory budget, except the eager copies an
``async_take`` submits before it returns (:meth:`TransferLanes.submit_to_host`):
their pinned buffers sit outside the budget, bounded by the captured
state. A transfer may carry a ``check`` that runs on the lane once its
copy has completed (the zero-copy capture's version check).

A strided CUDA source (a piece of a shard cut along an inner dim) is first
gathered into a contiguous device buffer by kernel K3 on the lane's
stream, so the D2H copy itself is always one dense transfer.

T2 (host to device), per restore (:class:`HostToDevice`): one copy stream
per device that first waits for the caller's stream. A whole tensor is
copied from a filled pinned host tensor into the live tensor in place (or
into a fresh tensor); a saved shard piece is copied into a device staging
buffer (:meth:`HostToDevice.stage`), from which K3 scatters its overlaps
into the targets on the same stream. At the end the caller's stream waits
for the copy stream.

The side streams (fork, D2H, H2D) are one per device and role for the
process (:func:`side_stream`).

The write pipeline activates a :class:`StagingContext` through a
``contextvars.ContextVar`` around staging-task creation, so a stager finds
the pipeline's lanes with one :func:`get_active` call, and its
:class:`StageTimes`: the d2h, serialize and hash sub-stream intervals of
the staging stream, each exported as a ``stage.<kind>`` span when a
telemetry session is on. A transfer's ``stage.d2h`` interval starts when
its lane begins to enqueue it and ends when the lane's wait on the copy's
event returns: the transfer, never its enqueue alone. The session rides
into the lane threads explicitly (executor threads do not inherit
context); telemetry adds no synchronisation of its own.
"""

from __future__ import annotations

import asyncio
import contextvars
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import kernels


def require_cuda(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA on a
    host without CUDA (the port never quietly runs a CUDA request on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available on this "
            "host; pass device='cpu' to work on the CPU"
        )
    return device


_SIDE_STREAMS: Dict[Tuple[torch.device, str], torch.cuda.Stream] = {}
_SIDE_STREAMS_LOCK = threading.Lock()


def side_stream(device: torch.device, role: str) -> torch.cuda.Stream:
    """The process's one stream for ``role`` ("fork", "d2h", "h2d") on
    ``device``. One per process, not one per take: the caching allocator
    pools memory per stream, so tensors allocated on a fresh stream at
    every take (the forks, K1's slabs) would never reuse the last take's
    blocks."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    key = (device, role)
    with _SIDE_STREAMS_LOCK:
        if key not in _SIDE_STREAMS:
            _SIDE_STREAMS[key] = torch.cuda.Stream(key[0])
        return _SIDE_STREAMS[key]


def ready_event(device: torch.device) -> torch.cuda.Event:
    """An event on ``device``'s current stream: everything the caller has
    enqueued so far (the producer of the tensors about to be read)."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class StageTimes:
    """Thread-safe record of the staging sub-stream intervals (d2h,
    serialize, hash), called from the event loop and from lane, staging and
    hash threads alike. The session is captured at construction, since
    those threads do not inherit the activating context. A kind of
    ``SPAN_KINDS`` (the pinned allocations, inside ``stage.d2h``) is a
    span alone: it joins no sub-stream, so no drain stat."""

    KINDS = ("d2h", "serialize", "hash")
    SPAN_KINDS = ("pin_alloc",)

    def __init__(self, tm: Optional[Any] = None) -> None:
        self._tm = tm
        self._lock = threading.Lock()
        self._intervals: Dict[str, List[Tuple[float, float]]] = {k: [] for k in self.KINDS}

    def record(
        self,
        kind: str,
        t0: float,
        t1: float,
        path: str = "",
        nbytes: int = 0,
        span: Optional[str] = None,
    ) -> None:
        """One interval of ``kind``; its span is ``stage.<kind>`` unless
        ``span`` names another (a parallel hash chunk is a
        ``stage.hash_chunk`` in the hash sub-stream)."""
        if kind not in self.SPAN_KINDS:
            with self._lock:
                self._intervals[kind].append((t0, t1))
        tm = self._tm
        if tm is not None:
            tm.add_span(span or f"stage.{kind}", "stage", t0, t1 - t0, {"path": path, "nbytes": nbytes})
            if kind == "d2h":
                tm.metrics.counter("d2h.bytes").add(nbytes)
                tm.metrics.histogram("d2h.seconds").observe(t1 - t0)

    def intervals(self) -> Dict[str, List[Tuple[float, float]]]:
        with self._lock:
            return {k: list(v) for k, v in self._intervals.items()}


def pinned_empty(
    shape: Sequence[int], dtype: torch.dtype, times: Optional[StageTimes] = None, path: str = ""
) -> torch.Tensor:
    """An uninitialised pinned host tensor from PyTorch's caching host
    allocator; with ``times``, its allocation is a ``stage.pin_alloc``
    span of ``path`` with its ``nbytes``."""
    t0 = time.monotonic()
    host = torch.empty(shape, dtype=dtype, pin_memory=True)
    if times is not None:
        times.record("pin_alloc", t0, time.monotonic(), path=path, nbytes=host.numel() * host.element_size())
    return host


class TransferLanes:
    def __init__(self, lanes: int, window_bytes: int, times: Optional[StageTimes] = None) -> None:
        self._executor = ThreadPoolExecutor(max_workers=lanes, thread_name_prefix="tss-d2h")
        self.window_bytes = window_bytes
        # The pipeline's sub-stream record, for transfers submitted outside
        # its staging context (the eager copies).
        self.times = times
        self._cond = threading.Condition()
        self._outstanding = 0

    def _admit(self, nbytes: int) -> None:
        # One transfer larger than the window runs alone rather than never.
        with self._cond:
            while self._outstanding and self._outstanding + nbytes > self.window_bytes:
                self._cond.wait()
            self._outstanding += nbytes

    def _release(self, nbytes: int) -> None:
        with self._cond:
            self._outstanding -= nbytes
            self._cond.notify_all()

    def _run(
        self,
        device: torch.device,
        nbytes: int,
        wait: Optional[torch.cuda.Event],
        enqueue: Callable[[torch.cuda.Stream, Callable[..., torch.Tensor]], torch.Tensor],
        sources: Sequence[torch.Tensor],
        times: Optional[StageTimes] = None,
        path: str = "",
        check: Optional[Callable[[], None]] = None,
    ) -> torch.Tensor:
        self._admit(nbytes)
        try:
            t0 = time.monotonic()
            stream = side_stream(device, "d2h")
            with torch.cuda.stream(stream):
                if wait is not None:
                    stream.wait_event(wait)
                host = enqueue(stream, lambda shape, dtype: pinned_empty(shape, dtype, times, path))
                done = torch.cuda.Event()
                done.record(stream)
            for t in sources:
                # The allocator must not recycle a source's memory for the
                # producer's stream while this stream still reads it.
                t.record_stream(stream)
            done.synchronize()
            if times is not None:
                times.record("d2h", t0, time.monotonic(), path=path, nbytes=nbytes)
            if check is not None:
                check()
            return host
        finally:
            self._release(nbytes)

    @staticmethod
    def _copy_out(src: torch.Tensor) -> Callable[..., torch.Tensor]:
        def enqueue(stream: torch.cuda.Stream, pinned: Callable[..., torch.Tensor]) -> torch.Tensor:
            dense = src if src.is_contiguous() else kernels.gather(src, stream)
            host = pinned(src.shape, src.dtype)
            host.copy_(dense, non_blocking=True)
            return host

        return enqueue

    async def to_host(
        self,
        src: torch.Tensor,
        wait: Optional[torch.cuda.Event] = None,
        path: str = "",
        check: Optional[Callable[[], None]] = None,
    ) -> torch.Tensor:
        """A pinned, C-contiguous host copy of CUDA tensor ``src`` (a
        ``stage.d2h`` of ``path``); ``check`` runs once the copy is done."""
        nbytes = src.numel() * src.element_size()
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, self._run, src.device, nbytes, wait, self._copy_out(src), [src],
            current_times(), path, check,
        )

    def submit_to_host(
        self,
        src: torch.Tensor,
        wait: Optional[torch.cuda.Event] = None,
        path: str = "",
        check: Optional[Callable[[], None]] = None,
    ) -> Future[torch.Tensor]:
        """:meth:`to_host` from outside the event loop: returns at once
        with the future of the pinned host copy. The pinned allocation and
        the enqueue run on a lane thread, never on the caller's."""
        nbytes = src.numel() * src.element_size()
        return self._executor.submit(
            self._run, src.device, nbytes, wait, self._copy_out(src), [src], self.times, path, check
        )

    async def run_to_host(
        self,
        device: torch.device,
        nbytes: int,
        wait: Optional[torch.cuda.Event],
        fill: Callable[[torch.cuda.Stream, torch.Tensor], None],
        sources: Sequence[torch.Tensor],
        path: str = "",
    ) -> torch.Tensor:
        """A pinned uint8 host tensor of ``nbytes``, filled by
        ``fill(stream, host)``, which enqueues on the lane's copy stream the
        device work and the copies into ``host``."""

        def enqueue(stream: torch.cuda.Stream, pinned: Callable[..., torch.Tensor]) -> torch.Tensor:
            host = pinned((nbytes,), torch.uint8)
            fill(stream, host)
            return host

        return await asyncio.get_running_loop().run_in_executor(
            self._executor, self._run, device, nbytes, wait, enqueue, sources, current_times(), path
        )

    def shutdown(self) -> None:
        # Eager copies no staging took (an aborted take) are not started.
        self._executor.shutdown(wait=True, cancel_futures=True)


class StagingContext:
    def __init__(self, lanes: TransferLanes, times: Optional[StageTimes] = None) -> None:
        self.lanes = lanes
        self.times = times


_ACTIVE: contextvars.ContextVar[Optional[StagingContext]] = contextvars.ContextVar(
    "tss_torch_staging", default=None
)


def activate(ctx: StagingContext) -> contextvars.Token:
    return _ACTIVE.set(ctx)


def deactivate(token: contextvars.Token) -> None:
    _ACTIVE.reset(token)


def get_active() -> StagingContext:
    ctx = _ACTIVE.get()
    if ctx is None:
        raise RuntimeError("CUDA staging runs inside a write pipeline")
    return ctx


def current_times() -> Optional[StageTimes]:
    """The active pipeline's :class:`StageTimes`, or None outside one."""
    ctx = _ACTIVE.get()
    return ctx.times if ctx is not None else None


def host_to_device(
    host: torch.Tensor,
    live: Optional[torch.Tensor],
    device: torch.device,
    stream: torch.cuda.Stream,
) -> torch.Tensor:
    """T2: enqueue the copy of pinned ``host`` onto ``device`` on
    ``stream``. In place into ``live`` when it is a contiguous CUDA tensor
    of the same dtype and shape; otherwise into a fresh tensor, allocated
    on the caller's stream. ``stream`` has already waited for the caller's
    stream; the caller makes its stream wait for ``stream`` before using
    the result."""
    if (
        live is not None
        and live.device == device
        and live.dtype == host.dtype
        and live.shape == host.shape
        and live.is_contiguous()
    ):
        out = live.detach()
    else:
        out = torch.empty(host.shape, dtype=host.dtype, device=device)
    with torch.cuda.stream(stream):
        out.copy_(host, non_blocking=True)
    out.record_stream(stream)
    return out


class HostToDevice:
    """T2 for one restore: per device, one copy stream that first waits for
    the caller's stream (the live tensors may still be in use) and that the
    caller's stream waits for at :meth:`finish`. :meth:`stream` must first
    be called for a device on the caller's thread (planning does), since the
    caller's current stream is per thread."""

    def __init__(self) -> None:
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._lock = threading.Lock()

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        with self._lock:
            stream = self._streams.get(device)
            if stream is None:
                stream = side_stream(device, "h2d")
                stream.wait_stream(torch.cuda.current_stream(device))
                self._streams[device] = stream
            return stream

    def copy(self, host: torch.Tensor, live: Any, device: torch.device) -> torch.Tensor:
        """Whole-tensor T2: into ``live`` in place when it can take it."""
        live = live if isinstance(live, torch.Tensor) else None
        return host_to_device(host, live, device, self.stream(device))

    def stage(self, host: torch.Tensor, device: torch.device) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Enqueue the copy of pinned uint8 ``host`` into a device staging
        buffer, allocated on the copy stream. Returns the buffer and the
        event that marks the copy done; ``host`` must live until it is."""
        stream = self.stream(device)
        with torch.cuda.stream(stream):
            staging = torch.empty(host.shape, dtype=host.dtype, device=device)
            staging.copy_(host, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        return staging, copied

    def finish(self) -> None:
        for device, stream in self._streams.items():
            torch.cuda.current_stream(device).wait_stream(stream)
            # The pinned sources are released once the copies have run.
            stream.synchronize()

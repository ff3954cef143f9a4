"""Device<->host transfers on explicit CUDA streams.

T1 (device to host): :class:`TransferLanes` runs each transfer on a lane
thread. The lane enqueues the work on a dedicated copy stream of the
source's device — after the event that marks the source ready, so it never
reads bytes the producer has not written — copies into a pinned host
tensor with ``non_blocking=True``, records an event, and waits for that
event *on the lane thread* before it hands the host tensor on. Nothing
downstream (hasher, writer) can therefore see a buffer whose copy is still
in flight. Pinned buffers come from PyTorch's caching host allocator,
which pools them across transfers. A byte window bounds the transfers in
flight; every byte of it belongs to a staging reservation already debited
against the pipeline's memory budget.

T2 (host to device): :func:`host_to_device` copies a filled pinned host
tensor into the live tensor in place (or into a fresh tensor) on a copy
stream; the caller's stream then waits for that stream.

The side streams (fork, D2H, H2D) are one per device and role for the
process (:func:`side_stream`).

The write pipeline activates a :class:`StagingContext` through a
``contextvars.ContextVar`` around staging-task creation, so a stager finds
the pipeline's lanes with one :func:`get_active` call.
"""

from __future__ import annotations

import asyncio
import contextvars
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_LANES = 4
# Device-to-host bytes in flight at once on the lanes.
_WINDOW_BYTES = 512 * 1024 * 1024


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


class TransferLanes:
    def __init__(self, lanes: int = _LANES, window_bytes: int = _WINDOW_BYTES) -> None:
        self._executor = ThreadPoolExecutor(max_workers=lanes, thread_name_prefix="tss-d2h")
        self.window_bytes = window_bytes
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
        enqueue: Callable[[torch.cuda.Stream], torch.Tensor],
        sources: Sequence[torch.Tensor],
    ) -> torch.Tensor:
        self._admit(nbytes)
        try:
            stream = side_stream(device, "d2h")
            with torch.cuda.stream(stream):
                if wait is not None:
                    stream.wait_event(wait)
                host = enqueue(stream)
                done = torch.cuda.Event()
                done.record(stream)
            for t in sources:
                # The allocator must not recycle a source's memory for the
                # producer's stream while this stream still reads it.
                t.record_stream(stream)
            done.synchronize()
            return host
        finally:
            self._release(nbytes)

    async def to_host(
        self, src: torch.Tensor, wait: Optional[torch.cuda.Event] = None
    ) -> torch.Tensor:
        """A pinned, C-contiguous host copy of CUDA tensor ``src``."""

        def enqueue(stream: torch.cuda.Stream) -> torch.Tensor:
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            return host

        nbytes = src.numel() * src.element_size()
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, self._run, src.device, nbytes, wait, enqueue, [src]
        )

    async def run_to_host(
        self,
        device: torch.device,
        nbytes: int,
        wait: Optional[torch.cuda.Event],
        produce: Callable[[torch.cuda.Stream], torch.Tensor],
        sources: Sequence[torch.Tensor],
    ) -> torch.Tensor:
        """Run ``produce(stream)`` (which enqueues device work on the lane's
        copy stream and returns a device tensor of ``nbytes``) and copy its
        result into a pinned host tensor on the same stream."""

        def enqueue(stream: torch.cuda.Stream) -> torch.Tensor:
            out = produce(stream)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            return host

        return await asyncio.get_running_loop().run_in_executor(
            self._executor, self._run, device, nbytes, wait, enqueue, sources
        )

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)


class StagingContext:
    def __init__(self, lanes: TransferLanes) -> None:
        self.lanes = lanes


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

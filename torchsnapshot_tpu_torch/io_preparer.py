"""Value -> (Entry, WriteReqs) dispatch, and the async-take capture.

Routing (single process):

- primitives -> inline :class:`PrimitiveEntry`;
- ``torch.Tensor`` (CPU or CUDA; an ``nn.Parameter`` is detached) and
  numpy arrays of a plain dtype -> the array path, chunked along dim 0
  above ``MAX_CHUNK_SIZE_BYTES``;
- anything else -> a pickled object.

A DTensor is refused until sharded state is ported.

**The async capture** (:func:`capture_flattened`). Torch tensors are
mutated in place by the optimizer step, so ``async_take`` must detach the
snapshot from the live tensors before it returns. CPU tensors are copied at
staging, which runs before the return. CUDA tensors are forked on the card
by kernel K2 (:func:`..kernels.fork_copy`), one launch per device, on a fork
stream with edges in both directions:

- the fork stream waits for the caller's current stream (the producer of
  the values being captured);
- the caller's current stream waits for the fork's completion event, so
  the next in-place update cannot overwrite a tensor before the fork has
  read it.

The forks' D2H runs later, in the background drain, after the same
completion event. When the fork runs out of device memory, the group is
bisected (depth 2) so what fits stays forked; the leaves that still do not
fit are captured through pinned host RAM before ``async_take`` returns,
with a warning and a count in :data:`HOST_CAPTURED`.
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import d2h, kernels
from .io_types import WriteReq
from .io_preparers.array import ArrayIOPreparer
from .io_preparers.chunked_array import ChunkedArrayIOPreparer, should_chunk
from .io_preparers.object import ObjectIOPreparer
from .manifest import PRIMITIVE_TYPES, Manifest, PrimitiveEntry
from .serialization import numpy_dtype_to_string

logger = logging.getLogger(__name__)

# Leaves captured through host RAM because their fork did not fit, over
# the life of the process.
HOST_CAPTURED = {"leaves": 0, "bytes": 0}

# Bisection depth of a fork that ran out of device memory (the reference's
# _MAX_FORK_BISECT_DEPTH).
_MAX_FORK_BISECT_DEPTH = 2


def get_storage_path(logical_path: str, rank: int, replicated: bool) -> str:
    return f"replicated/{logical_path}" if replicated else f"{rank}/{logical_path}"


def _is_dtensor(value: Any) -> bool:
    # No DTensor exists unless its module was imported; importing it here
    # would cost seconds (it pulls in sympy) on every first take.
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(value, module.DTensor)


def classify(value: Any) -> str:
    """One of: primitive | array | object."""
    if isinstance(value, PRIMITIVE_TYPES) and not isinstance(value, np.generic):
        return "primitive"
    if isinstance(value, torch.Tensor):
        if _is_dtensor(value):
            raise NotImplementedError(
                "DTensor state is not supported by this package yet"
            )
        return "array"
    if isinstance(value, np.ndarray) and numpy_dtype_to_string(value.dtype):
        return "array"
    return "object"


def _as_tensor(value: Any) -> Tuple[torch.Tensor, Optional[str]]:
    """The tensor to stage, and the dtype string when the leaf is numpy."""
    if isinstance(value, np.ndarray):
        # np.ascontiguousarray would turn a 0-dim array into a 1-dim one.
        arr = value if value.flags["C_CONTIGUOUS"] else value.copy(order="C")
        return torch.from_numpy(arr), numpy_dtype_to_string(value.dtype)
    return value.detach(), None


# ---------------------------------------------------------------------------
# The async capture (K2)
# ---------------------------------------------------------------------------


def _host_capture_group(group: List[torch.Tensor], stream: torch.cuda.Stream) -> List[torch.Tensor]:
    """Blocking capture of CUDA tensors into private pinned host tensors,
    from the originals, on ``stream`` (which has waited for the producer)."""
    outs = []
    with torch.cuda.stream(stream):
        for t in group:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            outs.append(host)
    stream.synchronize()
    return outs


def _fork_or_capture(
    group: List[torch.Tensor],
    fork: Callable[[List[torch.Tensor]], List[torch.Tensor]],
    capture: Callable[[List[torch.Tensor]], List[torch.Tensor]],
    captured: List[torch.Tensor],
    depth: int = 0,
) -> List[torch.Tensor]:
    """Fork ``group``; on ``torch.cuda.OutOfMemoryError`` bisect so what
    fits stays forked, and capture the rest through host RAM."""
    try:
        return fork(group)
    except torch.cuda.OutOfMemoryError:
        pass
    if len(group) == 1 or depth >= _MAX_FORK_BISECT_DEPTH:
        captured.extend(group)
        return capture(group)
    mid = len(group) // 2
    return _fork_or_capture(group[:mid], fork, capture, captured, depth + 1) + _fork_or_capture(
        group[mid:], fork, capture, captured, depth + 1
    )


def _defensive_device_copies(
    tensors: List[torch.Tensor],
) -> Tuple[List[torch.Tensor], Dict[torch.device, torch.cuda.Event]]:
    """Fork CUDA tensors, one K2 launch per device. Returns the captures in
    input order and, per device, the event after which they are final."""
    groups: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    events: Dict[torch.device, torch.cuda.Event] = {}
    captured: List[torch.Tensor] = []
    for device, indices in groups.items():
        current = torch.cuda.current_stream(device)
        stream = d2h.side_stream(device, "fork")
        stream.wait_stream(current)
        copies = _fork_or_capture(
            [tensors[i] for i in indices],
            lambda g: kernels.fork_copy(g, stream=stream),
            lambda g: _host_capture_group(g, stream),
            captured,
        )
        done = torch.cuda.Event()
        done.record(stream)
        current.wait_event(done)
        events[device] = done
        for i, c in zip(indices, copies):
            out[i] = c
    if captured:
        nbytes = sum(t.numel() * t.element_size() for t in captured)
        HOST_CAPTURED["leaves"] += len(captured)
        HOST_CAPTURED["bytes"] += nbytes
        logger.warning(
            "async_take fork ran out of device memory: %d of %d tensors "
            "(%.3f GB) were captured through host RAM before returning",
            len(captured),
            len(tensors),
            nbytes / 1e9,
        )
    return out, events  # type: ignore[return-value]


def capture_flattened(
    flattened: Dict[str, Any],
) -> Tuple[Dict[str, Any], Set[str], Dict[torch.device, torch.cuda.Event]]:
    """Replace CUDA tensor leaves by private captures (their K2 forks).
    Returns the new dict (the input is not mutated), the captured paths,
    and the per-device events after which the forks are final."""
    paths = [
        p for p, v in flattened.items()
        if isinstance(v, torch.Tensor) and v.device.type == "cuda"
    ]
    if not paths:
        return flattened, set(), {}
    copies, events = _defensive_device_copies([flattened[p].detach() for p in paths])
    flattened = dict(flattened)
    flattened.update(zip(paths, copies))
    return flattened, set(paths), events


# ---------------------------------------------------------------------------
# prepare_write
# ---------------------------------------------------------------------------


def prepare_write(
    flattened: Dict[str, Any],
    rank: int,
    replicated_paths: Set[str],
    is_async_snapshot: bool = False,
    ready: Optional[Dict[torch.device, torch.cuda.Event]] = None,
    captured_paths: Set[str] = frozenset(),
) -> Tuple[Manifest, List[WriteReq]]:
    """Plan all writes of this rank's flattened state; no data moves.

    ``ready``: per CUDA device, the event after which the tensors to stage
    are final (the caller's stream at take time, or the fork's event).
    ``captured_paths``: leaves that are already private captures
    (:func:`capture_flattened`); nothing the caller does can reach them, so
    their staging is deferred past ``async_take``'s return."""
    manifest: Manifest = {}
    write_reqs: List[WriteReq] = []
    ready = ready or {}
    for logical_path, value in flattened.items():
        kind = classify(value)
        replicated = logical_path in replicated_paths
        if kind == "primitive":
            manifest[logical_path] = PrimitiveEntry.from_value(value, replicated=replicated)
            continue
        storage_path = get_storage_path(logical_path, rank, replicated)
        if kind == "object":
            entry, reqs = ObjectIOPreparer.prepare_write(storage_path, value, replicated)
            manifest[logical_path] = entry
            write_reqs.extend(reqs)
            continue
        tensor, dtype_str = _as_tensor(value)
        captured = logical_path in captured_paths
        preparer = ChunkedArrayIOPreparer if should_chunk(tensor) else ArrayIOPreparer
        entry, reqs = preparer.prepare_write(
            storage_path,
            tensor,
            replicated,
            is_async_snapshot and not captured,
            ready.get(tensor.device),
            dtype_str,
        )
        manifest[logical_path] = entry
        for r in reqs:
            r.defer_staging = captured
        write_reqs.extend(reqs)
    return manifest, write_reqs

"""Value -> (Entry, WriteReqs) dispatch, and the async-take capture.

Routing (``classify``, after ``torchsnapshot_tpu/io_preparer.py``):

- primitives -> inline :class:`PrimitiveEntry`;
- a DTensor with only ``Replicate`` placements over a mesh of every rank
  -> the replicated array path (saved once, the write load split by the
  partitioner); a DTensor with any ``Shard`` placement (or over a mesh of
  some ranks only) -> the sharded path (``io_preparers/sharded_array.py``);
  a DTensor arrives here as a :class:`DTensorLeaf` (:func:`as_leaves`);
- ``torch.Tensor`` (CPU or CUDA; an ``nn.Parameter`` is detached) and
  numpy arrays -> the per-rank array path (``<rank>/``), or the replicated
  one when a ``replicated=`` glob names it; chunked along dim 0 above
  ``MAX_CHUNK_SIZE_BYTES``. A numpy array whose dtype has no raw form
  (``<U3``, ``object``) is pickled, whole or per chunk, as the reference
  writes it (``ArrayEntry(serializer="pickle")``);
- anything else -> a pickled object.

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

The forks' D2H runs later (eagerly on the transfer lanes, or in the
background drain), after the same completion event. When the fork runs
out of device memory (a real ``torch.cuda.OutOfMemoryError``, or the
cumulative forked bytes passing ``TSS_TORCH_ASYNC_FORK_HBM_LIMIT_BYTES``),
the group is bisected (depth 2) so what fits stays forked; the leaves that
still do not fit are captured through pinned host RAM before
``async_take`` returns, with a warning and a count in
:data:`HOST_CAPTURED`. The decision is :func:`_fork_or_capture`, a plain
function the CPU tests drive with a CPU fork.

Under ``TSS_TORCH_ASYNC_CAPTURE=donate`` (or ``ASYNC_DEVICE_COPY=0``) CUDA
tensors are captured zero-copy: no K2 launch and no device memory. The
caller promises not to change them in place until the snapshot commits;
each captured tensor's version counter is checked once its D2H has
completed, and a broken promise fails the take.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import d2h, kernels
from .io_types import WriteReq
from .io_preparers.array import ArrayBufferStager, ArrayIOPreparer, is_pickled_array
from .io_preparers.chunked_array import ChunkedArrayIOPreparer, should_chunk, should_chunk_pickled
from .io_preparers.object import ObjectIOPreparer
from .io_preparers.sharded_array import DTensorLeaf, ShardedArrayIOPreparer, dtensor_leaf
from .manifest import PRIMITIVE_TYPES, Manifest, PrimitiveEntry
from .serialization import numpy_dtype_to_string, string_to_dtype
from .utils import knobs

logger = logging.getLogger(__name__)

# Leaves captured through host RAM because their fork did not fit, over
# the life of the process.
HOST_CAPTURED = {"leaves": 0, "bytes": 0}

# Bisection depth of a fork that ran out of device memory (the reference's
# _MAX_FORK_BISECT_DEPTH).
_MAX_FORK_BISECT_DEPTH = 2


def get_storage_path(logical_path: str, rank: int, replicated: bool) -> str:
    return f"replicated/{logical_path}" if replicated else f"{rank}/{logical_path}"


def is_dtensor(value: Any) -> bool:
    # No DTensor exists unless its module was imported; importing it here
    # would cost seconds (it pulls in sympy) on every first take.
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(value, module.DTensor)


def as_leaves(flattened: Dict[str, Any]) -> Dict[str, Any]:
    """``flattened`` with each DTensor replaced by its :class:`DTensorLeaf`
    (the input is not mutated)."""
    if not any(is_dtensor(v) for v in flattened.values()):
        return flattened
    return {p: dtensor_leaf(v) if is_dtensor(v) else v for p, v in flattened.items()}


def classify(value: Any, world_size: int = 1) -> str:
    """One of: primitive | sharded | replicated_array | array | object."""
    if isinstance(value, PRIMITIVE_TYPES) and not isinstance(value, np.generic):
        return "primitive"
    if is_dtensor(value):
        value = dtensor_leaf(value)
    if isinstance(value, DTensorLeaf):
        if value.fully_replicated and value.mesh_size == world_size:
            return "replicated_array"
        return "sharded"
    if isinstance(value, torch.Tensor):
        return "array"
    if isinstance(value, np.ndarray):
        return "array"
    return "object"


def _as_tensor(value: Any) -> Tuple[torch.Tensor, Optional[str]]:
    """The tensor to stage, and the dtype string when the leaf is numpy."""
    if isinstance(value, np.ndarray):
        # np.ascontiguousarray would turn a 0-dim array into a 1-dim one.
        arr = value if value.flags["C_CONTIGUOUS"] else value.copy(order="C")
        name = numpy_dtype_to_string(value.dtype)
        if arr.dtype.kind == "V":
            # An ml_dtypes extension: torch takes it through an unsigned view
            # of its width, as the dtype torch has, or as bytes (one value
            # per byte, as the reference stores it).
            return torch.from_numpy(arr.view(f"u{arr.dtype.itemsize}")).view(string_to_dtype(name)), name
        return torch.from_numpy(arr), name
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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fork_or_capture(
    group: List[torch.Tensor],
    fork: Callable[[List[torch.Tensor]], List[torch.Tensor]],
    capture: Callable[[List[torch.Tensor]], List[torch.Tensor]],
    captured: List[torch.Tensor],
    depth: int = 0,
    limit: Optional[int] = None,
    forked_bytes: Optional[List[int]] = None,
) -> List[torch.Tensor]:
    """Fork ``group``; on ``torch.cuda.OutOfMemoryError`` bisect so what
    fits stays forked, and capture the rest through host RAM. ``limit``
    (``TSS_TORCH_ASYNC_FORK_HBM_LIMIT_BYTES``) makes a fork that would
    bring the take's cumulative forked bytes (``forked_bytes[0]``) above
    it count as out of memory, before it runs."""
    forked_bytes = forked_bytes if forked_bytes is not None else [0]
    need = sum(_nbytes(t) for t in group)
    try:
        if limit is not None and forked_bytes[0] + need > limit:
            raise torch.cuda.OutOfMemoryError(
                f"simulated device memory limit ({forked_bytes[0]} + {need} > {limit} bytes)"
            )
        out = fork(group)
        forked_bytes[0] += need
        return out
    except torch.cuda.OutOfMemoryError:
        pass
    if len(group) == 1 or depth >= _MAX_FORK_BISECT_DEPTH:
        captured.extend(group)
        return capture(group)
    mid = len(group) // 2
    return _fork_or_capture(
        group[:mid], fork, capture, captured, depth + 1, limit, forked_bytes
    ) + _fork_or_capture(group[mid:], fork, capture, captured, depth + 1, limit, forked_bytes)


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
    limit = knobs.get_async_fork_hbm_limit_bytes()
    # Cumulative forked bytes of this take, for the simulated limit.
    forked_bytes = [0]
    for device, indices in groups.items():
        current = torch.cuda.current_stream(device)
        stream = d2h.side_stream(device, "fork")
        stream.wait_stream(current)
        copies = _fork_or_capture(
            [tensors[i] for i in indices],
            lambda g: kernels.fork_copy(g, stream=stream),
            lambda g: _host_capture_group(g, stream),
            captured,
            limit=limit,
            forked_bytes=forked_bytes,
        )
        done = torch.cuda.Event()
        done.record(stream)
        current.wait_event(done)
        events[device] = done
        for i, c in zip(indices, copies):
            out[i] = c
    if captured:
        nbytes = sum(_nbytes(t) for t in captured)
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


def cuda_source(value: Any) -> Optional[torch.Tensor]:
    """The CUDA tensor a leaf stages from (a DTensor leaf's local shard)."""
    t = value.local if isinstance(value, DTensorLeaf) else value
    return t if isinstance(t, torch.Tensor) and t.device.type == "cuda" else None


def capture_flattened(
    flattened: Dict[str, Any],
) -> Tuple[Dict[str, Any], Set[str], Dict[torch.device, torch.cuda.Event]]:
    """Replace CUDA tensor leaves, and the local shards of DTensor leaves,
    by private captures (their K2 forks). Returns the new dict (the input
    is not mutated), the captured paths, and the per-device events after
    which the captures are final. Under a zero-copy capture (``donate``,
    or the device copy off) the leaves stay as they are; the events mark
    the caller's streams, and the stagers check the tensors' versions."""
    paths = [p for p, v in flattened.items() if cuda_source(v) is not None]
    if not paths:
        return flattened, set(), {}
    if knobs.get_async_capture_mode() == "donate":
        devices = {cuda_source(flattened[p]).device for p in paths}
        return flattened, set(paths), {dev: d2h.ready_event(dev) for dev in devices}
    copies, events = _defensive_device_copies(
        [cuda_source(flattened[p]).detach() for p in paths]
    )
    flattened = dict(flattened)
    for p, c in zip(paths, copies):
        v = flattened[p]
        flattened[p] = dataclasses.replace(v, local=c) if isinstance(v, DTensorLeaf) else c
    return flattened, set(paths), events


# ---------------------------------------------------------------------------
# prepare_write
# ---------------------------------------------------------------------------


def prepare_write(
    flattened: Dict[str, Any],
    rank: int,
    world_size: int,
    replicated_paths: Set[str],
    is_async_snapshot: bool = False,
    ready: Optional[Dict[torch.device, torch.cuda.Event]] = None,
    captured_paths: Set[str] = frozenset(),
    leaf_index: Optional[Dict[str, List[WriteReq]]] = None,
) -> Tuple[Manifest, List[WriteReq]]:
    """Plan all writes of this rank's flattened state; no data moves.

    ``ready``: per CUDA device, the event after which the tensors to stage
    are final (the caller's stream at take time, or the fork's event).
    ``captured_paths``: leaves that are already captures
    (:func:`capture_flattened`): private forks, or zero-copy captures
    under the caller's promise; their staging is deferred past
    ``async_take``'s return, and each CUDA one's version is pinned.
    ``leaf_index``: filled with each leaf's write requests (for the
    prepared-take cache)."""
    manifest: Manifest = {}
    write_reqs: List[WriteReq] = []
    ready = ready or {}
    for logical_path, value in flattened.items():
        start = len(write_reqs)
        _prepare_leaf(logical_path, value, rank, world_size, replicated_paths,
                      is_async_snapshot, ready, captured_paths, manifest, write_reqs)
        if leaf_index is not None:
            leaf_index[logical_path] = write_reqs[start:]
    return manifest, write_reqs


def _prepare_leaf(
    logical_path: str,
    value: Any,
    rank: int,
    world_size: int,
    replicated_paths: Set[str],
    is_async_snapshot: bool,
    ready: Dict[torch.device, Any],
    captured_paths: Set[str],
    manifest: Manifest,
    write_reqs: List[WriteReq],
) -> None:
    """Plan one leaf's entry and write requests (``prepare_write``)."""
    kind = classify(value, world_size)
    replicated = logical_path in replicated_paths or kind == "replicated_array"
    captured = logical_path in captured_paths
    if kind == "primitive":
        manifest[logical_path] = PrimitiveEntry.from_value(value, replicated=replicated)
        return
    if kind == "sharded":
        entry, reqs = ShardedArrayIOPreparer.prepare_write(
            logical_path,
            value,
            is_async_snapshot and not captured,
            ready.get(value.local.device),
        )
        manifest[logical_path] = entry
        _mark_captured(reqs, captured)
        write_reqs.extend(reqs)
        return
    if isinstance(value, DTensorLeaf):
        value = value.local
    storage_path = get_storage_path(logical_path, rank, replicated)
    if kind == "object":
        entry, reqs = ObjectIOPreparer.prepare_write(storage_path, value, replicated)
        manifest[logical_path] = entry
        write_reqs.extend(reqs)
        return
    if is_pickled_array(value):
        preparer = ChunkedArrayIOPreparer if should_chunk_pickled(value) else ArrayIOPreparer
        entry, reqs = preparer.prepare_pickled_write(storage_path, value, replicated)
        manifest[logical_path] = entry
        write_reqs.extend(reqs)
        return
    tensor, dtype_str = _as_tensor(value)
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
    _mark_captured(reqs, captured)
    write_reqs.extend(reqs)


def _mark_captured(reqs: List[WriteReq], captured: bool) -> None:
    """Defer a captured leaf's staging and pin its tensors' versions."""
    for r in reqs:
        r.defer_staging = captured
        if captured and isinstance(r.buffer_stager, ArrayBufferStager):
            r.buffer_stager.pin_version()

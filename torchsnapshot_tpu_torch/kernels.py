"""The port's hand-written CUDA kernels, their plain PyTorch versions,
and the build that compiles them.

- K1 :func:`pack_slab` replaces ``torchsnapshot_tpu/batcher.py::
  _pack_to_device_bytes``: the raw little-endian C-order bytes of a slab's
  members, concatenated into one uint8 tensor.
- K2 :func:`fork_copy` replaces ``torchsnapshot_tpu/io_preparer.py::
  _batch_copy_fn``: a bitwise copy of every tensor of a group.
- K3 :func:`copy_blocks` replaces the overlap scatter of
  ``torchsnapshot_tpu/io_preparers/sharded_array.py``
  (``ShardedArrayBufferConsumer.consume_buffer``, ``_shard_piece_deliver``):
  a copy of many strided views into strided views, e.g. a saved shard
  piece's overlap with a target shard into that target, in place.

Each is one launch of a multi-tensor byte copy over a descriptor table
(``csrc/tss_kernels.cu`` has the design and the bound: each byte read once
and written once, 2 x bytes / 3.35 TB/s on an H100). A wrapper runs the
plain version only for tensors on the CPU. For CUDA tensors it launches
the kernel or raises; there is no fallback, at any size.

K3's table holds one descriptor per rectangle of a contiguous row and up
to :data:`K3_MAX_DIMS` collapsed dims outside it (each outer dim's size,
byte strides and fast-divmod multiplier and shift, computed here), and
goes to the kernel by value as one ``__grid_constant__`` parameter when it
fits (151 descriptors; the build needs CUDA 12.1 or later), else through a pinned buffer the
wrapper reuses per device. The grid is sized to the card
(:func:`k3_chunk_bytes`). Measured on an H100 against the earlier design
(one descriptor per index of every dim beyond three, 64 KiB blocks, two
64-bit divisions per narrow-row unit, a table uploaded from a new pinned
tensor per call), it runs a 4 MiB rank-4 rectangle of 128-byte rows in
half the device time and its wrapper in about a third of the host time,
and is as fast or faster at the main path's shapes (``PERF.md``).

The library is built at first use with ``nvcc`` into ``_build/`` beside
this file (git-ignored), from ``csrc/`` alone, and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "csrc", "tss_kernels.cu")
_BUILD_DIR = os.path.join(_HERE, "_build")

# Launch counts: a wrapper adds one where it launches its kernel, nowhere
# else. Read by callers that must show a run went through the kernels.
LAUNCHES: Dict[str, int] = {"pack_slab": 0, "fork_copy": 0, "copy_blocks": 0}
_COUNT_LOCK = threading.Lock()

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
# Seconds the first load spent compiling (0.0 when already built).
BUILD_SECONDS = 0.0

# Dtypes K1 carries: every byte-width dtype whose storage bytes are its raw
# little-endian encoding (batcher.py:_DEVICE_PACKABLE_DTYPES minus those
# torch lacks). No complex, no sub-byte types.
PACKABLE_DTYPES = frozenset(
    {
        torch.bool,
        torch.int8,
        torch.int16,
        torch.int32,
        torch.int64,
        torch.uint8,
        torch.uint16,
        torch.uint32,
        torch.uint64,
        torch.float16,
        torch.float32,
        torch.float64,
        torch.bfloat16,
        torch.float8_e4m3fn,
        torch.float8_e5m2,
        torch.float8_e4m3fnuz,
        torch.float8_e5m2fnuz,
    }
)

_DESC_DTYPE = np.dtype(
    [("src", "<u8"), ("dst", "<u8"), ("begin", "<u8"), ("nbytes", "<u8")]
)
# K3's rectangle (csrc/tss_kernels.cu: TssRect): dims outside the row
# innermost first, unused entries 0.
_RECT_DTYPE = np.dtype(
    [(name, "<u8") for name in ("src", "dst", "begin", "nbytes", "row_bytes", "rows")]
    + [(name, "<u8", (5,)) for name in ("size", "src_stride", "dst_stride")]
    + [("mul", "<u4", (5,)), ("shift", "<u4", (5,)), ("ndim", "<u4"), ("grain", "<u4")]
)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME/bin/nvcc or PATH): the CUDA kernels of "
        "torchsnapshot_tpu_torch are built from csrc/ at first use"
    )


def _build() -> str:
    """Compile ``csrc/tss_kernels.cu`` for sm_90a unless a library built
    from the same source exists; returns its path. A file lock serialises
    concurrent builders (several processes of one checkout)."""
    global BUILD_SECONDS
    with open(_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_BUILD_DIR, f"libtss_kernels-{tag}.so")
    with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path):
            return lib_path
        t0 = time.monotonic()
        tmp = f"{lib_path}.tmp.{os.getpid()}"
        cmd = [
            _nvcc(),
            "-gencode",
            "arch=compute_90a,code=sm_90a",
            "-std=c++17",
            "-O3",
            "-shared",
            "-Xcompiler",
            "-fPIC",
            "-o",
            tmp,
            _SOURCE,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
        BUILD_SECONDS = time.monotonic() - t0
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            for name in ("tss_pack_slab", "tss_fork_copy"):
                fn = getattr(lib, name)
                fn.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_int,
                    ctypes.c_ulonglong,
                    ctypes.c_void_p,
                ]
                fn.restype = ctypes.c_int
            lib.tss_copy_blocks.argtypes = [
                ctypes.c_void_p,  # host table
                ctypes.c_int,
                ctypes.c_void_p,  # device table, or None to pass the table by value
                ctypes.c_ulonglong,
                ctypes.c_ulonglong,
                ctypes.c_void_p,
            ]
            lib.tss_copy_blocks.restype = ctypes.c_int
            lib.tss_empty.argtypes = [ctypes.c_void_p]
            lib.tss_empty.restype = ctypes.c_int
            for name in ("tss_desc_size", "tss_rect_desc_size", "tss_copy_blocks_inline_max"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = ctypes.c_int
            if (
                lib.tss_desc_size() != _DESC_DTYPE.itemsize
                or lib.tss_rect_desc_size() != _RECT_DTYPE.itemsize
                or lib.tss_copy_blocks_inline_max() != k3_inline_capacity()
            ):
                raise RuntimeError("descriptor layout mismatch with csrc/")
            _LIB = lib
        return _LIB


# ---------------------------------------------------------------------------
# Shared plumbing
# ---------------------------------------------------------------------------


def _is_dense(t: torch.Tensor) -> bool:
    """Non-overlapping and dense: the elements fill exactly
    ``numel * itemsize`` bytes starting at ``data_ptr()`` (any permutation
    of a contiguous layout, e.g. a transposed matrix)."""
    if t.is_contiguous() or t.numel() == 0:
        return True
    dims = sorted(
        ((n, s) for n, s in zip(t.shape, t.stride()) if n != 1),
        key=lambda d: d[1],
    )
    expected = 1
    for n, s in dims:
        if s != expected:
            return False
        expected *= n
    return True


def _single_device(tensors: Sequence[torch.Tensor]) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors span several devices: {sorted(map(str, devices))}")
    return next(iter(devices))


def descriptor_table(
    srcs: Sequence[torch.Tensor],
    dst_ptrs: Sequence[int],
    device: torch.device,
) -> Tuple[Optional[torch.Tensor], int, int]:
    """Upload the (src, dst, begin, nbytes) table of the non-empty members
    to ``device`` on the current stream; returns (table, count, total
    bytes), with no table when every member is empty."""
    descs = np.zeros(len(srcs), dtype=_DESC_DTYPE)
    begin = 0
    n = 0
    for t, dst in zip(srcs, dst_ptrs):
        nbytes = t.numel() * t.element_size()
        if nbytes == 0:
            continue
        descs[n] = (t.data_ptr(), dst, begin, nbytes)
        begin += nbytes
        n += 1
    if n == 0:
        return None, 0, 0
    # The pinned table's host memory stays valid until the copy ran: the
    # caching host allocator records an event on the stream for it.
    table = torch.from_numpy(descs[:n].view(np.uint8)).pin_memory()
    return table.to(device, non_blocking=True), n, begin


def launch_raw(name: str, table: torch.Tensor, n: int, total: int, stream: torch.cuda.Stream) -> None:
    """One launch of kernel ``name`` over an uploaded table. Not counted:
    the wrappers count; this is also the timing entry point."""
    rc = getattr(load_library(), f"tss_{name}")(table.data_ptr(), n, total, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launch(
    name: str,
    srcs: Sequence[torch.Tensor],
    dst_ptrs: Sequence[int],
    device: torch.device,
    stream: torch.cuda.Stream,
) -> None:
    """Upload the descriptor table and launch one kernel on ``stream``.
    The caller has made every source dense and holds ``stream`` current."""
    table, n, total = descriptor_table(srcs, dst_ptrs, device)
    if table is None:
        return
    launch_raw(name, table, n, total, stream)
    _count(name)


# ---------------------------------------------------------------------------
# K1: pack_slab
# ---------------------------------------------------------------------------


def pack_slab_plain(members: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch K1: each member's C-order bytes, concatenated (bool as
    its 0/1 byte, which is ``astype(uint8)``)."""
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in members]
    if not parts:
        return torch.empty(0, dtype=torch.uint8)
    return torch.cat(parts)


def pack_slab(
    members: Sequence[torch.Tensor],
    stream: Optional[torch.cuda.Stream] = None,
) -> torch.Tensor:
    """K1. Returns a uint8 tensor of ``sum(member nbytes)`` on the members'
    device. CPU members take :func:`pack_slab_plain`; CUDA members launch
    ``tss_pack_slab`` on ``stream`` (default: the current stream).

    Precondition of the kernel: C-contiguous members. The wrapper gathers
    a non-contiguous member with K3 first (on the same stream)."""
    if not members:
        return torch.empty(0, dtype=torch.uint8)
    device = _single_device(members)
    for t in members:
        if t.dtype not in PACKABLE_DTYPES:
            raise TypeError(f"pack_slab cannot carry dtype {t.dtype}")
    if device.type == "cpu":
        return pack_slab_plain(members)
    if device.type != "cuda":
        raise ValueError(f"pack_slab: unsupported device {device}")
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        srcs = [t if t.is_contiguous() else gather(t, stream) for t in members]
        total = sum(t.numel() * t.element_size() for t in srcs)
        out = torch.empty(total, dtype=torch.uint8, device=device)
        offsets: List[int] = []
        off = 0
        for t in srcs:
            offsets.append(out.data_ptr() + off)
            off += t.numel() * t.element_size()
        _launch("pack_slab", srcs, offsets, device, stream)
    return out


# ---------------------------------------------------------------------------
# K2: fork_copy
# ---------------------------------------------------------------------------


def fork_copy_plain(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain PyTorch K2."""
    return [t.clone() for t in tensors]


def fork_copy(
    tensors: Sequence[torch.Tensor],
    stream: Optional[torch.cuda.Stream] = None,
) -> List[torch.Tensor]:
    """K2. Bitwise copies of ``tensors`` (same dtype, shape, strides and
    device). CPU tensors take :func:`fork_copy_plain`; a group of CUDA
    tensors of one device is copied by ONE ``tss_fork_copy`` launch on
    ``stream`` (default: the current stream). The outputs are allocated on
    ``stream`` with ``torch.empty`` — ``torch.cuda.OutOfMemoryError`` from
    there is the caller's signal to split the group.

    Precondition of the kernel: dense tensors (no gaps, no overlap; any
    permutation of strides). The wrapper gathers a non-dense view with K3
    first, and its copy is then contiguous."""
    if not tensors:
        return []
    device = _single_device(tensors)
    if device.type == "cpu":
        return fork_copy_plain(tensors)
    if device.type != "cuda":
        raise ValueError(f"fork_copy: unsupported device {device}")
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        srcs = [t if _is_dense(t) else gather(t, stream) for t in tensors]
        outs = [
            torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)
            for t in srcs
        ]
        _launch("fork_copy", srcs, [o.data_ptr() for o in outs], device, stream)
    return outs


# ---------------------------------------------------------------------------
# K3: copy_blocks
# ---------------------------------------------------------------------------

_RECT_ALIGN = 16  # rectangles start 16-byte aligned in the virtual space
# Collapsed dims one descriptor holds outside its contiguous row (csrc:
# kMaxDims); a view that keeps more is cut on its outermost dims.
K3_MAX_DIMS = 5
K3_THREADS = 256  # threads per block (csrc: kK3Threads)
K3_UNROLL = 4  # loads each thread issues before their stores (csrc: kUnroll)
# Bytes of kernel parameters on sm_90 (csrc: kParamBytes; the build needs
# CUDA 12.1 or later); the table header (total, chunk, count) takes 24.
K3_PARAM_BYTES = 32764
_K3_TABLE_HEADER = 24
_RECT_STRUCT = struct.Struct(f"<6Q{3 * K3_MAX_DIMS}Q{2 * K3_MAX_DIMS}I2I")
assert _RECT_STRUCT.size == _RECT_DTYPE.itemsize


def k3_inline_capacity() -> int:
    """Descriptors that go to K3 by value, as one kernel parameter of
    :data:`K3_PARAM_BYTES` (151)."""
    return (K3_PARAM_BYTES - _K3_TABLE_HEADER) // _RECT_DTYPE.itemsize


# K3's chunk rule: blocks per SM it aims at (the kernel's resident blocks
# per SM, csrc: kK3MinBlocks; tuned on the card against 2 and 4), and its
# clamp.
K3_BLOCKS_PER_SM = 3
K3_CHUNK_MIN = 4096
K3_CHUNK_MAX = 65536


def k3_chunk_bytes(total: int, sms: int) -> int:
    """K3's bytes per block for a copy of ``total`` bytes on a card of
    ``sms`` SMs: ``K3_BLOCKS_PER_SM`` blocks per SM, 16-byte aligned,
    clamped to [``K3_CHUNK_MIN``, ``K3_CHUNK_MAX``] (csrc/tss_kernels.cu
    has why)."""
    per_block = -(-int(total) // (K3_BLOCKS_PER_SM * int(sms))) if total > 0 else 0
    return min(max(-(-per_block // 16) * 16, K3_CHUNK_MIN), K3_CHUNK_MAX)


def fast_divmod_params(d: int) -> Tuple[int, int]:
    """(mul, shift) with ``fast_div(n, mul, shift) == n // d`` for every
    32-bit ``n`` and ``1 <= d < 2**32`` (the round-up method of Granlund
    and Montgomery; csrc: fast_div)."""
    shift = (int(d) - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def fast_div(n: int, mul: int, shift: int) -> int:
    """The device's ``fast_div``: ``(umulhi(n, mul) + n) >> shift``, the sum
    in 64 bits."""
    return (((n * mul) >> 32) + n) >> shift


_SM_COUNTS: Dict[int, int] = {}


def _sm_count(index: int) -> int:
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def _non_overlapping(t: torch.Tensor) -> bool:
    """No two elements of ``t`` share memory (gaps allowed)."""
    extent = 1
    for s, n in sorted((s, n) for n, s in zip(t.shape, t.stride()) if n > 1):
        if s < extent:
            return False
        extent = s * n
    return True


def _collapse(shape, src_strides, dst_strides, itemsize: int) -> List[Tuple[int, int, int]]:
    """(size, src byte stride, dst byte stride) per dim, outermost first,
    without size-1 dims, with each dim merged into the next inner one where
    both sides are contiguous across the two."""
    merged: List[Tuple[int, int, int]] = []
    for n, ss, ds in zip(reversed(shape), reversed(src_strides), reversed(dst_strides)):
        if n == 1:
            continue
        ss *= itemsize
        ds *= itemsize
        if merged:
            mn, mss, mds = merged[-1]
            if ss == mn * mss and ds == mn * mds:
                merged[-1] = (mn * n, mss, mds)
                continue
        merged.append((int(n), int(ss), int(ds)))
    merged.reverse()
    return merged


def _grain(*values: int) -> int:
    acc = 0
    for v in values:
        acc |= int(v)
    for g in (16, 8, 4, 2):
        if acc % g == 0:
            return g
    return 1


def _pair_rects(src: torch.Tensor, dst: torch.Tensor, begin: int) -> Tuple[bytes, int, int]:
    """The descriptors of one non-empty pair from virtual offset ``begin``,
    as table bytes; returns them, the end of the last rectangle and the
    next free (aligned) offset."""
    itemsize = src.element_size()
    dims = _collapse(src.shape, src.stride(), dst.stride(), itemsize)
    if dims and dims[-1][1] == itemsize and dims[-1][2] == itemsize:
        row_bytes = dims.pop()[0] * itemsize
    else:
        row_bytes = itemsize
    extra = dims[:-K3_MAX_DIMS]
    dims = dims[-K3_MAX_DIMS:]
    dims.reverse()  # innermost first, as the kernel walks them
    s_ptr, d_ptr = src.data_ptr(), dst.data_ptr()
    rows, acc = 1, s_ptr | d_ptr | row_bytes
    sizes, s_strides, d_strides = [0] * K3_MAX_DIMS, [0] * K3_MAX_DIMS, [0] * K3_MAX_DIMS
    for k, (n, ss, ds) in enumerate(dims):
        rows *= n
        acc |= ss | ds
        sizes[k], s_strides[k], d_strides[k] = n, ss, ds
    for _, ss, ds in extra:
        acc |= ss | ds
    mul, shift = [0] * K3_MAX_DIMS, [0] * K3_MAX_DIMS
    if rows < 1 << 32:
        for k in range(len(dims) - 1):  # the outermost dim needs no division
            mul[k], shift[k] = fast_divmod_params(sizes[k])
    nbytes = rows * row_bytes
    step = -(-nbytes // _RECT_ALIGN) * _RECT_ALIGN
    one = _RECT_STRUCT.pack(
        s_ptr, d_ptr, begin, nbytes, row_bytes, rows, *sizes, *s_strides, *d_strides,
        *mul, *shift, len(dims), _grain(acc),
    )
    if not extra:
        return one, begin + nbytes, begin + step
    # One descriptor per index of the dims beyond five, outermost first.
    idx = np.indices([n for n, _, _ in extra], dtype=np.uint64).reshape(len(extra), -1)
    count = idx.shape[1]
    table = np.repeat(np.frombuffer(one, _RECT_DTYPE), count)
    table["src"] += (idx * np.array([ss for _, ss, _ in extra], np.uint64)[:, None]).sum(0)
    table["dst"] += (idx * np.array([ds for _, _, ds in extra], np.uint64)[:, None]).sum(0)
    table["begin"] += np.arange(count, dtype=np.uint64) * np.uint64(step)
    return table.tobytes(), begin + (count - 1) * step + nbytes, begin + count * step


def rect_table(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> Tuple[np.ndarray, int]:
    """K3's descriptor table for (source view, destination view) pairs of
    equal shape and dtype: one row per rectangle of a contiguous row and up
    to :data:`K3_MAX_DIMS` collapsed dims outside it (a pair that keeps more
    is cut on its outermost dims), begins 16-byte aligned in the virtual byte space.
    Returns the table and the end of its last rectangle."""
    parts: List[bytes] = []
    begin = end = 0
    for src, dst in pairs:
        if src.numel() == 0:
            continue
        part, end, begin = _pair_rects(src, dst, begin)
        parts.append(part)
    if not parts:
        return np.zeros(0, dtype=_RECT_DTYPE), 0
    return np.frombuffer(b"".join(parts), dtype=_RECT_DTYPE), end


def copy_blocks_plain(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """Plain PyTorch K3: ``dst.copy_(src)`` per pair."""
    for src, dst in pairs:
        dst.copy_(src)


def _check_pairs(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.device:
    for src, dst in pairs:
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(
                f"copy_blocks: source {src.dtype} {tuple(src.shape)} does not match "
                f"destination {dst.dtype} {tuple(dst.shape)}"
            )
        if not _non_overlapping(dst):
            raise ValueError("copy_blocks: a destination view overlaps itself")
    return _single_device([t for pair in pairs for t in pair])


class _PinnedTable:
    """A device's reusable pinned buffer for K3 tables too large to pass
    by value; ``copied`` marks the end of the last copy out of it."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.host: Optional[torch.Tensor] = None
        self.copied: Optional[torch.cuda.Event] = None


_PINNED_TABLES: Dict[int, _PinnedTable] = {}
_PINNED_TABLES_LOCK = threading.Lock()


def upload_rect_table(
    table: np.ndarray, device: torch.device, stream: Optional[torch.cuda.Stream] = None
) -> torch.Tensor:
    """Copy K3's table to ``device`` on ``stream`` (default: the current
    stream) through the device's reused pinned buffer, for a table that
    cannot go by value (:func:`launch_rects`). The buffer is rewritten only
    once the previous copy out of it has run."""
    stream = stream or torch.cuda.current_stream(device)
    data = np.ascontiguousarray(table).view(np.uint8)
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _PINNED_TABLES_LOCK:
        slot = _PINNED_TABLES.setdefault(index, _PinnedTable())
    with slot.lock:
        if slot.copied is not None:
            slot.copied.synchronize()
        if slot.host is None or slot.host.numel() < data.nbytes:
            slot.host = torch.empty(max(data.nbytes, 1 << 16), dtype=torch.uint8, pin_memory=True)
        slot.host.numpy()[: data.nbytes] = data
        with torch.cuda.stream(stream):
            out = torch.empty(data.nbytes, dtype=torch.uint8, device=device)
            out.copy_(slot.host[: data.nbytes], non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(stream)
    return out


# tss_copy_blocks launched nothing: the table must come from device memory
# (more descriptors than the library takes by value, or a rectangle of
# 2**32 rows or of 2**31 units a row or more, which the kernel that counts
# in 64 bits handles).
_K3_NEEDS_DEVICE_TABLE = -1


def launch_rects(table: np.ndarray, total: int, stream: torch.cuda.Stream) -> None:
    """One K3 launch over a built table on ``stream``: by value, or, where
    ``tss_copy_blocks`` refuses that, from a device copy of the table
    (:func:`upload_rect_table`). Not counted: the wrapper counts; this is
    also the timing entry point."""
    lib = load_library()
    data = table.tobytes()
    chunk = k3_chunk_bytes(total, _sm_count(stream.device_index))
    rc = lib.tss_copy_blocks(data, len(table), None, total, chunk, stream.cuda_stream)
    if rc == _K3_NEEDS_DEVICE_TABLE:
        device_table = upload_rect_table(table, stream.device, stream)
        rc = lib.tss_copy_blocks(data, len(table), device_table.data_ptr(), total, chunk, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"copy_blocks kernel launch failed: CUDA error {rc}")


def launch_empty(stream: torch.cuda.Stream) -> None:
    """One launch of an empty kernel on ``stream``: the floor under a
    kernel's time, for timing only."""
    rc = load_library().tss_empty(stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


def copy_blocks(
    pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    stream: Optional[torch.cuda.Stream] = None,
) -> None:
    """K3. Copies each source view into its destination view (equal shape
    and dtype, any strides, one device). CPU pairs take
    :func:`copy_blocks_plain`; CUDA pairs are copied by ONE
    ``tss_copy_blocks`` launch on ``stream`` (default: the current stream),
    its table passed by value, or uploaded first when it exceeds the
    library's inline capacity (or holds a rectangle of 2**32 rows or
    more). A destination that overlaps itself raises."""
    if not pairs:
        return
    device = _check_pairs(pairs)
    if device.type == "cpu":
        copy_blocks_plain(pairs)
        return
    if device.type != "cuda":
        raise ValueError(f"copy_blocks: unsupported device {device}")
    table, total = rect_table(pairs)
    if total == 0:
        return
    launch_rects(table, total, stream or torch.cuda.current_stream(device))
    _count("copy_blocks")


def gather(src: torch.Tensor, stream: Optional[torch.cuda.Stream] = None) -> torch.Tensor:
    """A C-contiguous copy of view ``src`` by :func:`copy_blocks`, allocated
    on ``stream``: how a strided CUDA view reaches its D2H copy."""
    stream = stream or (torch.cuda.current_stream(src.device) if src.is_cuda else None)
    if stream is None:
        out = torch.empty(src.shape, dtype=src.dtype, device=src.device)
    else:
        with torch.cuda.stream(stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=src.device)
    copy_blocks([(src, out)], stream)
    return out

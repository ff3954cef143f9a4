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
(``csrc/tss_kernels.cu`` has the design and the bound). A wrapper runs the
plain version only for tensors on the CPU. For CUDA tensors it launches
the kernel or raises; there is no fallback.

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
# K3's rectangle (csrc/tss_kernels.cu: TssRectDesc).
_RECT_DTYPE = np.dtype(
    [
        (name, "<u8")
        for name in (
            "src", "dst", "begin", "nbytes", "row_bytes", "rows",
            "src_pitch", "dst_pitch", "src_opitch", "dst_opitch", "grain",
        )
    ]
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
            for name in ("tss_pack_slab", "tss_fork_copy", "tss_copy_blocks"):
                fn = getattr(lib, name)
                fn.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_int,
                    ctypes.c_ulonglong,
                    ctypes.c_void_p,
                ]
                fn.restype = ctypes.c_int
            lib.tss_desc_size.argtypes = []
            lib.tss_desc_size.restype = ctypes.c_int
            lib.tss_rect_desc_size.argtypes = []
            lib.tss_rect_desc_size.restype = ctypes.c_int
            if (
                lib.tss_desc_size() != _DESC_DTYPE.itemsize
                or lib.tss_rect_desc_size() != _RECT_DTYPE.itemsize
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


def _non_overlapping(t: torch.Tensor) -> bool:
    """No two elements of ``t`` share memory (gaps allowed)."""
    dims = sorted(((n, s) for n, s in zip(t.shape, t.stride()) if n > 1), key=lambda d: d[1])
    extent = 1
    for n, s in dims:
        if s < extent:
            return False
        extent = s * n
    return True


def _collapse(shape, src_strides, dst_strides, itemsize: int) -> List[Tuple[int, int, int]]:
    """(size, src byte stride, dst byte stride) per dim, outermost first,
    without size-1 dims, with each dim merged into the next inner one where
    both sides are contiguous across the two."""
    dims: List[Tuple[int, int, int]] = []
    for n, ss, ds in zip(shape, src_strides, dst_strides):
        if n == 1:
            continue
        dims.append((int(n), int(ss) * itemsize, int(ds) * itemsize))
    merged: List[Tuple[int, int, int]] = []
    for n, ss, ds in reversed(dims):
        if merged:
            mn, mss, mds = merged[-1]
            if ss == mn * mss and ds == mn * mds:
                merged[-1] = (mn * n, mss, mds)
                continue
        merged.append((n, ss, ds))
    return merged[::-1]


def _grain(*values: int) -> int:
    acc = 0
    for v in values:
        acc |= int(v)
    for g in (16, 8, 4, 2):
        if acc % g == 0:
            return g
    return 1


def rect_table(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> Tuple[np.ndarray, int]:
    """K3's descriptor table for (source view, destination view) pairs of
    equal shape and dtype: one row per rectangle of at most three dims,
    begins 16-byte aligned in the virtual byte space. Returns the table and
    the end of its last rectangle."""
    rows: List[tuple] = []
    begin = 0
    for src, dst in pairs:
        if src.numel() == 0:
            continue
        itemsize = src.element_size()
        dims = _collapse(src.shape, src.stride(), dst.stride(), itemsize)
        if dims and dims[-1][1] == itemsize and dims[-1][2] == itemsize:
            row_bytes = dims[-1][0] * itemsize
            dims = dims[:-1]
        else:
            row_bytes = itemsize
        rows_n, sp, dp = dims[-1] if dims else (1, 0, 0)
        outer, sop, dop = dims[-2] if len(dims) >= 2 else (1, 0, 0)
        extra = dims[:-2]
        for idx in np.ndindex(*[n for n, _, _ in extra]):
            s_off = sum(i * ss for i, (_, ss, _) in zip(idx, extra))
            d_off = sum(i * ds for i, (_, _, ds) in zip(idx, extra))
            s_ptr = src.data_ptr() + s_off
            d_ptr = dst.data_ptr() + d_off
            nbytes = outer * rows_n * row_bytes
            grain = _grain(s_ptr, d_ptr, row_bytes, sp, dp, sop, dop)
            rows.append((s_ptr, d_ptr, begin, nbytes, row_bytes, rows_n, sp, dp, sop, dop, grain))
            begin += -(-nbytes // _RECT_ALIGN) * _RECT_ALIGN
    table = np.array(rows, dtype=_RECT_DTYPE)
    end = int(table["begin"][-1] + table["nbytes"][-1]) if len(rows) else 0
    return table, end


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


def upload_rect_table(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy K3's table to ``device`` on the current stream."""
    return torch.from_numpy(table.view(np.uint8)).pin_memory().to(device, non_blocking=True)


def copy_blocks(
    pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    stream: Optional[torch.cuda.Stream] = None,
) -> None:
    """K3. Copies each source view into its destination view (equal shape
    and dtype, any strides, one device). CPU pairs take
    :func:`copy_blocks_plain`; CUDA pairs are copied by ONE
    ``tss_copy_blocks`` launch on ``stream`` (default: the current stream).
    A destination that overlaps itself raises."""
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
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        dev_table = upload_rect_table(table, device)
        launch_raw("copy_blocks", dev_table, len(table), total, stream)
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

"""Dim-0 chunking of large tensors into several storage objects.

A tensor above ``MAX_CHUNK_SIZE_BYTES`` is written as ``<path>.chunk_<r0>``
objects, one per row block, so the transfer of one block overlaps the
write of another. The row math is the JAX package's (``chunk_row_ranges``),
so both packages name and cut the chunks identically. A numpy array whose
dtype has no raw form is cut the same way, one pickled object per chunk.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io_types import ReadReq, WriteReq
from ..manifest import ChunkedArrayEntry, Shard
from ..serialization import dtype_itemsize
from ..utils import knobs
from .array import ArrayIOPreparer, PickledRowsConsumer, chunk_row_ranges


def should_chunk(tensor: torch.Tensor) -> bool:
    nbytes = tensor.numel() * tensor.element_size() if tensor.dim() else 0
    return (
        tensor.dim() >= 1
        and tensor.shape[0] > 1
        and nbytes > knobs.get_max_chunk_size_bytes()
    )


def should_chunk_pickled(arr: np.ndarray) -> bool:
    """:func:`should_chunk` for a pickled numpy array, by its own itemsize
    (12 for ``<U3``), as the reference decides."""
    return arr.ndim >= 1 and arr.shape[0] > 1 and arr.nbytes > knobs.get_max_chunk_size_bytes()


def _pickled_ranges(arr: np.ndarray) -> List[Tuple[int, int]]:
    return chunk_row_ranges(list(arr.shape), arr.dtype.itemsize, knobs.get_max_chunk_size_bytes())


def pickled_array_pieces(arr: np.ndarray) -> List[np.ndarray]:
    """The arrays a pickled array is written as, in order: itself, or its
    dim-0 chunks above ``MAX_CHUNK_SIZE_BYTES``."""
    if not should_chunk_pickled(arr):
        return [arr]
    return [arr[r0:r1] for r0, r1 in _pickled_ranges(arr)]


class ChunkedArrayIOPreparer:
    @staticmethod
    def prepare_write(
        storage_path: str,
        tensor: torch.Tensor,
        replicated: bool = False,
        is_async_snapshot: bool = False,
        ready: Optional[Any] = None,
        dtype_str: Optional[str] = None,
    ) -> Tuple[ChunkedArrayEntry, List[WriteReq]]:
        shape = list(tensor.shape)
        ranges = chunk_row_ranges(
            shape, tensor.element_size(), knobs.get_max_chunk_size_bytes()
        )
        chunks: List[Shard] = []
        write_reqs: List[WriteReq] = []
        for r0, r1 in ranges:
            sub_entry, sub_reqs = ArrayIOPreparer.prepare_write(
                f"{storage_path}.chunk_{r0}",
                tensor[r0:r1],
                replicated,
                is_async_snapshot,
                ready,
                dtype_str,
            )
            chunks.append(
                Shard(
                    offsets=[r0] + [0] * (len(shape) - 1),
                    sizes=[r1 - r0] + shape[1:],
                    tensor=sub_entry,
                )
            )
            write_reqs.extend(sub_reqs)
        entry = ChunkedArrayEntry(
            dtype=chunks[0].tensor.dtype,
            shape=shape,
            chunks=chunks,
            replicated=replicated,
        )
        return entry, write_reqs

    @staticmethod
    def prepare_pickled_write(
        storage_path: str, arr: np.ndarray, replicated: bool = False
    ) -> Tuple[ChunkedArrayEntry, List[WriteReq]]:
        """A pickled array above the chunk size: one pickled object per
        dim-0 chunk, as the reference writes it."""
        chunks: List[Shard] = []
        write_reqs: List[WriteReq] = []
        for r0, r1 in _pickled_ranges(arr):
            sub_entry, sub_reqs = ArrayIOPreparer.prepare_pickled_write(
                f"{storage_path}.chunk_{r0}", arr[r0:r1], replicated
            )
            offsets = [r0] + [0] * (arr.ndim - 1)
            chunks.append(Shard(offsets=offsets, sizes=[r1 - r0] + list(arr.shape[1:]), tensor=sub_entry))
            write_reqs.extend(sub_reqs)
        entry = ChunkedArrayEntry(
            dtype=chunks[0].tensor.dtype, shape=list(arr.shape), chunks=chunks, replicated=replicated
        )
        return entry, write_reqs

    @staticmethod
    def prepare_pickled_read(entry: ChunkedArrayEntry, target: np.ndarray) -> List[ReadReq]:
        """Reads filling ``target`` (an array of the entry's dtype and
        shape) from the entry's pickled chunks, each into its rows."""
        reqs: List[ReadReq] = []
        for chunk in entry.chunks:
            r0 = chunk.offsets[0]
            reqs.append(
                ReadReq(
                    path=chunk.tensor.location,
                    buffer_consumer=PickledRowsConsumer(target[r0 : r0 + chunk.sizes[0]]),
                    byte_range=tuple(chunk.tensor.byte_range) if chunk.tensor.byte_range else None,
                )
            )
        return reqs

    @staticmethod
    def prepare_read(  # spmd-pure
        entry: ChunkedArrayEntry,
        target: np.ndarray,
        buffer_size_limit_bytes: Optional[int] = None,
        frame_tables: Optional[Dict[str, Any]] = None,
    ) -> List[ReadReq]:
        """Reads filling the flat uint8 view ``target`` chunk by chunk
        (``frame_tables``: the chunks' ``.ftab`` tables by location)."""
        row_bytes = dtype_itemsize(entry.dtype) * int(np.prod(entry.shape[1:]))
        reqs: List[ReadReq] = []
        for chunk in entry.chunks:
            offset = chunk.offsets[0] * row_bytes
            reqs.extend(
                ArrayIOPreparer.prepare_read(
                    chunk.tensor,
                    target,
                    offset,
                    buffer_size_limit_bytes,
                    (frame_tables or {}).get(chunk.tensor.location),
                )
            )
        return reqs

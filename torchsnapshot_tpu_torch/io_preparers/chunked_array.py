"""Dim-0 chunking of large tensors into several storage objects.

A tensor above ``MAX_CHUNK_SIZE_BYTES`` is written as ``<path>.chunk_<r0>``
objects, one per row block, so the transfer of one block overlaps the
write of another. The row math is the JAX package's (``chunk_row_ranges``),
so both packages name and cut the chunks identically.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..io_types import ReadReq, WriteReq
from ..manifest import ChunkedArrayEntry, Shard
from ..serialization import dtype_itemsize
from ..utils import knobs
from .array import ArrayIOPreparer, chunk_row_ranges


def should_chunk(tensor: torch.Tensor) -> bool:
    nbytes = tensor.numel() * tensor.element_size() if tensor.dim() else 0
    return (
        tensor.dim() >= 1
        and tensor.shape[0] > 1
        and nbytes > knobs.get_max_chunk_size_bytes()
    )


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
    def prepare_read(
        entry: ChunkedArrayEntry,
        target: np.ndarray,
        buffer_size_limit_bytes: Optional[int] = None,
    ) -> List[ReadReq]:
        """Reads filling the flat uint8 view ``target`` chunk by chunk."""
        row_bytes = dtype_itemsize(entry.dtype) * int(np.prod(entry.shape[1:]))
        reqs: List[ReadReq] = []
        for chunk in entry.chunks:
            offset = chunk.offsets[0] * row_bytes
            reqs.extend(
                ArrayIOPreparer.prepare_read(
                    chunk.tensor, target, offset, buffer_size_limit_bytes
                )
            )
        return reqs

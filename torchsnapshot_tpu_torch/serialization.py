"""Dtype table and raw-byte views for torch tensors.

The on-disk format is the JAX package's: one ``raw`` serializer whose
payload is the array's little-endian C-order bytes, and ``pickle`` for
everything else. Dtype strings are exactly the reference's
(``torchsnapshot_tpu/serialization.py:202-241``), mapped here to
``torch.dtype``.

Dtypes the reference table holds and torch does not:

- ``float8_e4m3b11fnuz``, ``float8_e3m4``, ``float8_e4m3``: torch has no
  such dtype;
- ``int4``, ``uint4``, ``float4_e2m1fn``: ml_dtypes stores them one value
  per byte, whereas torch's sub-byte dtypes pack two values per byte.

An entry of one of these restores as a ``uint8`` tensor of the same shape
holding the stored bytes (one byte per element), never reinterpreted as a
torch dtype. Torch's own sub-byte dtypes (``int4``, ``uint4``,
``float4_e2m1fn_x2``, …) have no counterpart in the format and are refused
on write.

The compressed serializers (``raw_zstd``, ``raw_zlib``) are not handled by
this package yet: a compressed entry is refused on restore with a clear
error.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


class Serializer:
    RAW = "raw"
    RAW_ZSTD = "raw_zstd"
    RAW_ZLIB = "raw_zlib"
    PICKLE = "pickle"


_TORCH_DTYPES: Dict[str, torch.dtype] = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "float8_e4m3fnuz": torch.float8_e4m3fnuz,
    "float8_e5m2fnuz": torch.float8_e5m2fnuz,
    "float8_e8m0fnu": torch.float8_e8m0fnu,
}

# Reference dtype strings with no torch dtype; each is one byte per element
# on disk and restores as uint8.
BYTE_VIEW_DTYPES = frozenset(
    {
        "float8_e4m3b11fnuz",
        "float8_e3m4",
        "float8_e4m3",
        "int4",
        "uint4",
        "float4_e2m1fn",
    }
)

_STRING_OF = {v: k for k, v in _TORCH_DTYPES.items()}

# Plain numpy dtypes (numpy leaves of a state are staged like tensors).
_NUMPY_DTYPES = {
    k: np.dtype(k)
    for k in (
        "bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16",
        "int32", "int64", "float16", "float32", "float64", "complex64",
        "complex128",
    )
}
_NUMPY_STRING_OF = {v: k for k, v in _NUMPY_DTYPES.items()}


def ensure_uncompressed(serializer: str, where: str) -> None:
    if serializer in (Serializer.RAW_ZSTD, Serializer.RAW_ZLIB):
        raise NotImplementedError(
            f"{where}: entry is compressed ({serializer}); this package "
            "reads uncompressed snapshots only"
        )


def dtype_to_string(dtype: torch.dtype) -> str:
    try:
        return _STRING_OF[dtype]
    except KeyError:
        raise TypeError(
            f"Unsupported dtype for raw serialization: {dtype} (torch's "
            "sub-byte dtypes pack two values per byte and have no "
            "counterpart in the snapshot format)"
        ) from None


def numpy_dtype_to_string(dtype) -> Optional[str]:
    """The reference string of a plain numpy dtype, None if it has none."""
    return _NUMPY_STRING_OF.get(np.dtype(dtype))


def string_to_dtype(s: str) -> torch.dtype:
    """The torch dtype a restored entry gets: the table's, or uint8 for the
    reference dtypes torch lacks."""
    if s in _TORCH_DTYPES:
        return _TORCH_DTYPES[s]
    if s in BYTE_VIEW_DTYPES:
        return torch.uint8
    raise ValueError(f"Unknown dtype string: {s}")


def dtype_itemsize(s: str) -> int:
    return string_to_dtype(s).itemsize


def array_nbytes(shape: Sequence[int], dtype_str: str) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype_itemsize(dtype_str)


def tensor_as_bytes(t: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a CPU tensor's C-order bytes. Copies only when
    ``t`` is not C-contiguous. ``reshape(-1)`` first, because ``view(uint8)``
    refuses 0-dim tensors of wider items."""
    if t.device.type != "cpu":
        raise ValueError("tensor_as_bytes takes a CPU tensor")
    return t.detach().contiguous().reshape(-1).view(torch.uint8)

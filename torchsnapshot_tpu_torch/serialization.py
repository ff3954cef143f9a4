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

``raw_zstd`` and ``raw_zlib`` are the raw byte stream compressed, the
JAX package's codecs byte for byte (``torchsnapshot_tpu/serialization.py``,
the same libraries and levels). A payload above the frame size is framed:
independent frames of ``frame_bytes`` raw bytes each, concatenated, with
their compressed sizes in a ``.ftab`` side object, so a budgeted sub-read
fetches and decodes only the frames it covers. A compressed slab has one
frame per member. zstd needs the ``zstandard`` package; zlib is in the
standard library.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

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


# Serializers whose decoded payload is the raw little-endian byte stream.
RAW_FAMILY = (Serializer.RAW, Serializer.RAW_ZSTD, Serializer.RAW_ZLIB)
COMPRESSED = (Serializer.RAW_ZSTD, Serializer.RAW_ZLIB)


def is_raw_family(serializer: str) -> bool:
    return serializer in RAW_FAMILY


def raw_serializer_for_codec(codec: str) -> str:
    """The serializer of codec ``none``, ``zstd`` or ``zlib``."""
    return {"zstd": Serializer.RAW_ZSTD, "zlib": Serializer.RAW_ZLIB}.get(codec, Serializer.RAW)


def codec_for_raw_serializer(serializer: str) -> str:
    return {Serializer.RAW_ZSTD: "zstd", Serializer.RAW_ZLIB: "zlib"}.get(serializer, "none")


def ensure_codec_available(serializer: str) -> None:
    """Raise at read planning when an entry needs a codec this host lacks,
    rather than mid-pipeline in a consumer thread."""
    if serializer == Serializer.RAW_ZSTD:
        try:
            import zstandard  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "this snapshot's entries are zstd-compressed; restoring "
                "requires the 'zstandard' package"
            ) from e


def compress_payload(view, serializer: str, level: int):
    """Compress a raw byte view per ``serializer`` (RAW passes through)."""
    if serializer == Serializer.RAW_ZSTD:
        import zstandard

        return zstandard.ZstdCompressor(level=level).compress(view)
    if serializer == Serializer.RAW_ZLIB:
        return zlib.compress(view, level)
    return view


def decode_raw_payload(buf, serializer: str):
    """Undo :func:`compress_payload`: the raw little-endian bytes."""
    if serializer == Serializer.RAW_ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(memoryview(buf))
    if serializer == Serializer.RAW_ZLIB:
        return zlib.decompress(memoryview(buf))
    return buf


def compress_framed(view, serializer: str, level: int, frame_bytes: int) -> Tuple[bytes, List[int]]:
    """Compress ``view`` as independent frames of ``frame_bytes`` raw bytes
    each (the last one short). Returns ``(payload, frame_sizes)``: frames
    [i, j) are bytes ``[prefix[i], prefix[j])`` of the payload."""
    n = memoryview(view).nbytes
    full, tail = divmod(n, frame_bytes)
    member_sizes = [frame_bytes] * full + ([tail] if tail else [])
    if not member_sizes:
        return b"", []
    return compress_member_framed(view, member_sizes, serializer, level)


def compress_member_framed(view, member_sizes, serializer: str, level: int) -> Tuple[bytes, List[int]]:
    """Compress ``view`` with one independent frame per member (member i
    covers ``member_sizes[i]`` raw bytes), so a member's read decodes its
    own frame only. Returns ``(payload, frame_sizes)``."""
    mv = memoryview(view).cast("B")
    parts = []
    sizes = []
    begin = 0
    for n in member_sizes:
        frame = compress_payload(mv[begin : begin + n], serializer, level)
        parts.append(frame)
        sizes.append(len(frame))
        begin += n
    if begin != mv.nbytes:
        raise ValueError(f"member sizes cover {begin} of {mv.nbytes} bytes")
    return b"".join(parts), sizes


def decode_framed_payload(buf, serializer: str):
    """Decode a concatenation of frames (zstd and zlib streams end
    themselves, so no frame table is needed)."""
    if serializer == Serializer.RAW_ZSTD:
        import zstandard

        reader = zstandard.ZstdDecompressor().stream_reader(memoryview(buf), read_across_frames=True)
        return reader.read()
    if serializer == Serializer.RAW_ZLIB:
        out = []
        rest = memoryview(buf)
        while rest.nbytes:
            d = zlib.decompressobj()
            out.append(d.decompress(rest))
            rest = memoryview(d.unused_data)
        return b"".join(out)
    return buf


def codec_library_versions() -> Dict[str, str]:
    """Versions of the codec libraries, recorded in a compressed snapshot's
    metadata: compressed bytes (and so incremental dedup) are stable only
    within one library version."""
    versions = {"zlib": zlib.ZLIB_RUNTIME_VERSION}
    try:
        import zstandard

        versions["zstd"] = zstandard.__version__
    except ImportError:
        pass
    return versions


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

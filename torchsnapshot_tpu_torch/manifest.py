"""Snapshot manifest: the entry taxonomy and the committed metadata document.

A copy of ``torchsnapshot_tpu/manifest.py`` (the format is shared byte for
byte). Entries describe layout on storage: :class:`ArrayEntry` (one
object, or a ``byte_range`` of a slab), :class:`ChunkedArrayEntry` (dim-0
chunks of one logical array) and :class:`ShardedArrayEntry` (shards with
global offsets and sizes; read by this package only once sharded state is
ported). Metadata is committed as JSON under ``.snapshot_metadata``.

Manifest keys are ``"<rank>/<logical_path>"``; :func:`get_manifest_for_rank`
re-projects the global manifest into one rank's view.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from .serialization import Serializer  # noqa: F401  (re-exported for callers)


@dataclass
class Entry:
    type: str


@dataclass
class PrimitiveEntry(Entry):
    """A small scalar stored inline in the manifest (no storage object)."""

    value_type: str  # int | float | str | bool | bytes | complex | none
    readable: str  # stringified value
    replicated: bool = False

    def __init__(self, value_type: str, readable: str, replicated: bool = False):
        super().__init__(type="primitive")
        self.value_type = value_type
        self.readable = readable
        self.replicated = replicated

    @classmethod
    def from_value(cls, value: Any, replicated: bool = False) -> "PrimitiveEntry":
        if value is None:
            return cls("none", "", replicated)
        t = type(value).__name__
        if t not in _PRIMITIVE_ENCODERS:
            raise TypeError(f"Not a supported primitive: {type(value)}")
        return cls(t, _PRIMITIVE_ENCODERS[t](value), replicated)

    def get_value(self) -> Any:
        return _PRIMITIVE_DECODERS[self.value_type](self.readable)


_PRIMITIVE_ENCODERS = {
    "int": repr,
    "float": lambda v: v.hex(),  # exact round-trip
    "bool": repr,
    "str": str,
    "bytes": lambda v: v.hex(),
    "complex": repr,
}
_PRIMITIVE_DECODERS = {
    "int": int,
    "float": float.fromhex,
    "bool": lambda s: s == "True",
    "str": str,
    "bytes": bytes.fromhex,
    "complex": complex,
    "none": lambda s: None,
}

PRIMITIVE_TYPES = (int, float, bool, str, bytes, complex, type(None))


@dataclass
class ArrayEntry(Entry):
    """One array stored as one storage object, or a ``byte_range`` of a slab."""

    location: str
    serializer: str
    dtype: str
    shape: List[int]
    replicated: bool = False
    byte_range: Optional[List[int]] = None  # [begin, end) within `location`
    # Compressed entries only: raw bytes covered per independent compression
    # frame. A framed payload is a concatenation of frames, each compressing
    # `frame_bytes` of the raw stream (last one short), with the compressed
    # frame sizes in a tiny `<location>.ftab` side object — that makes big
    # compressed arrays byte-range addressable (budgeted sub-reads decompress
    # only the covering frames). None = single-blob payload.
    frame_bytes: Optional[int] = None
    # Member-framed compressed SLAB members only: this entry's raw byte range
    # within the slab's packed (uncompressed) layout. The slab object is a
    # concatenation of compression frames whose boundaries coincide with
    # member boundaries; the `<location>.ftab` side object records both the
    # per-frame raw and compressed sizes, so a member read fetches + decodes
    # exactly its own frames. Mutually exclusive with byte_range (which is
    # FILE space) — compressed member sizes aren't known at planning time,
    # so the manifest can only speak in raw coordinates.
    raw_range: Optional[List[int]] = None

    def __init__(
        self,
        location: str,
        serializer: str,
        dtype: str,
        shape: List[int],
        replicated: bool = False,
        byte_range: Optional[List[int]] = None,
        frame_bytes: Optional[int] = None,
        raw_range: Optional[List[int]] = None,
    ):
        super().__init__(type="array")
        self.location = location
        self.serializer = serializer
        self.dtype = dtype
        self.shape = [int(s) for s in shape]
        self.replicated = replicated
        self.byte_range = list(byte_range) if byte_range is not None else None
        self.frame_bytes = int(frame_bytes) if frame_bytes else None
        self.raw_range = list(raw_range) if raw_range is not None else None


@dataclass
class Shard:
    """One saved piece of a logical array, positioned by global offsets."""

    offsets: List[int]
    sizes: List[int]
    tensor: ArrayEntry

    def __init__(self, offsets, sizes, tensor: ArrayEntry):
        self.offsets = [int(o) for o in offsets]
        self.sizes = [int(s) for s in sizes]
        self.tensor = tensor


@dataclass
class ShardedArrayEntry(Entry):
    """A sharded array: shards carry global (offsets, sizes).

    The entry also records the global dtype/shape so restore can allocate
    targets without reading any shard.
    """

    dtype: str
    shape: List[int]
    shards: List[Shard]

    def __init__(self, dtype: str, shape, shards: List[Shard]):
        super().__init__(type="sharded_array")
        self.dtype = dtype
        self.shape = [int(s) for s in shape]
        self.shards = shards


@dataclass
class ChunkedArrayEntry(Entry):
    """One logical array split into dim-0 chunks for pipelining."""

    dtype: str
    shape: List[int]
    chunks: List[Shard]
    replicated: bool = False

    def __init__(self, dtype: str, shape, chunks: List[Shard], replicated: bool = False):
        super().__init__(type="chunked_array")
        self.dtype = dtype
        self.shape = [int(s) for s in shape]
        self.chunks = chunks
        self.replicated = replicated


@dataclass
class ObjectEntry(Entry):
    """An arbitrary pickled Python object."""

    location: str
    serializer: str = Serializer.PICKLE
    obj_type: str = ""
    replicated: bool = False

    def __init__(
        self,
        location: str,
        serializer: str = Serializer.PICKLE,
        obj_type: str = "",
        replicated: bool = False,
    ):
        super().__init__(type="object")
        self.location = location
        self.serializer = serializer
        self.obj_type = obj_type
        self.replicated = replicated


@dataclass
class ListEntry(Entry):
    def __init__(self):
        super().__init__(type="list")


@dataclass
class DictEntry(Entry):
    keys: List[Union[str, int]]

    def __init__(self, keys: List[Union[str, int]]):
        super().__init__(type="dict")
        self.keys = list(keys)


@dataclass
class OrderedDictEntry(DictEntry):
    def __init__(self, keys: List[Union[str, int]]):
        Entry.__init__(self, type="ordered_dict")
        self.keys = list(keys)


CONTAINER_TYPES = ("list", "dict", "ordered_dict")

Manifest = Dict[str, Entry]


def is_container_entry(entry: Entry) -> bool:
    return entry.type in CONTAINER_TYPES

def is_replicated(entry: Entry) -> bool:
    return bool(getattr(entry, "replicated", False))


# --------------------------------------------------------------------------
# (de)serialization of entries to plain JSON-able dicts
# --------------------------------------------------------------------------

def entry_to_dict(entry: Entry) -> Dict[str, Any]:
    d: Dict[str, Any] = {"type": entry.type}
    if isinstance(entry, PrimitiveEntry):
        d.update(
            value_type=entry.value_type,
            readable=entry.readable,
            replicated=entry.replicated,
        )
    elif isinstance(entry, ArrayEntry):
        d.update(
            location=entry.location,
            serializer=entry.serializer,
            dtype=entry.dtype,
            shape=entry.shape,
            replicated=entry.replicated,
        )
        if entry.byte_range is not None:
            d["byte_range"] = entry.byte_range
        if entry.frame_bytes is not None:
            d["frame_bytes"] = entry.frame_bytes
        if entry.raw_range is not None:
            d["raw_range"] = entry.raw_range
    elif isinstance(entry, ShardedArrayEntry):
        d.update(
            dtype=entry.dtype,
            shape=entry.shape,
            shards=[_shard_to_dict(s) for s in entry.shards],
        )
    elif isinstance(entry, ChunkedArrayEntry):
        d.update(
            dtype=entry.dtype,
            shape=entry.shape,
            chunks=[_shard_to_dict(s) for s in entry.chunks],
            replicated=entry.replicated,
        )
    elif isinstance(entry, ObjectEntry):
        d.update(
            location=entry.location,
            serializer=entry.serializer,
            obj_type=entry.obj_type,
            replicated=entry.replicated,
        )
    elif isinstance(entry, OrderedDictEntry):
        d["keys"] = entry.keys
    elif isinstance(entry, DictEntry):
        d["keys"] = entry.keys
    elif isinstance(entry, ListEntry):
        pass
    else:
        raise TypeError(f"Unknown entry type: {entry}")
    return d


def _shard_to_dict(s: Shard) -> Dict[str, Any]:
    return {
        "offsets": s.offsets,
        "sizes": s.sizes,
        "tensor": entry_to_dict(s.tensor),
    }


def _shard_from_dict(d: Dict[str, Any]) -> Shard:
    return Shard(d["offsets"], d["sizes"], entry_from_dict(d["tensor"]))


def entry_from_dict(d: Dict[str, Any]) -> Entry:
    t = d["type"]
    if t == "primitive":
        return PrimitiveEntry(d["value_type"], d["readable"], d.get("replicated", False))
    if t == "array":
        return ArrayEntry(
            d["location"],
            d["serializer"],
            d["dtype"],
            d["shape"],
            d.get("replicated", False),
            d.get("byte_range"),
            d.get("frame_bytes"),
            d.get("raw_range"),
        )
    if t == "sharded_array":
        return ShardedArrayEntry(
            d["dtype"], d["shape"], [_shard_from_dict(s) for s in d["shards"]]
        )
    if t == "chunked_array":
        return ChunkedArrayEntry(
            d["dtype"],
            d["shape"],
            [_shard_from_dict(s) for s in d["chunks"]],
            d.get("replicated", False),
        )
    if t == "object":
        return ObjectEntry(
            d["location"],
            d.get("serializer", Serializer.PICKLE),
            d.get("obj_type", ""),
            d.get("replicated", False),
        )
    if t == "list":
        return ListEntry()
    if t == "dict":
        return DictEntry(d["keys"])
    if t == "ordered_dict":
        return OrderedDictEntry(d["keys"])
    raise ValueError(f"Unknown entry type: {t}")


# --------------------------------------------------------------------------
# SnapshotMetadata — the committed ".snapshot_metadata" document
# --------------------------------------------------------------------------

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"


@dataclass
class SnapshotMetadata:
    version: str
    world_size: int
    manifest: Manifest = field(default_factory=dict)
    # Codec library versions in effect at take time (e.g. {"zstd": "0.25.0"})
    # — recorded when compression was on so an incremental take can warn when
    # its codec version differs from the base's: compressed bitstreams are
    # only deterministic at a fixed library version, and a silent mismatch
    # degrades dedup to full rewrites with no signal.
    codec_versions: Optional[Dict[str, str]] = None

    def to_json(self) -> str:
        d: Dict[str, Any] = {
            "version": self.version,
            "world_size": self.world_size,
            "manifest": {k: entry_to_dict(v) for k, v in self.manifest.items()},
        }
        if self.codec_versions:
            d["codec_versions"] = self.codec_versions
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "SnapshotMetadata":
        d = json.loads(s)
        return cls(
            version=d["version"],
            world_size=int(d["world_size"]),
            manifest={k: entry_from_dict(v) for k, v in d["manifest"].items()},
            codec_versions=d.get("codec_versions"),
        )


# --------------------------------------------------------------------------
# Per-rank manifest projection (the elasticity engine's front half)
# --------------------------------------------------------------------------

def _split_rank_path(key: str) -> Tuple[int, str]:
    rank_str, _, path = key.partition("/")
    return int(rank_str), path


def get_manifest_for_rank(metadata: SnapshotMetadata, rank: int) -> Manifest:
    """Project the global ``rank/path -> entry`` manifest into ``rank``'s view.

    - per-rank entries of ``rank`` are kept (possible only if
      ``rank < saved world_size``);
    - replicated entries saved by any rank are made available;
    - sharded entries have their shard lists merged across all ranks;
    - parent container entries are reconstructed so :func:`inflate` works even
      for paths the local rank never saved (e.g. a newly joined rank).
    """
    local: Manifest = {}
    sharded: Dict[str, ShardedArrayEntry] = {}
    for key, entry in metadata.manifest.items():
        r, path = _split_rank_path(key)
        if isinstance(entry, ShardedArrayEntry):
            if path not in sharded:
                sharded[path] = ShardedArrayEntry(entry.dtype, entry.shape, [])
            sharded[path].shards.extend(entry.shards)
            continue
        if r == rank:
            local[path] = entry
        elif is_replicated(entry) and path not in local:
            local[path] = entry
        elif is_container_entry(entry):
            # Containers that lead to replicated/sharded values must exist on
            # every rank; merge keys if both sides have a dict at this path.
            existing = local.get(path)
            if existing is None:
                local[path] = entry
            elif isinstance(existing, DictEntry) and isinstance(entry, DictEntry):
                for k in entry.keys:
                    if k not in existing.keys:
                        existing.keys.append(k)
    # Rank's own entries override the merged-container placeholders.
    for key, entry in metadata.manifest.items():
        r, path = _split_rank_path(key)
        if r == rank and not isinstance(entry, ShardedArrayEntry):
            local[path] = entry
    local.update(sharded)
    _reconstruct_parent_containers(local)
    return local


def _reconstruct_parent_containers(manifest: Manifest) -> None:
    for path in list(manifest.keys()):
        parts = path.split("/")
        for i in range(1, len(parts)):
            parent = "/".join(parts[:i])
            # Inverse of flatten.encode_component (kept inline to avoid a
            # circular import); int-typed dict keys degrade to str here, which
            # only matters on the rare no-container-entry fallback path.
            child_key: Union[str, int] = parts[i].replace("%2F", "/").replace("%25", "%")
            parent_entry = manifest.get(parent)
            if parent_entry is None:
                manifest[parent] = DictEntry(keys=[child_key])
            elif isinstance(parent_entry, DictEntry):
                if child_key not in parent_entry.keys:
                    # list indices were stringified on flatten; keep as-is
                    parent_entry.keys.append(child_key)
            # ListEntry needs no key bookkeeping

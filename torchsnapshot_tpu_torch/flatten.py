"""Reversible flattening of nested state into flat logical paths.

A copy of ``torchsnapshot_tpu/flatten.py``: the logical paths are part of
the on-disk format. State dicts are nested ``dict``/``OrderedDict``/``list``
containers whose leaves are tensors, primitives, or arbitrary objects; each
leaf maps to a ``/``-separated logical path, and container entries in the
manifest let :func:`inflate` rebuild the exact structure.

Key components escape ``%`` -> ``%25`` and ``/`` -> ``%2F``. Dicts whose
keys are not all ``str``/``int``, collide after stringification, or hold an
empty, ``.`` or ``..`` key are kept as opaque leaves (pickled whole).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Tuple, Union

from .manifest import (
    DictEntry,
    ListEntry,
    Manifest,
    OrderedDictEntry,
)


def encode_component(key: Union[str, int]) -> str:
    s = str(key)
    return s.replace("%", "%25").replace("/", "%2F")


def _dict_is_flattenable(d: Dict[Any, Any]) -> bool:
    seen = set()
    for k in d.keys():
        if not isinstance(k, (str, int)) or isinstance(k, bool):
            return False
        s = str(k)
        if not s or s in (".", ".."):
            # An empty key leaves an empty logical-path segment (a storage
            # path ending in "/"); "." and ".." collapse filesystem paths
            # (e.g. "a/../b" escaping the entry's directory). Keep such
            # dicts opaque.
            return False
        if s in seen:
            return False  # e.g. 1 vs "1" collide after stringification
        seen.add(s)
    return True


def flatten(obj: Any, prefix: str = "") -> Tuple[Manifest, Dict[str, Any]]:
    """Flatten ``obj`` into (container manifest, {logical_path: leaf})."""
    manifest: Manifest = {}
    flattened: Dict[str, Any] = {}
    _flatten_inner(obj, manifest, flattened, prefix)
    return manifest, flattened


def _join(prefix: str, component: str) -> str:
    return f"{prefix}/{component}" if prefix else component


def _flatten_inner(
    obj: Any, manifest: Manifest, flattened: Dict[str, Any], prefix: str
) -> None:
    if isinstance(obj, OrderedDict) and _dict_is_flattenable(obj):
        manifest[prefix] = OrderedDictEntry(keys=list(obj.keys()))
        for k, v in obj.items():
            _flatten_inner(v, manifest, flattened, _join(prefix, encode_component(k)))
    elif isinstance(obj, dict) and _dict_is_flattenable(obj):
        manifest[prefix] = DictEntry(keys=list(obj.keys()))
        for k, v in obj.items():
            _flatten_inner(v, manifest, flattened, _join(prefix, encode_component(k)))
    elif isinstance(obj, list):
        manifest[prefix] = ListEntry()
        for i, v in enumerate(obj):
            _flatten_inner(v, manifest, flattened, _join(prefix, str(i)))
    else:
        flattened[prefix] = obj


def inflate(
    manifest: Manifest, flattened: Dict[str, Any], prefix: str = ""
) -> Any:
    """Rebuild the nested object flattened under ``prefix``.

    ``manifest`` holds the container entries; ``flattened`` maps logical paths
    to restored leaf values.
    """
    # Index children of each container path for single-pass reconstruction.
    container_paths = {
        p: e for p, e in manifest.items() if e.type in ("list", "dict", "ordered_dict")
    }

    def build(path: str) -> Any:
        entry = container_paths.get(path)
        if entry is None:
            return flattened[path]
        if isinstance(entry, ListEntry):
            items: List[Any] = []
            i = 0
            while True:
                child = _join(path, str(i))
                if child in container_paths or child in flattened:
                    items.append(build(child))
                    i += 1
                else:
                    break
            return items
        if isinstance(entry, (DictEntry, OrderedDictEntry)):
            out: Dict[Any, Any] = (
                OrderedDict() if isinstance(entry, OrderedDictEntry) else {}
            )
            for k in entry.keys:
                child = _join(path, encode_component(k))
                if child in container_paths or child in flattened:
                    out[k] = build(child)
            return out
        raise TypeError(f"Unexpected container entry {entry}")

    return build(prefix)

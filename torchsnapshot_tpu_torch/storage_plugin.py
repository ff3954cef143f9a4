"""URL -> storage plugin.

``fs://<path>`` (or a plain path) is the local filesystem, ``memory://<name>``
an in-process store shared by name; the cloud plugins of the JAX package
come later. With ``TSS_TORCH_READ_CACHE_DIR`` set, every plugin is wrapped
in the read-through cache (``storage_plugins/cache.py``).
"""

from __future__ import annotations

from .io_types import StoragePlugin
from .utils import knobs


def url_to_storage_plugin(url: str) -> StoragePlugin:
    plugin = _resolve_storage_plugin(url)
    if knobs.get_read_cache_dir():
        from .storage_plugins.cache import maybe_wrap_with_read_cache

        plugin = maybe_wrap_with_read_cache(plugin, origin_id=url)
    return plugin


def _resolve_storage_plugin(url: str) -> StoragePlugin:
    if "://" in url:
        protocol, path = url.split("://", 1)
        if not protocol:
            raise RuntimeError(f"malformed URL: {url}")
    else:
        protocol, path = "fs", url
    if protocol == "fs":
        from .storage_plugins.fs import FSStoragePlugin

        return FSStoragePlugin(root=path)
    if protocol == "memory":
        from .storage_plugins.memory import SHARED_ROOTS, MemoryStoragePlugin

        return SHARED_ROOTS.setdefault(path, MemoryStoragePlugin(root=path))
    raise NotImplementedError(
        f"storage protocol {protocol!r} is not supported by this package yet"
    )

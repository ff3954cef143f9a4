"""URL -> storage plugin.

Only the local filesystem is ported (a plain path or ``fs://<path>``);
the cloud plugins of the JAX package come later.
"""

from __future__ import annotations

from .io_types import StoragePlugin


def url_to_storage_plugin(url: str) -> StoragePlugin:
    if "://" in url:
        protocol, path = url.split("://", 1)
    else:
        protocol, path = "fs", url
    if protocol == "fs":
        from .storage_plugins.fs import FSStoragePlugin

        return FSStoragePlugin(root=path)
    raise NotImplementedError(
        f"storage protocol {protocol!r} is not supported by this package yet"
    )

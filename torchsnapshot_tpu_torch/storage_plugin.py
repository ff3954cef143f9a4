"""URL -> storage plugin.

``fs://<path>`` (or a plain path) is the local filesystem, ``memory://<name>``
an in-process store shared by name; the cloud plugins of the JAX package
come later. With ``TSS_TORCH_READ_CACHE_DIR`` set, every plugin is wrapped
in the read-through cache (``storage_plugins/cache.py``).

Also the fail-open write of a telemetry artifact
(:func:`write_telemetry_artifact`): artifacts persist through the
snapshot's own plugin, and a failed write never fails or delays the
commit it rides alongside.
"""

from __future__ import annotations

import asyncio
import logging

from . import telemetry
from .io_types import StoragePlugin, WriteIO
from .utils import knobs

logger = logging.getLogger(__name__)

# A failed artifact write warns once per process, then logs at debug.
_artifact_write_warned = False


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


def write_telemetry_artifact(
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
    path: str,
    payload: bytes,
) -> bool:
    """Write one telemetry artifact through ``storage``; True when it
    landed. Any failure is logged and swallowed."""
    global _artifact_write_warned
    try:
        with telemetry.span("telemetry.artifact_write", cat="telemetry", path=path, nbytes=len(payload)):
            storage.sync_write(WriteIO(path=path, buf=payload), event_loop)
        return True
    except Exception:  # noqa: BLE001 - fail-open by contract
        if not _artifact_write_warned:
            _artifact_write_warned = True
            logger.warning(
                "failed to persist telemetry artifact %s (snapshot commit unaffected)", path, exc_info=True
            )
        else:
            logger.debug("failed to persist telemetry artifact %s", path, exc_info=True)
        return False

"""URL -> storage plugin.

``fs://<path>`` (or a plain path) is the local filesystem, ``memory://<name>``
an in-process store shared by name, ``gs://<bucket>/<prefix>`` Google Cloud
Storage and ``s3://<bucket>/<prefix>`` S3 (their SDKs are imported when such
a plugin is built). Other protocols come from the entry-point group
``torchsnapshot_tpu_torch.storage_plugins`` (name = protocol, value = a
callable of the path).

Wrappers, bottom to top: the effect journal (``TSS_TORCH_DEBUG_EFFECTS``,
``effect_journal.py``) directly above the backend, so it records exactly
the mutations that reached storage; the read-through cache
(``TSS_TORCH_READ_CACHE_DIR``, ``storage_plugins/cache.py``); the fault
injector (``TSS_TORCH_FAULTS``, ``faults.py``) on top, so chaos schedules
reach the cache too. A wrapper whose knob is off is never imported.

Also the fail-open write of a telemetry artifact
(:func:`write_telemetry_artifact`): artifacts persist through the
snapshot's own plugin, and a failed write never fails or delays the
commit it rides alongside.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from . import telemetry
from .io_types import StoragePlugin, WriteIO
from .utils import knobs

logger = logging.getLogger(__name__)

ENTRY_POINT_GROUP = "torchsnapshot_tpu_torch.storage_plugins"

# A failed artifact write warns once per process, then logs at debug.
_artifact_write_warned = False


def url_to_storage_plugin(url_path: str) -> StoragePlugin:
    """The plugin of ``url_path``, under the wrappers its knobs turn on."""
    plugin = _resolve_storage_plugin(url_path)
    if knobs.is_debug_effects_enabled():
        from .effect_journal import maybe_wrap_with_effects

        plugin = maybe_wrap_with_effects(plugin, origin=url_path)
    if knobs.get_read_cache_dir():
        from .storage_plugins.cache import maybe_wrap_with_read_cache

        plugin = maybe_wrap_with_read_cache(plugin, origin_id=url_path)
    if knobs.get_faults_spec():
        from .faults import maybe_wrap_with_faults

        plugin = maybe_wrap_with_faults(plugin)
    return plugin


def url_to_storage_plugin_in_event_loop(
    url_path: str, event_loop: Optional[asyncio.AbstractEventLoop] = None
) -> StoragePlugin:
    """:func:`url_to_storage_plugin`, for callers that hold an event loop
    (the JAX package's signature; no plugin here needs the loop to be
    built)."""
    return url_to_storage_plugin(url_path)


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
    if protocol == "gs":
        from .storage_plugins.gcs import GCSStoragePlugin

        return GCSStoragePlugin(root=path)
    if protocol == "s3":
        from .storage_plugins.s3 import S3StoragePlugin

        return S3StoragePlugin(root=path)
    from importlib.metadata import entry_points

    for ep in entry_points(group=ENTRY_POINT_GROUP):
        if ep.name == protocol:
            return ep.load()(path)
    raise RuntimeError(f"unsupported storage protocol {protocol!r} (in url {url})")


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

"""The durable-effect journal: the crash explorer's input.

Every crash-consistency claim of the lifecycle layer ("temp+rename is the
commit point", "a catalog record is published only after its payload",
"gc deletes only outside the keep-set") is a claim about the ORDER in which
durable effects reach storage. With ``TSS_TORCH_DEBUG_EFFECTS`` set,
``url_to_storage_plugin`` wraps every plugin it builds in an
:class:`EffectRecordingPlugin`, which appends one sequence-numbered
:class:`Effect` per mutating op: its class, path, payload, a fingerprint of
the content, and the call site above the storage plumbing.

The journal sits at the BOTTOM of the wrapper stack, directly above the
backend: an op a fault rule suppressed never reached storage and is not
journaled, while a torn write's partial append is. ``crash_explorer``
replays every prefix of the journal and checks that each is a restorable
crash state. Off (the default), this module is never imported. Payloads
are kept in host RAM, so journaled runs are small by design.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import threading
import traceback
from dataclasses import dataclass
from typing import List, Optional

from .io_types import ReadIO, StoragePlugin, StorageWriteStream, WriteIO

_PLUMBING = ("effect_journal.py", "faults.py", "io_types.py", "cloud_retry.py")
_PACKAGE = "torchsnapshot_tpu_torch"


def _fingerprint(data) -> str:
    if data is None:
        return "-"
    return hashlib.sha1(bytes(data)).hexdigest()[:12]


def _origin_site() -> str:
    """``file:line (function)`` of the frame that started the mutation:
    the first frame below the journal, fault and retry plumbing, named
    from ``torchsnapshot_tpu_torch/`` on."""
    for frame in reversed(traceback.extract_stack()):
        if os.path.basename(frame.filename) in _PLUMBING:
            continue
        if frame.name in ("run", "_retrying"):
            continue  # the fault injector's retry shims
        norm = frame.filename.replace(os.sep, "/")
        if "/asyncio/" in norm or "/concurrent/" in norm:
            continue  # event-loop and executor internals
        idx = norm.rfind(_PACKAGE + "/")
        filename = norm[idx:] if idx != -1 else norm.rsplit("/", 1)[-1]
        return f"{filename}:{frame.lineno} ({frame.name})"
    return "<unknown>"


@dataclass(frozen=True)
class Effect:
    """One durable mutation seen at the storage boundary. ``seq`` is
    process-wide and monotonic: the total order a crash of one process
    truncates. ``stream_id`` ties append/commit/abort to their
    ``stream_open``. ``payload`` is a private copy of the written bytes
    (None for delete, commit and abort), kept for a bit-exact replay."""

    seq: int
    op: str
    origin: str  # the plugin's URL
    path: str
    nbytes: int
    fingerprint: str
    site: str
    stream_id: int = -1
    payload: Optional[bytes] = None

    def render(self) -> str:
        return f"#{self.seq} {self.op} {self.path} ({self.nbytes}B {self.fingerprint}) at {self.site}"


class EffectJournal:
    """Process-wide, thread-safe, append-only journal."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._effects: List[Effect] = []
        self._next_stream_id = 0

    def record(self, op: str, origin: str, path: str, payload=None, stream_id: int = -1) -> Effect:
        data = None if payload is None else bytes(memoryview(payload).cast("B"))
        site = _origin_site()
        with self._lock:
            effect = Effect(
                seq=len(self._effects),
                op=op,
                origin=origin,
                path=path,
                nbytes=0 if data is None else len(data),
                fingerprint=_fingerprint(data),
                site=site,
                stream_id=stream_id,
                payload=data,
            )
            self._effects.append(effect)
        return effect

    def new_stream_id(self) -> int:
        with self._lock:
            sid = self._next_stream_id
            self._next_stream_id += 1
            return sid

    def effects(self) -> List[Effect]:
        """A copy, in seq order."""
        with self._lock:
            return list(self._effects)

    def __len__(self) -> int:
        with self._lock:
            return len(self._effects)

    def clear(self) -> None:
        with self._lock:
            self._effects.clear()


# `_JOURNAL is None` is the disabled state; the knob is read at first use.
_JOURNAL: Optional[EffectJournal] = None
_INITIALIZED = False
_INIT_LOCK = threading.Lock()


def get_journal() -> Optional[EffectJournal]:
    """The process-wide journal, or None when the knob is off. A test
    that changes the knob calls :func:`reset`."""
    global _JOURNAL, _INITIALIZED
    if not _INITIALIZED:
        from .utils import knobs

        with _INIT_LOCK:
            if not _INITIALIZED:
                if knobs.is_debug_effects_enabled():
                    _JOURNAL = EffectJournal()
                _INITIALIZED = True
    return _JOURNAL


def reset() -> None:
    """Drop the journal and read the knob again at next use."""
    global _JOURNAL, _INITIALIZED
    with _INIT_LOCK:
        _JOURNAL = None
        _INITIALIZED = False


class _EffectRecordingWriteStream(StorageWriteStream):
    """Journals append, commit and abort under the stream's id."""

    def __init__(self, journal: EffectJournal, origin: str, path: str, stream_id: int, inner: StorageWriteStream) -> None:
        self._journal = journal
        self._origin = origin
        self._path = path
        self._stream_id = stream_id
        self.inner = inner

    async def append(self, buf) -> None:
        # Before the inner append: a crash mid-append may have landed any
        # prefix of these bytes, which the explorer's interior cuts model.
        self._journal.record("append", self._origin, self._path, payload=buf, stream_id=self._stream_id)
        await self.inner.append(buf)

    async def commit(self) -> None:
        await self.inner.commit()
        self._journal.record("commit", self._origin, self._path, stream_id=self._stream_id)

    async def abort(self) -> None:
        await self.inner.abort()
        self._journal.record("abort", self._origin, self._path, stream_id=self._stream_id)


class EffectRecordingPlugin(StoragePlugin):
    """Wraps any plugin and journals every mutating op (``write``,
    ``stream_open``, ``append``, ``commit``, ``abort``, ``delete``,
    ``link``: the op classes of ``faults.py``). Reads, listing,
    pruning and close pass through. An atomic op (write, link, a stream's
    commit) is journaled AFTER the backend accepted it; an append before."""

    def __init__(self, inner: StoragePlugin, journal: EffectJournal, origin: str) -> None:
        self.inner = inner
        self._journal = journal
        self._origin = origin

    @property
    def supports_streaming(self) -> bool:  # type: ignore[override]
        return self.inner.supports_streaming

    @property
    def scales_io_with_local_world(self) -> bool:  # type: ignore[override]
        return self.inner.scales_io_with_local_world

    async def write(self, write_io: WriteIO) -> None:
        await self.inner.write(write_io)
        self._journal.record("write", self._origin, write_io.path, payload=write_io.buf)

    async def read(self, read_io: ReadIO) -> None:
        await self.inner.read(read_io)

    async def delete(self, path: str) -> None:
        await self.inner.delete(path)
        self._journal.record("delete", self._origin, path)

    async def write_stream(self, path: str) -> StorageWriteStream:
        inner = await self.inner.write_stream(path)
        sid = self._journal.new_stream_id()
        self._journal.record("stream_open", self._origin, path, stream_id=sid)
        return _EffectRecordingWriteStream(self._journal, self._origin, path, sid, inner)

    async def link_in(self, src_abs_path: str, path: str) -> bool:
        linked = await self.inner.link_in(src_abs_path, path)
        if linked:
            # The link's bytes are the source file's: kept, so a replay
            # can land the link as a copy.
            def read_src() -> Optional[bytes]:
                try:
                    with open(src_abs_path, "rb") as f:
                        return f.read()
                except OSError:
                    return None

            payload = await asyncio.get_running_loop().run_in_executor(None, read_src)
            self._journal.record("link", self._origin, path, payload=payload)
        return linked

    async def list_prefix(self, prefix: str) -> List[str]:
        return await self.inner.list_prefix(prefix)

    async def prune_empty(self) -> None:
        await self.inner.prune_empty()

    async def close(self) -> None:
        await self.inner.close()


def maybe_wrap_with_effects(plugin: StoragePlugin, origin: str) -> StoragePlugin:
    """``plugin`` wrapped when the journal is on."""
    journal = get_journal()
    if journal is None:
        return plugin
    return EffectRecordingPlugin(plugin, journal, origin)

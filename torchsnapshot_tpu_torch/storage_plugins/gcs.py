"""Google Cloud Storage (``gs://<bucket>/<prefix>``).

Chunked resumable uploads and ranged downloads on a thread pool behind the
async plugin interface, with transient retries under a collective-progress
window (``cloud_retry``). The ``google-cloud-storage`` SDK is synchronous,
so every blob operation runs on the plugin's own pool of 8 threads.

Objects above ``TSS_TORCH_GCS_CHUNK_BYTES`` upload through a resumable
session: a transient fault mid-transfer recovers the server's cursor and
resends at most the interrupted chunk; a chunk that makes no progress for
``_MAX_STALLED_CHUNK_RETRIES`` faults in a row aborts the upload. A stream
(``write_stream``) feeds an unknown-size resumable session. An incremental
take copies unchanged objects server side (``link_in``, a rewrite loop).

The SDK is imported when a plugin is built: this module imports without
it, and building the plugin without it raises a clear error. Telemetry:
``storage.write``/``read``/``link_in``/``write_stream`` spans
(``plugin="gcs"``) and the ``storage.gcs.write_bytes``, ``read_bytes`` and
``link_in_count`` counters. A copy of the JAX package's plugin.
"""

from __future__ import annotations

import asyncio
import logging
import time
from concurrent.futures import ThreadPoolExecutor

from .. import telemetry
from ..io_types import ReadIO, StoragePlugin, StorageWriteStream, WriteIO
from ..memoryview_stream import MemoryviewStream
from ..utils import knobs
from .cloud_retry import CollectiveProgress, backoff_s, retry_transient

logger = logging.getLogger(__name__)

_IO_THREADS = 8
# Consecutive transmits of ONE resumable chunk with no cursor advance before
# the upload aborts (~2.5 min at max backoff). Needed because successful
# cursor-recovery calls keep the collective-progress window open forever.
_MAX_STALLED_CHUNK_RETRIES = 12


class GCSStoragePlugin(StoragePlugin):
    supports_streaming = True  # appends feed a resumable upload session

    def __init__(self, root: str) -> None:
        try:
            from google.cloud import storage as gcs  # type: ignore[import-not-found]
        except ImportError as e:
            raise RuntimeError(
                "gs:// storage requires the google-cloud-storage package "
                "(pip install google-cloud-storage)"
            ) from e
        bucket_name, _, self.prefix = root.partition("/")
        self._client = gcs.Client()
        self._bucket = self._client.bucket(bucket_name)
        self._executor = ThreadPoolExecutor(max_workers=_IO_THREADS)
        self._progress = CollectiveProgress()

    def _blob_path(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    def _make_upload_transport(self):
        """A fresh AuthorizedSession PER resumable upload. ``requests.
        Session`` is not documented thread-safe, and concurrent large-object
        uploads run on different executor threads — a shared session risks
        cookie-jar/credential-refresh races. Each
        upload still reuses its own connection across all of its chunks,
        which is where connection reuse actually pays."""
        return _make_authorized_session(self._client)

    async def _retrying(self, fn) -> object:
        loop = asyncio.get_running_loop()
        return await retry_transient(
            lambda: loop.run_in_executor(self._executor, fn),
            _is_transient,
            self._progress,
            "GCS",
        )

    async def write(self, write_io: WriteIO) -> None:
        mv = memoryview(write_io.buf)
        with telemetry.span(
            "storage.write",
            cat="storage",
            plugin="gcs",
            path=write_io.path,
            nbytes=mv.nbytes,
        ):
            if mv.nbytes > knobs.get_gcs_chunk_bytes():
                await self._upload_resumable(write_io.path, mv)
            else:
                blob = self._bucket.blob(self._blob_path(write_io.path))

                def upload() -> None:
                    blob.upload_from_file(
                        MemoryviewStream(mv), size=mv.nbytes, rewind=True
                    )

                await self._retrying(upload)
        telemetry.counter_add("storage.gcs.write_bytes", mv.nbytes)

    async def _upload_resumable(self, path: str, mv: memoryview) -> None:
        """Chunked resumable upload with write-cursor recovery.

        On a transient mid-transfer failure the session's persisted byte
        offset is recovered from the server and the stream repositioned
        there, so at most the interrupted chunk is re-sent — re-sending a
        whole 100 MB+ slab per fault on a flaky link is what this avoids.
        Whole-object one-shot uploads (below the chunk threshold) keep the
        simpler retry-the-object path in :meth:`write`.
        """
        loop = asyncio.get_running_loop()
        chunk_bytes = knobs.get_gcs_chunk_bytes()

        def initiate():
            return _make_resumable_session(
                self._client,
                self._bucket.name,
                self._blob_path(path),
                mv,
                chunk_bytes,
                transport_factory=self._make_upload_transport,
            )

        session = await self._retrying(initiate)
        try:
            await self._drive_resumable(loop, session, path)
        finally:
            # The per-upload transport's connection pool dies with the upload.
            close = getattr(session, "close", None)
            if close is not None:
                close()

    async def _drive_resumable(
        self, loop, session, path: str, should_transmit=None
    ) -> None:
        """Transmit chunks with transient retry + cursor recovery. Default:
        until the session finishes (whole-object uploads). A streamed write
        passes ``should_transmit`` to stop while its feed still expects more
        appends (transmitting then would read a short chunk and finalize
        the object early)."""
        attempt = 0
        stalled = 0
        while not session.finished:
            if should_transmit is not None and not should_transmit():
                return
            cursor = session.bytes_uploaded
            # Op start counts as activity (same convention as _retrying):
            # a single chunk can legitimately take longer than the progress
            # window on a slow link, and its first fault must still get a
            # recover+retry rather than finding the window already expired.
            self._progress.note_progress()
            try:
                await loop.run_in_executor(self._executor, session.transmit_next_chunk)
            except Exception as e:  # noqa: BLE001 - classified below
                if not _is_transient(e) or self._progress.out_of_time():
                    raise
                attempt += 1
                # Same window clamping retry_transient applies: a
                # backoff sleep never overshoots the collective-progress
                # deadline by more than the epsilon, and the post-sleep
                # re-check below surfaces the error promptly when nothing
                # else made progress meanwhile.
                backoff = min(
                    backoff_s(attempt), self._progress.remaining_s() + 0.05
                )
                logger.warning(
                    "Transient GCS error mid-upload of %s at byte %d "
                    "(attempt %d, recovering cursor and retrying in %.1fs): %s",
                    path,
                    cursor,
                    attempt,
                    backoff,
                    e,
                )
                await asyncio.sleep(backoff)
                if self._progress.out_of_time():
                    # The window expired during the sleep (and nothing else
                    # made progress): surface the transient error now.
                    raise
                # Recover the server's persisted write cursor; the session
                # repositions the source stream to it. recover() is
                # idempotent, so it gets the same transient-retry treatment
                # as any other op.
                try:
                    await self._retrying(session.recover)
                except Exception as recover_exc:  # noqa: BLE001
                    if _response_status(recover_exc) in (200, 201):
                        # The interrupted transmit was actually the final
                        # chunk and only its ack was lost: a status probe of
                        # a *completed* resumable session returns 200 (not
                        # 308), which resumable_media surfaces as
                        # InvalidResponse. The object is committed
                        # server-side — the upload is done.
                        return
                    raise
                # Stalled-chunk cap, judged on the *recovered* cursor (a
                # failed transmit never advances bytes_uploaded; only
                # recover() reveals server-side partial progress). It exists
                # because the collective-progress window alone cannot expire
                # this loop — a successful recover() refreshes the window
                # every iteration even when no byte ever lands. N consecutive
                # faults with a frozen cursor mean the chunk is
                # undeliverable — give up. Faults with forward progress
                # (flaky link, server keeps partial bytes each round) reset
                # the counter and retry indefinitely within the window.
                stalled = stalled + 1 if session.bytes_uploaded <= cursor else 0
                if stalled >= _MAX_STALLED_CHUNK_RETRIES:
                    raise
                continue
            if session.bytes_uploaded > cursor:
                attempt = 0
                stalled = 0
                self._progress.note_progress()

    async def write_stream(self, path: str) -> StorageWriteStream:
        return _GCSWriteStream(self, path)

    async def read(self, read_io: ReadIO) -> None:
        blob = self._bucket.blob(self._blob_path(read_io.path))
        with telemetry.span(
            "storage.read", cat="storage", plugin="gcs", path=read_io.path
        ) as sp:
            try:
                if read_io.byte_range is None:
                    data = await self._retrying(blob.download_as_bytes)
                else:
                    begin, end = read_io.byte_range
                    data = await self._retrying(
                        # GCS ranges are inclusive on both ends.
                        lambda: blob.download_as_bytes(start=begin, end=end - 1)
                    )
            except Exception as e:
                if _is_not_found(e):
                    raise FileNotFoundError(read_io.path) from e
                raise
            sp.set_attrs(nbytes=len(data))
            _deliver(read_io, data)
        telemetry.counter_add("storage.gcs.read_bytes", len(data))

    async def delete(self, path: str) -> None:
        blob = self._bucket.blob(self._blob_path(path))
        try:
            await self._retrying(blob.delete)
        except Exception as e:
            if _is_not_found(e):
                raise FileNotFoundError(path) from e
            raise

    async def list_prefix(self, prefix: str) -> list:
        full = self._blob_path(prefix) if prefix else self.prefix
        strip = f"{self.prefix}/" if self.prefix else ""

        def work() -> list:
            blobs = self._client.list_blobs(self._bucket.name, prefix=full)
            return sorted(
                b.name[len(strip):] for b in blobs if b.name.startswith(strip)
            )

        return await self._retrying(work)

    async def link_in(self, src_abs_path: str, path: str) -> bool:
        """Server-side copy from a base snapshot (incremental takes): a GCS
        rewrite moves no bytes through this host. ``src_abs_path`` is the
        base object's full ``gs://bucket/...`` URL; only same-provider
        sources are supported (cross-bucket works — rewrites are
        server-side either way)."""
        if not src_abs_path.startswith("gs://"):
            return False
        src_bucket_name, _, src_key = src_abs_path[len("gs://") :].partition("/")
        with telemetry.span(
            "storage.link_in", cat="storage", plugin="gcs", path=path
        ) as sp:
            ok = await self._link_in_inner(src_bucket_name, src_key, path)
            sp.set_attrs(linked=ok)
        if ok:
            telemetry.counter_add("storage.gcs.link_in_count")
        return ok

    async def _link_in_inner(
        self, src_bucket_name: str, src_key: str, path: str
    ) -> bool:
        src_abs_path = f"gs://{src_bucket_name}/{src_key}"
        try:
            src_bucket = self._client.bucket(src_bucket_name)
            src_blob = src_bucket.blob(src_key)
            dst_blob = self._bucket.blob(self._blob_path(path))

            def copy() -> None:
                # Rewrite (not objects.copy): resumable via token loop, so
                # multi-GB and cross-location/storage-class copies don't
                # blow a single-request deadline.
                token, _, _ = dst_blob.rewrite(src_blob)
                while token is not None:
                    token, _, _ = dst_blob.rewrite(src_blob, token=token)

            await self._retrying(copy)
            return True
        except Exception:
            logger.warning(
                "Server-side copy of %s failed; rewriting the object",
                src_abs_path,
                exc_info=True,
            )
            return False

    async def close(self) -> None:
        self._executor.shutdown(wait=True)


class _StreamFeed:
    """File-like over a sliding window of streamed bytes.

    The resumable-upload session reads chunks from this object; only bytes
    the server has NOT yet acked are retained (``drop_acked``), so host RAM
    for a streamed upload is bounded by ~one chunk plus the unsent buffer —
    while ``seek``/``tell`` still behave like a full file within that
    window, which is all ``ResumableUpload.recover`` ever seeks into (the
    recovered cursor is always >= the last acked byte)."""

    def __init__(self) -> None:
        self._base = 0  # global offset of the first retained byte
        self._buf = bytearray()
        self._pos = 0  # global read cursor
        self.fed_bytes = 0

    def feed(self, data) -> None:
        self._buf.extend(data)
        self.fed_bytes += memoryview(data).nbytes

    def pending_bytes(self) -> int:
        """Bytes fed but not yet consumed by a transmit."""
        return self.fed_bytes - self._pos

    def drop_acked(self, acked: int) -> None:
        if acked > self._base:
            del self._buf[: acked - self._base]
            self._base = acked

    def read(self, n: int = -1) -> bytes:
        start = self._pos - self._base
        if start < 0:
            raise ValueError(
                f"stream feed rewound past its retained window "
                f"({self._pos} < {self._base})"
            )
        if n is None or n < 0:
            out = bytes(self._buf[start:])
        else:
            out = bytes(self._buf[start : start + n])
        self._pos += len(out)
        return out

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence != 0:
            raise ValueError("stream feed supports absolute seeks only")
        self._pos = pos
        return pos

    def tell(self) -> int:
        return self._pos


class _GCSWriteStream(StorageWriteStream):
    """Streamed write as an unknown-total-size resumable upload: appends
    buffer to the chunk quantum and transmit through the session (each
    chunk individually retried with cursor recovery, like whole-object
    resumable uploads); commit transmits the short final chunk, which is
    what finalizes the object server-side — an aborted stream leaves no
    object (unfinalized resumable sessions expire). Streams smaller than
    one chunk degenerate to a single PUT at commit."""

    def __init__(self, plugin: "GCSStoragePlugin", path: str) -> None:
        self._plugin = plugin
        self._path = path
        self._feed = _StreamFeed()
        self._session = None
        self._t0 = time.monotonic()

    async def _drain(self, final: bool) -> None:
        session = self._session
        loop = asyncio.get_running_loop()
        should_transmit = None
        if not final:
            # Stop while a full chunk isn't buffered: a short read would
            # finalize the upload with the object truncated.
            should_transmit = (
                lambda: self._feed.pending_bytes() >= session.chunk_bytes
            )
        await self._plugin._drive_resumable(
            loop, session, self._path, should_transmit=should_transmit
        )
        self._feed.drop_acked(session.bytes_uploaded)

    @staticmethod
    def _chunk_bytes() -> int:
        # Streamed transmits track the scheduler's stream-chunk grain (so
        # the feed retains ~one chunk, keeping the per-chunk budget honest)
        # capped by the plugin's configured chunk; the session rounds up to
        # the wire's 256 KiB quantum.
        return min(
            knobs.get_gcs_chunk_bytes(),
            max(knobs.get_stream_chunk_bytes(), 256 * 1024),
        )

    async def append(self, buf) -> None:
        self._feed.feed(memoryview(buf))
        chunk = self._chunk_bytes()
        if self._session is None:
            if self._feed.pending_bytes() <= chunk:
                return  # keep buffering; may still fit a one-shot PUT
            plugin = self._plugin

            def initiate():
                return _make_streaming_session(
                    plugin._client,
                    plugin._bucket.name,
                    plugin._blob_path(self._path),
                    self._feed,
                    chunk,
                    transport_factory=plugin._make_upload_transport,
                )

            self._session = await plugin._retrying(initiate)
        await self._drain(final=False)

    async def commit(self) -> None:
        plugin = self._plugin
        total = self._feed.fed_bytes
        if self._session is None:
            # Small object: one PUT (records its own span + byte counter).
            await plugin.write(
                WriteIO(path=self._path, buf=self._feed.read(-1))
            )
            return
        try:
            await self._drain(final=True)
        finally:
            close = getattr(self._session, "close", None)
            if close is not None:
                close()
        tm = telemetry.get_active()
        if tm is not None:
            t1 = time.monotonic()
            tm.add_span(
                "storage.write_stream",
                "storage",
                self._t0,
                t1 - self._t0,
                {"plugin": "gcs", "path": self._path, "nbytes": total},
            )
        telemetry.counter_add("storage.gcs.write_bytes", total)

    async def abort(self) -> None:
        # An unfinalized resumable session holds no visible object and
        # expires server-side; just drop the transport's connections.
        if self._session is not None:
            close = getattr(self._session, "close", None)
            if close is not None:
                close()
            self._session = None


class _GoogleResumableSession:
    """Thin sync wrapper over ``google.resumable_media``'s resumable upload.

    Everything above this seam (chunk loop, per-chunk retry, cursor
    recovery, collective-progress accounting) is plugin logic drilled by the
    fake-server tests; this class is the only part that touches the real
    wire protocol, covered by the gated integration test.
    """

    def __init__(
        self,
        client,
        bucket_name: str,
        blob_name: str,
        mv: memoryview,
        chunk_bytes: int,
        transport_factory,
    ) -> None:
        from google.resumable_media.requests import ResumableUpload  # type: ignore[import-not-found]

        # Per-upload session (see GCSStoragePlugin._make_upload_transport);
        # closed by the upload loop — or right here if initiate() fails, so
        # retried initiates can't leak one connection pool per attempt.
        self._transport = transport_factory()
        # Honor custom endpoints (emulators, private Google access) the same
        # way Blob.upload does: the base URL comes from the client's
        # connection, not a hardcoded production host.
        api_base = getattr(
            getattr(client, "_connection", None),
            "API_BASE_URL",
            "https://storage.googleapis.com",
        )
        upload_url = (
            f"{api_base}/upload/storage/v1/b/{bucket_name}/o?uploadType=resumable"
        )
        # The wire protocol requires 256 KiB-multiple chunks; round up here
        # (the real-session layer) so any knob value works — passing a raw
        # sub-multiple would raise a non-transient ValueError on the first
        # large write.
        quantum = 256 * 1024
        chunk_bytes = max(quantum, (chunk_bytes + quantum - 1) // quantum * quantum)
        self._upload = ResumableUpload(upload_url, chunk_bytes)
        try:
            self._upload.initiate(
                self._transport,
                MemoryviewStream(mv),
                metadata={"name": blob_name},
                content_type="application/octet-stream",
                total_bytes=mv.nbytes,
            )
        except BaseException:
            self.close()
            raise

    @property
    def finished(self) -> bool:
        return self._upload.finished

    @property
    def bytes_uploaded(self) -> int:
        return int(self._upload.bytes_uploaded or 0)

    def transmit_next_chunk(self) -> None:
        self._upload.transmit_next_chunk(self._transport)

    def recover(self) -> None:
        self._upload.recover(self._transport)

    def close(self) -> None:
        try:
            self._transport.close()
        except Exception:  # pragma: no cover - session already dead
            pass


class _GoogleStreamingResumableSession:
    """Unknown-total-size resumable session over a :class:`_StreamFeed`.

    Same wire mechanics as :class:`_GoogleResumableSession`, but initiated
    with ``stream_final=False`` and no total: ``transmit_next_chunk`` reads
    full chunks from the feed until the final (short) read finalizes the
    object — the resumable protocol's documented streaming mode. The caller
    (``_GCSWriteStream``) guarantees a full chunk is buffered before every
    non-final transmit.
    """

    def __init__(
        self,
        client,
        bucket_name: str,
        blob_name: str,
        feed: "_StreamFeed",
        chunk_bytes: int,
        transport_factory,
    ) -> None:
        from google.resumable_media.requests import ResumableUpload  # type: ignore[import-not-found]

        self._transport = transport_factory()
        api_base = getattr(
            getattr(client, "_connection", None),
            "API_BASE_URL",
            "https://storage.googleapis.com",
        )
        upload_url = (
            f"{api_base}/upload/storage/v1/b/{bucket_name}/o?uploadType=resumable"
        )
        # 256 KiB quantum: same wire requirement as the whole-object session.
        quantum = 256 * 1024
        self.chunk_bytes = max(
            quantum, (chunk_bytes + quantum - 1) // quantum * quantum
        )
        self._upload = ResumableUpload(upload_url, self.chunk_bytes)
        try:
            self._upload.initiate(
                self._transport,
                feed,
                metadata={"name": blob_name},
                content_type="application/octet-stream",
                stream_final=False,
            )
        except BaseException:
            self.close()
            raise

    @property
    def finished(self) -> bool:
        return self._upload.finished

    @property
    def bytes_uploaded(self) -> int:
        return int(self._upload.bytes_uploaded or 0)

    def transmit_next_chunk(self) -> None:
        self._upload.transmit_next_chunk(self._transport)

    def recover(self) -> None:
        self._upload.recover(self._transport)

    def close(self) -> None:
        try:
            self._transport.close()
        except Exception:  # pragma: no cover - session already dead
            pass


def _make_streaming_session(
    client,
    bucket_name: str,
    blob_name: str,
    feed: "_StreamFeed",
    chunk_bytes: int,
    transport_factory,
):
    """Indirection point for streamed writes: fake-server tests replace this
    to simulate an unknown-size resumable session (mid-chunk faults and
    all) without the SDK."""
    return _GoogleStreamingResumableSession(
        client, bucket_name, blob_name, feed, chunk_bytes, transport_factory
    )


def _deliver(read_io: ReadIO, data: bytes) -> None:
    """Hand a download to the reader: into its ``into`` buffer when it
    gave one, else as the fetched bytes."""
    if read_io.into is not None:
        memoryview(read_io.into).cast("B")[:] = data
        read_io.buf = read_io.into
    else:
        read_io.buf = data


def _response_status(e: Exception):
    """HTTP status attached to an SDK error (e.g. InvalidResponse), or None."""
    return getattr(getattr(e, "response", None), "status_code", None)


def _make_authorized_session(client):
    from google.auth.transport.requests import AuthorizedSession  # type: ignore[import-not-found]

    return AuthorizedSession(client._credentials)


def _make_resumable_session(
    client,
    bucket_name: str,
    blob_name: str,
    mv: memoryview,
    chunk_bytes: int,
    transport_factory,
):
    """Indirection point: fake-server tests replace this to simulate a GCS
    resumable session with injected mid-chunk faults. ``transport_factory``
    is a zero-arg callable yielding the plugin's shared authorized session;
    fakes never call it."""
    return _GoogleResumableSession(
        client, bucket_name, blob_name, mv, chunk_bytes, transport_factory
    )


def _is_not_found(e: Exception) -> bool:
    """Backend absence, normalized per the StoragePlugin contract."""
    try:
        from google.api_core import exceptions as gexc  # type: ignore[import-not-found]

        return isinstance(e, gexc.NotFound)
    except ImportError:
        return False


def _is_transient(e: Exception) -> bool:
    try:
        from google.api_core import exceptions as gexc  # type: ignore[import-not-found]

        if isinstance(
            e,
            (
                gexc.TooManyRequests,
                gexc.InternalServerError,
                gexc.BadGateway,
                gexc.ServiceUnavailable,
                gexc.GatewayTimeout,
            ),
        ):
            return True
    except ImportError:
        pass
    try:
        from google.resumable_media import InvalidResponse  # type: ignore[import-not-found]

        if isinstance(e, InvalidResponse):
            # Resumable-upload chunk failures surface as InvalidResponse
            # with the HTTP status attached; retry the retryable statuses.
            code = getattr(e.response, "status_code", None)
            return code in (408, 429, 500, 502, 503, 504)
    except ImportError:
        pass
    return isinstance(e, (ConnectionError, TimeoutError))

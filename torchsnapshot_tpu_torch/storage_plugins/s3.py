"""S3 (``s3://<bucket>/<prefix>``), through ``aioboto3``.

``put_object``/``get_object`` with ranged reads through the HTTP ``Range``
header (whose end is inclusive), streaming staged memoryviews without a
copy. Transient errors retry under a collective-progress window
(``cloud_retry``). Objects above ``TSS_TORCH_S3_CHUNK_BYTES`` upload as a
multipart upload whose parts retry one by one, so a fault resends at most
one part; a failed multipart upload is aborted, so no orphaned parts stay
billed. A stream (``write_stream``) uploads its parts as it goes. An
incremental take copies unchanged objects server side (``link_in``).

The SDK is imported when a plugin is built: this module imports without
it, and building the plugin without it raises a clear error. Telemetry:
``storage.write``/``read``/``link_in``/``write_stream`` spans
(``plugin="s3"``) and the ``storage.s3.*`` counters. A copy of the JAX
package's plugin.
"""

from __future__ import annotations

import asyncio
import logging
import time

from .. import telemetry
from ..io_types import ReadIO, StoragePlugin, StorageWriteStream, WriteIO
from ..utils import knobs
from .cloud_retry import CollectiveProgress, retry_transient

logger = logging.getLogger(__name__)

# Concurrent in-flight parts per multipart upload: parts are independent
# slices of one already-staged buffer, so concurrency costs no memory and
# hides per-part round-trip latency on large objects.
_MULTIPART_CONCURRENCY = 8


class _S3WriteStream(StorageWriteStream):
    """Streamed write as an S3 multipart upload: appends accumulate to the
    part size and upload as individual parts (each retried independently);
    commit sends the tail part and completes the upload — S3 materializes
    the object atomically at complete, so a mid-stream failure followed by
    abort leaves no object and no billed parts. Streams that never reach
    one part size degenerate to a single PUT at commit."""

    def __init__(self, plugin: "S3StoragePlugin", path: str) -> None:
        self._plugin = plugin
        self._path = path
        self._buf = bytearray()
        self._upload_id = None
        self._parts: list = []
        self._total = 0
        self._t0 = time.monotonic()
        self._started_at = time.time()

    async def _send_part(self, body: bytes) -> None:
        plugin = self._plugin
        client = await plugin._get_client()
        key = plugin._key(self._path)
        if self._upload_id is None:
            created = await plugin._retrying(
                lambda: client.create_multipart_upload(
                    Bucket=plugin.bucket, Key=key
                )
            )
            self._upload_id = created["UploadId"]
        number = len(self._parts) + 1
        resp = await plugin._retrying(
            lambda: client.upload_part(
                Bucket=plugin.bucket,
                Key=key,
                PartNumber=number,
                UploadId=self._upload_id,
                Body=body,
            )
        )
        self._parts.append({"PartNumber": number, "ETag": resp["ETag"]})

    @staticmethod
    def _part_bytes() -> int:
        # Streamed parts track the scheduler's stream-chunk grain (so the
        # stream buffers ~one chunk, keeping the per-chunk budget honest)
        # but never below S3's 5 MiB part minimum, and never above the
        # plugin's configured part size. Sub-minimum S3_CHUNK_BYTES values
        # (fake backends in tests) are honored verbatim.
        return min(
            knobs.get_s3_chunk_bytes(),
            max(knobs.get_stream_chunk_bytes(), 5 * 1024 * 1024),
        )

    async def append(self, buf) -> None:
        mv = memoryview(buf)
        self._total += mv.nbytes
        self._buf.extend(mv)
        chunk = self._part_bytes()
        while len(self._buf) >= chunk:
            body = bytes(memoryview(self._buf)[:chunk])
            del self._buf[:chunk]
            await self._send_part(body)

    async def commit(self) -> None:
        plugin = self._plugin
        if self._upload_id is None:
            # Never reached a part size: one plain PUT (which records its
            # own span + byte counter).
            await plugin.write(WriteIO(path=self._path, buf=bytes(self._buf)))
            self._buf = bytearray()
            return
        if self._buf:
            body = bytes(self._buf)
            self._buf = bytearray()
            await self._send_part(body)
        await plugin._complete_multipart(
            plugin._key(self._path),
            self._upload_id,
            list(self._parts),
            self._total,
            self._started_at,
        )
        tm = telemetry.get_active()
        if tm is not None:
            t1 = time.monotonic()
            tm.add_span(
                "storage.write_stream",
                "storage",
                self._t0,
                t1 - self._t0,
                {"plugin": "s3", "path": self._path, "nbytes": self._total},
            )
        telemetry.counter_add("storage.s3.write_bytes", self._total)

    async def abort(self) -> None:
        self._buf = bytearray()
        if self._upload_id is not None:
            await self._plugin._abort_multipart(
                self._plugin._key(self._path), self._upload_id
            )
            self._upload_id = None


class S3StoragePlugin(StoragePlugin):
    supports_streaming = True  # appends upload as multipart parts

    def __init__(self, root: str) -> None:
        try:
            import aioboto3  # type: ignore[import-not-found]
        except ImportError as e:
            raise RuntimeError(
                "s3:// storage requires the aioboto3 package "
                "(pip install aioboto3)"
            ) from e
        self.bucket, _, self.prefix = root.partition("/")
        self._session = aioboto3.Session()
        self._client_ctx = None
        self._client = None
        self._progress = CollectiveProgress()

    async def _get_client(self):
        if self._client is None:
            self._client_ctx = self._session.client("s3")
            self._client = await self._client_ctx.__aenter__()
        return self._client

    def _key(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    async def _retrying(self, coro_factory):
        return await retry_transient(
            coro_factory, _is_transient, self._progress, "S3"
        )

    async def write(self, write_io: WriteIO) -> None:
        mv = memoryview(write_io.buf)
        with telemetry.span(
            "storage.write",
            cat="storage",
            plugin="s3",
            path=write_io.path,
            nbytes=mv.nbytes,
        ):
            if mv.nbytes > knobs.get_s3_chunk_bytes():
                await self._upload_multipart(write_io.path, mv)
            else:
                client = await self._get_client()

                def put():
                    return client.put_object(
                        Bucket=self.bucket,
                        Key=self._key(write_io.path),
                        # bytes-like staged buffers (incl. memoryviews)
                        # stream without a copy; copying a multi-GB shard
                        # here would blow the scheduler's memory budget
                        # accounting.
                        Body=write_io.buf,
                    )

                await self._retrying(put)
        telemetry.counter_add("storage.s3.write_bytes", mv.nbytes)

    async def _upload_multipart(self, path: str, mv: memoryview) -> None:
        """Chunked upload with per-part retry: a transient fault re-sends at
        most the interrupted part. Aborts the upload on permanent failure so
        S3 doesn't bill for orphaned parts forever."""
        client = await self._get_client()
        key = self._key(path)
        chunk = knobs.get_s3_chunk_bytes()
        upload_started_at = time.time()
        created = await self._retrying(
            lambda: client.create_multipart_upload(Bucket=self.bucket, Key=key)
        )
        upload_id = created["UploadId"]
        try:
            # Parts are order-independent on the wire; bounded concurrency
            # hides per-part round-trip latency. gather preserves input
            # order, so the completed Parts list stays sorted by number.
            sem = asyncio.Semaphore(_MULTIPART_CONCURRENCY)

            async def send_one(number: int, body) -> dict:
                async with sem:
                    resp = await self._retrying(
                        lambda: client.upload_part(
                            Bucket=self.bucket,
                            Key=key,
                            PartNumber=number,
                            UploadId=upload_id,
                            Body=body,
                        )
                    )
                return {"PartNumber": number, "ETag": resp["ETag"]}

            tasks = [
                asyncio.ensure_future(send_one(number, mv[offset : offset + chunk]))
                for number, offset in enumerate(range(0, mv.nbytes, chunk), start=1)
            ]
            try:
                parts = await asyncio.gather(*tasks)
            except BaseException:
                # Quiesce siblings BEFORE aborting: parts uploaded
                # concurrently with an abort can still land (and bill)
                # per AWS semantics, and abandoned tasks would surface as
                # never-retrieved exceptions.
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                raise
            await self._complete_multipart(
                key, upload_id, list(parts), mv.nbytes, upload_started_at
            )
        except BaseException:
            await self._abort_multipart(key, upload_id)
            raise

    async def _complete_multipart(
        self,
        key: str,
        upload_id: str,
        parts: list,
        expected_size: int,
        upload_started_at: float,
    ) -> None:
        client = await self._get_client()
        try:
            await self._retrying(
                lambda: client.complete_multipart_upload(
                    Bucket=self.bucket,
                    Key=key,
                    UploadId=upload_id,
                    MultipartUpload={"Parts": parts},
                )
            )
        except Exception as complete_exc:
            # S3's documented 200-with-InternalError-body case: the
            # complete can COMMIT server-side yet surface as a transient
            # failure, and its retry then gets NoSuchUpload (the upload
            # id is consumed by the commit). Probe the object: present
            # at the right size == the complete succeeded.
            if _error_code(complete_exc) != "NoSuchUpload":
                raise
            try:
                head = await self._retrying(
                    lambda: client.head_object(Bucket=self.bucket, Key=key)
                )
            except Exception as probe_exc:
                # The probe failing (object truly absent, or transient
                # 403/503 past the retry window) must not MASK the
                # complete failure it was diagnosing — re-raise the
                # original, chained so both are visible.
                raise complete_exc from probe_exc
            if int(head.get("ContentLength", -1)) != expected_size:
                raise
            # Size alone can't distinguish THIS upload's commit from a
            # stale same-key object of an earlier take (raw payload
            # sizes are pure functions of shape+dtype): also require
            # the object to be newer than this upload's start. SigV4
            # already bounds client/S3 clock skew to 15 minutes, so a
            # 15-minute tolerance is principled, not arbitrary.
            modified = head.get("LastModified")
            modified_ts = modified.timestamp() if modified is not None else None
            if modified_ts is not None and modified_ts < (
                upload_started_at - 900
            ):
                raise
            logger.info(
                "multipart complete for %s reported NoSuchUpload but the "
                "object exists at the expected size and mtime; treating "
                "the upload as committed",
                key,
            )

    async def _abort_multipart(self, key: str, upload_id: str) -> None:
        client = await self._get_client()
        try:
            # The abort gets the same transient-retry treatment as any
            # other op: the failure context is often congestion, and a
            # swallowed abort orphans every uploaded part until a
            # lifecycle rule cleans it.
            await self._retrying(
                lambda: client.abort_multipart_upload(
                    Bucket=self.bucket, Key=key, UploadId=upload_id
                )
            )
        except Exception as abort_exc:
            if _error_code(abort_exc) == "NoSuchUpload":
                # Upload id already consumed (committed or cleaned up
                # server-side): nothing orphaned, nothing to warn about.
                pass
            else:
                logger.warning(
                    "Failed to abort multipart upload %s for %s; orphaned "
                    "parts may accrue storage until a bucket lifecycle "
                    "rule cleans them",
                    upload_id,
                    key,
                    exc_info=True,
                )

    async def write_stream(self, path: str) -> StorageWriteStream:
        return _S3WriteStream(self, path)

    async def read(self, read_io: ReadIO) -> None:
        client = await self._get_client()
        kwargs = {}
        if read_io.byte_range is not None:
            begin, end = read_io.byte_range
            # HTTP Range end is inclusive.
            kwargs["Range"] = f"bytes={begin}-{end - 1}"
        async def fetch() -> bytes:
            # The body download is INSIDE the retried callable: a connection
            # reset halfway through the stream is just as transient as one
            # during the request itself.
            resp = await client.get_object(
                Bucket=self.bucket, Key=self._key(read_io.path), **kwargs
            )
            async with resp["Body"] as stream:
                return await stream.read()

        with telemetry.span(
            "storage.read", cat="storage", plugin="s3", path=read_io.path
        ) as sp:
            try:
                data = await self._retrying(fetch)
            except Exception as e:
                if _is_no_such_key(e):
                    raise FileNotFoundError(read_io.path) from e
                raise
            sp.set_attrs(nbytes=len(data))
            if read_io.into is not None:
                memoryview(read_io.into).cast("B")[:] = data
                read_io.buf = read_io.into
            else:
                read_io.buf = data
        telemetry.counter_add("storage.s3.read_bytes", len(data))

    async def delete(self, path: str) -> None:
        # S3 DeleteObject is idempotent (204 for absent keys) — the allowed
        # "succeeds silently on absence" form of the StoragePlugin delete
        # contract. No HEAD probe: it would double round-trips and break
        # under delete-only IAM policies (HeadObject needs read permission).
        client = await self._get_client()
        await self._retrying(
            lambda: client.delete_object(Bucket=self.bucket, Key=self._key(path))
        )

    async def list_prefix(self, prefix: str) -> list:
        client = await self._get_client()
        full = self._key(prefix) if prefix else self.prefix
        strip = f"{self.prefix}/" if self.prefix else ""

        async def list_all() -> list:
            out = []
            token = None
            while True:
                kwargs = {"Bucket": self.bucket, "Prefix": full}
                if token:
                    kwargs["ContinuationToken"] = token
                resp = await client.list_objects_v2(**kwargs)
                for obj in resp.get("Contents", []) or []:
                    key = obj["Key"]
                    if key.startswith(strip):
                        out.append(key[len(strip):])
                if not resp.get("IsTruncated"):
                    return sorted(out)
                token = resp.get("NextContinuationToken")

        return await self._retrying(list_all)

    async def link_in(self, src_abs_path: str, path: str) -> bool:
        """Server-side CopyObject from a base snapshot (incremental takes):
        no bytes move through this host. ``src_abs_path`` is the base
        object's full ``s3://bucket/...`` URL."""
        if not src_abs_path.startswith("s3://"):
            return False
        src_bucket, _, src_key = src_abs_path[len("s3://") :].partition("/")
        with telemetry.span(
            "storage.link_in", cat="storage", plugin="s3", path=path
        ) as sp:
            ok = await self._link_in_inner(src_abs_path, src_bucket, src_key, path)
            sp.set_attrs(linked=ok)
        if ok:
            telemetry.counter_add("storage.s3.link_in_count")
        return ok

    async def _link_in_inner(
        self, src_abs_path: str, src_bucket: str, src_key: str, path: str
    ) -> bool:
        try:
            client = await self._get_client()
            src = {"Bucket": src_bucket, "Key": src_key}
            if hasattr(client, "copy"):
                # Managed transfer: multipart UploadPartCopy above the 5 GiB
                # single-request CopyObject limit — frozen multi-GB shards
                # are exactly the dedup target.
                await client.copy(src, self.bucket, self._key(path))
            else:  # pragma: no cover - minimal clients
                await client.copy_object(
                    Bucket=self.bucket, Key=self._key(path), CopySource=src
                )
            return True
        except Exception:
            logger.warning(
                "Server-side copy of %s failed; rewriting the object",
                src_abs_path,
                exc_info=True,
            )
            return False

    async def close(self) -> None:
        if self._client_ctx is not None:
            await self._client_ctx.__aexit__(None, None, None)
            self._client = None
            self._client_ctx = None


def _error_code(e: Exception):
    """The structured botocore error code of ``e``, or None."""
    resp = getattr(e, "response", None)
    if isinstance(resp, dict):
        return resp.get("Error", {}).get("Code")
    return None


def _is_no_such_key(e: Exception) -> bool:
    """Backend absence, normalized per the StoragePlugin contract. Reads the
    structured botocore error code, not exception names/messages."""
    return _error_code(e) in ("NoSuchKey", "NotFound", "404")


_TRANSIENT_S3_CODES = frozenset(
    {
        "SlowDown",
        "InternalError",
        "RequestTimeout",
        "ServiceUnavailable",
        "Throttling",
        "ThrottlingException",
        "RequestLimitExceeded",
        "500",
        "502",
        "503",
        "504",
    }
)


def _is_transient(e: Exception) -> bool:
    resp = getattr(e, "response", None)
    if isinstance(resp, dict):
        code = resp.get("Error", {}).get("Code")
        if code in _TRANSIENT_S3_CODES:
            return True
        # Absence is never transient; other structured errors (access
        # denied, validation) are permanent too.
        return False
    try:
        # Real network faults from aiobotocore are botocore exception types
        # (EndpointConnectionError/ConnectTimeoutError subclass botocore's
        # ConnectionError; ReadTimeoutError subclasses HTTPClientError) —
        # NOT the Python builtins, which the fallback below covers for
        # non-boto transports and fakes.
        from botocore.exceptions import (  # type: ignore[import-not-found]
            ConnectionError as BotoConnectionError,
            HTTPClientError,
        )

        if isinstance(e, (BotoConnectionError, HTTPClientError)):
            return True
    except ImportError:
        pass
    return isinstance(e, (ConnectionError, TimeoutError))

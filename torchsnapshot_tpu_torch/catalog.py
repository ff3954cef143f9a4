"""Per-bucket snapshot catalog: the lifecycle layer of continuous checkpointing.

A port of ``torchsnapshot_tpu/catalog.py``, with the same on-disk layout, so
a catalog written by either package is read by the other. A training job
that checkpoints every few steps into one bucket needs three answers no
single snapshot carries: which snapshots exist, how they chain, and which
may be deleted.

- **Catalog.** One small JSON record per committed snapshot under
  ``<bucket>/.catalog/records/<job>/`` (job, step, wall time, base, chain
  length, bytes total / written / deduped), written by rank 0 after
  ``.snapshot_metadata`` lands and before the commit barrier releases, so a
  record implies a committed snapshot. Each record is one atomic object
  write, so concurrent jobs append without a read-modify-write race. The
  catalog is advisory: :meth:`Catalog.rebuild` re-derives records from the
  bucket, and a lost record only drops its snapshot out of its chain.

- **Managed delta chains.** ``Snapshot.take(..., job=...)`` without
  ``base=`` takes the latest committed same-job snapshot as its base, unless
  that one's chain is already ``max_chain_len`` deltas deep: the take then
  rebases to a full snapshot. Rank 0 resolves the base inside the take's
  preflight round, whose broadcast gives every rank the same base; a
  per-process chain cache makes the steady-state lookup free of storage
  I/O.

- **Retention.** Policies (keep the last K, the newest of each of the last H
  hours or D days, pins) computed per job over the catalog; the retained
  set is ``Snapshot.gc``'s keep set. Collecting any condemned prefix of a
  chain never breaks a retained snapshot: incremental dedup hard-links
  shared objects under every snapshot root, so each committed snapshot is
  physically self-contained and a delta never reads through its base.
  :func:`validate_chain_closure` re-checks that against the retained
  manifests before anything is deleted.

Crash convergence of ``Snapshot.gc``: a condemned snapshot goes in a fixed
order, ``.snapshot_metadata`` first (it stops being restorable at once),
then its data tree, then its catalog record. A crash anywhere leaves either
a committed snapshot or an uncommitted tree whose record marks it as a
half-collected *zombie*, which the next run finishes; re-running converges
to the retained set.

The per-step telemetry records the JAX package keeps beside the catalog
records come with the port's telemetry; their directory is named here
(:data:`STEP_TELEMETRY_DIR`) so ``Snapshot.gc`` collects them with their
snapshot in a JAX-written bucket, as the JAX package does.
"""

from __future__ import annotations

import asyncio
import fnmatch
import hashlib
import json
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from . import telemetry
from .io_types import ReadIO, StoragePlugin, WriteIO
from .manifest import SNAPSHOT_METADATA_FNAME, SnapshotMetadata
from .storage_plugin import url_to_storage_plugin
from .utils import knobs

logger = logging.getLogger(__name__)

# Everything the catalog owns lives under this prefix of the bucket.
CATALOG_DIR = ".catalog"
RECORD_DIR = f"{CATALOG_DIR}/records"
PIN_DIR = f"{CATALOG_DIR}/pins"
# Per-step telemetry records (``telemetry/steprecord.py``), collected with
# their snapshot's record, and the per-rank rollout (restore) records.
STEP_TELEMETRY_DIR = f"{CATALOG_DIR}/telemetry"
ROLLOUT_TELEMETRY_DIR = f"{CATALOG_DIR}/rollouts"

# Loaders skip records of a newer schema and accept older ones.
CATALOG_SCHEMA_VERSION = 1

# The ``base=`` sentinel a ``job=`` take carries into planning: "resolve the
# base from the catalog on rank 0 during preflight". Never a storage URL.
_AUTO_BASE_SCHEME = "catalog-auto://"

# Per-process chain cache: (bucket_url, job) -> (snapshot name, chain_len)
# of the latest same-job snapshot this process committed or looked up.
# Retention invalidates a bucket's entries; a stale entry is still safe
# (a vanished base degrades the take to a full snapshot).
_CHAIN_CACHE: Dict[Tuple[str, str], Tuple[str, int]] = {}


# ---------------------------------------------------------------------------
# Bucket and path plumbing
# ---------------------------------------------------------------------------


def split_bucket(path: str) -> Optional[Tuple[str, str]]:
    """``(bucket_url, snapshot_name)`` of a snapshot path or URL: the
    bucket is the parent prefix, where the catalog lives. None when the path
    has no parent (a snapshot at a file system or bucket root goes
    unrecorded)."""
    if "://" in path:
        proto, _, rest = path.partition("://")
        rest = rest.rstrip("/")
        if "/" not in rest or not rest:
            return None
        parent, _, name = rest.rpartition("/")
        if not parent or not name:
            return None
        return f"{proto}://{parent}", name
    p = os.path.abspath(path).rstrip("/")
    parent, name = os.path.split(p)
    if not name or parent in ("", "/", p):
        return None
    return parent, name


def join_bucket(bucket_url: str, name: str) -> str:
    """Inverse of :func:`split_bucket`."""
    return f"{bucket_url.rstrip('/')}/{name}"


def _slug(text: str) -> str:
    """A file-name-safe token for ``text``: ``[A-Za-z0-9_-]`` kept, and a
    short hash appended whenever anything was replaced, so two jobs never
    share a record directory."""
    safe = re.sub(r"[^A-Za-z0-9_\-]", "_", text) or "_"
    if safe != text:
        safe = f"{safe}-{hashlib.sha1(text.encode()).hexdigest()[:8]}"
    return safe


def _name_key(name: str) -> str:
    """Token of a snapshot name in record and pin names: a re-taken name
    overwrites its record instead of adding one."""
    return hashlib.sha1(name.encode()).hexdigest()[:12]


def record_path(job: str, name: str, step: int) -> str:
    """Bucket-relative path of one snapshot's record: per job (one prefix
    scan lists a job), the step zero-padded so lexical order is step order."""
    return f"{RECORD_DIR}/{_slug(job)}/{max(0, int(step)):020d}-{_name_key(name)}.json"


def pin_path(name: str) -> str:
    return f"{PIN_DIR}/{_name_key(name)}.json"


def step_record_path(job: str, name: str, step: int) -> str:
    """One snapshot's step-telemetry record: :func:`record_path`'s layout
    under :data:`STEP_TELEMETRY_DIR`."""
    return f"{STEP_TELEMETRY_DIR}/{_slug(job)}/{max(0, int(step)):020d}-{_name_key(name)}.json"


def rollout_record_path(job: str, name: str, step: Optional[int], rank: int) -> str:
    """One rank's rollout record of a restore, under
    :data:`ROLLOUT_TELEMETRY_DIR` (per rank: no barrier elects a merger)."""
    return (
        f"{ROLLOUT_TELEMETRY_DIR}/{_slug(job)}/"
        f"{max(0, int(step or 0)):020d}-{_name_key(name)}_r{int(rank)}.json"
    )


def _run(coro, loop: Optional[asyncio.AbstractEventLoop]):
    if loop is not None:
        return loop.run_until_complete(coro)
    inner = asyncio.new_event_loop()
    try:
        return inner.run_until_complete(coro)
    finally:
        inner.close()


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


@dataclass
class CatalogRecord:
    """One committed snapshot, as the catalog knows it.

    ``bytes_total`` is every storage object's size, from the snapshot's own
    checksum sidecars; ``bytes_deduped`` the share whose content identity
    (whole-object sha256 or tree root) the base's sidecars also hold, i.e.
    bytes the chain shares; ``bytes_written`` the rest. All three are 0 when
    the sidecars could not be read."""

    name: str
    job: str
    step: int
    wall_time: float
    base: Optional[str] = None  # the base's name (same bucket) or path
    chain_len: int = 0  # 0: a full snapshot; k: the k-th delta of its chain
    world_size: int = 1
    bytes_total: int = 0
    bytes_written: int = 0
    bytes_deduped: int = 0
    schema: int = CATALOG_SCHEMA_VERSION
    # The bucket-relative object this record was loaded from or appended
    # to. Not serialized.
    path: Optional[str] = field(default=None, compare=False)

    def to_json(self) -> str:
        return json.dumps(
            {
                "schema": self.schema,
                "name": self.name,
                "job": self.job,
                "step": self.step,
                "wall_time": self.wall_time,
                "base": self.base,
                "chain_len": self.chain_len,
                "world_size": self.world_size,
                "bytes_total": self.bytes_total,
                "bytes_written": self.bytes_written,
                "bytes_deduped": self.bytes_deduped,
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, s: str) -> "CatalogRecord":
        d = json.loads(s)
        if not isinstance(d, dict):
            raise ValueError("catalog record is not a JSON object")
        return cls(
            name=str(d["name"]),
            job=str(d.get("job", "")),
            step=int(d.get("step", -1)),
            wall_time=float(d.get("wall_time", 0.0)),
            base=d.get("base"),
            chain_len=int(d.get("chain_len", 0)),
            world_size=int(d.get("world_size", 1)),
            bytes_total=int(d.get("bytes_total", 0)),
            bytes_written=int(d.get("bytes_written", 0)),
            bytes_deduped=int(d.get("bytes_deduped", 0)),
            schema=int(d.get("schema", 1)),
        )

    @property
    def order_key(self) -> Tuple[int, float, str]:
        """Recency within one job: step, then wall time, then name."""
        return (self.step, self.wall_time, self.name)


class Catalog:
    """Handle on one bucket's catalog, through the same storage plugin
    stack snapshots use, on the caller's event loop or a private one.
    ``close()`` releases the plugin."""

    def __init__(
        self,
        bucket_url: str,
        event_loop: Optional[asyncio.AbstractEventLoop] = None,
        storage: Optional[StoragePlugin] = None,
    ) -> None:
        self.bucket_url = bucket_url
        self._own_loop = event_loop is None
        self._loop = event_loop or asyncio.new_event_loop()
        self._own_storage = storage is None
        self._storage = storage or url_to_storage_plugin(bucket_url)
        # Records the last load() could not read (retention over-retains).
        self.last_scan_skipped = 0

    def close(self) -> None:
        if self._own_storage:
            self._storage.sync_close(self._loop)
        if self._own_loop:
            self._loop.close()

    def __enter__(self) -> "Catalog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def append(self, record: CatalogRecord) -> bool:
        """Write one record (one atomic object). Returns False on any
        failure: the catalog is fail-open, a missed append degrades the
        chain and retention view, never the commit beside it."""
        path = record_path(record.job, record.name, record.step)
        try:
            with telemetry.span("catalog.append", cat="catalog", path=path):
                self._storage.sync_write(WriteIO(path=path, buf=record.to_json().encode()), self._loop)
            record.path = path
            telemetry.counter_add("catalog.appends")
            return True
        except Exception:  # noqa: BLE001 - fail-open by contract
            telemetry.counter_add("catalog.append_failures")
            logger.warning(
                "catalog append for %s under %s failed (snapshot commit "
                "unaffected; Catalog.rebuild can reconstruct the record)",
                record.name,
                self.bucket_url,
                exc_info=True,
            )
            return False

    def load(self, job: Optional[str] = None) -> List[CatalogRecord]:
        """Every readable record, oldest first by ``order_key``, one per
        snapshot name (the newest wins). Unreadable and newer-schema records
        are skipped with a warning; ``job=`` filters on the record body."""
        prefix = RECORD_DIR if job is None else f"{RECORD_DIR}/{_slug(job)}"
        self.last_scan_skipped = 0
        with telemetry.span("catalog.scan", cat="catalog", path=prefix):
            paths = _run(self._storage.list_prefix(prefix), self._loop)
            by_name: Dict[str, CatalogRecord] = {}
            for p in sorted(paths):
                if not p.endswith(".json"):
                    continue
                rec = self._read_record(p)
                if rec is None:
                    self.last_scan_skipped += 1
                    continue
                if job is not None and rec.job != job:
                    continue
                prev = by_name.get(rec.name)
                if prev is None or rec.order_key >= prev.order_key:
                    by_name[rec.name] = rec
        records = sorted(by_name.values(), key=lambda r: r.order_key)
        telemetry.counter_add("catalog.records_scanned", len(records))
        return records

    # -- step telemetry and rollout records ------------------------------------
    def _write_json(self, path: str, payload: bytes, kind: str) -> bool:
        """One fail-open record write (span ``catalog.<kind>_append``,
        counters ``catalog.<kind>_appends`` / ``_append_failures``): a
        missed record loses one point of a trend line, never the commit or
        restore beside it."""
        try:
            with telemetry.span(f"catalog.{kind}_append", cat="catalog", path=path):
                self._storage.sync_write(WriteIO(path=path, buf=payload), self._loop)
            telemetry.counter_add(f"catalog.{kind}_appends")
            return True
        except Exception:  # noqa: BLE001 - fail-open by contract
            telemetry.counter_add(f"catalog.{kind}_append_failures")
            logger.warning("%s record %s under %s not written (unaffected)", kind, path, self.bucket_url, exc_info=True)
            return False

    def _read_json_records(self, prefix: str, span: str, parse) -> List[Dict[str, Any]]:
        """Every readable record under ``prefix`` (sorted paths); an
        unreadable one is skipped with a warning."""
        out: List[Dict[str, Any]] = []
        with telemetry.span(span, cat="catalog", path=prefix):
            try:
                paths = _run(self._storage.list_prefix(prefix), self._loop)
            except FileNotFoundError:
                return []
            for p in sorted(paths):
                if not p.endswith(".json"):
                    continue
                try:
                    read_io = ReadIO(path=p)
                    self._storage.sync_read(read_io, self._loop)
                    out.append(parse(bytes(read_io.buf)))
                except Exception:  # noqa: BLE001 - degrade, never fail
                    logger.warning("unreadable record %s under %s (skipped)", p, self.bucket_url, exc_info=True)
        return out

    def append_step_telemetry(self, record: Dict[str, Any]) -> bool:
        """Write one step-telemetry record (``steprecord.build_step_record``)
        beside the snapshot's catalog record; fail-open."""
        from .telemetry import steprecord

        path = step_record_path(str(record.get("job", "")), str(record.get("name", "")), int(record.get("step", 0)))
        return self._write_json(path, steprecord.dumps_step_record(record), "step")

    def load_step_telemetry(self, job: Optional[str] = None) -> List[Dict[str, Any]]:
        """The step series: every readable record in step order, one per
        snapshot name (the latest wins); ``job=`` filters on the body."""
        from .telemetry import steprecord

        prefix = STEP_TELEMETRY_DIR if job is None else f"{STEP_TELEMETRY_DIR}/{_slug(job)}"
        by_name: Dict[str, Dict[str, Any]] = {}
        for rec in self._read_json_records(prefix, "catalog.step_scan", steprecord.parse_step_record):
            if job is not None and rec.get("job") != job:
                continue
            key = str(rec.get("name"))
            prev = by_name.get(key)
            if prev is None or (rec.get("step", 0), rec.get("created_unix", 0.0)) >= (
                prev.get("step", 0),
                prev.get("created_unix", 0.0),
            ):
                by_name[key] = rec
        return sorted(by_name.values(), key=lambda r: (r.get("step", 0), r.get("created_unix", 0.0)))

    def append_rollout_record(self, record: Dict[str, Any]) -> bool:
        """Write one rank's rollout record
        (``steprecord.build_rollout_record``); fail-open."""
        from .telemetry import steprecord

        path = rollout_record_path(
            str(record.get("job", "")), str(record.get("name", "")), record.get("step"), int(record.get("rank", 0) or 0)
        )
        return self._write_json(path, steprecord.dumps_rollout_record(record), "rollout")

    def load_rollout_telemetry(self, job: Optional[str] = None) -> List[Dict[str, Any]]:
        """Every readable rollout record, in (step, rank, created) order;
        per-rank records are not merged."""
        from .telemetry import steprecord

        prefix = ROLLOUT_TELEMETRY_DIR if job is None else f"{ROLLOUT_TELEMETRY_DIR}/{_slug(job)}"
        out = [
            r
            for r in self._read_json_records(prefix, "catalog.rollout_scan", steprecord.parse_rollout_record)
            if job is None or r.get("job") == job
        ]
        return sorted(out, key=lambda r: (r.get("step") or 0, r.get("rank", 0), r.get("created_unix", 0.0)))

    def _read_record(self, path: str) -> Optional[CatalogRecord]:
        try:
            read_io = ReadIO(path=path)
            self._storage.sync_read(read_io, self._loop)
            rec = CatalogRecord.from_json(bytes(read_io.buf).decode())
        except Exception:  # noqa: BLE001 - degrade, never fail a scan
            logger.warning(
                "unreadable catalog record %s under %s (skipped)", path, self.bucket_url, exc_info=True
            )
            return None
        if rec.schema > CATALOG_SCHEMA_VERSION:
            logger.warning(
                "catalog record %s has schema %d > supported %d (skipped; upgrade this reader)",
                path,
                rec.schema,
                CATALOG_SCHEMA_VERSION,
            )
            return None
        rec.path = path
        return rec

    def latest(self, job: str) -> Optional[CatalogRecord]:
        records = self.load(job=job)
        return records[-1] if records else None

    def pins(self) -> Set[str]:
        """Names of the pinned snapshots, which no policy condemns."""
        out: Set[str] = set()
        try:
            for p in _run(self._storage.list_prefix(PIN_DIR), self._loop):
                try:
                    read_io = ReadIO(path=p)
                    self._storage.sync_read(read_io, self._loop)
                    out.add(str(json.loads(bytes(read_io.buf))["name"]))
                except Exception:  # noqa: BLE001 - skip an unreadable pin
                    logger.warning("unreadable pin %s (skipped)", p)
        except Exception:  # noqa: BLE001 - no pin directory: no pins
            pass
        return out

    def pin(self, name: str) -> None:
        self._storage.sync_write(
            WriteIO(path=pin_path(name), buf=json.dumps({"name": name}).encode()), self._loop
        )

    def unpin(self, name: str) -> bool:
        try:
            _run(self._storage.delete(pin_path(name)), self._loop)
            return True
        except FileNotFoundError:
            return False

    def rebuild(self) -> List[CatalogRecord]:
        """Records for the committed snapshots no readable record names,
        found by scanning the bucket: job ``""``, the step parsed from the
        name's trailing digits, wall time and base unknown. Existing
        records are never rewritten. Returns the records written. A
        ``memory://`` bucket cannot be scanned (its snapshots live in other
        stores) and gets none."""
        existing = {r.name for r in self.load()}
        written: List[CatalogRecord] = []
        try:
            all_paths = _run(self._storage.list_prefix(""), self._loop)
        except Exception:  # noqa: BLE001 - an unlistable bucket: nothing to do
            logger.warning("catalog rebuild: cannot list %s", self.bucket_url, exc_info=True)
            return []
        roots = sorted({p.partition("/")[0] for p in all_paths if "/" in p and not p.startswith(f"{CATALOG_DIR}/")})
        for root in roots:
            if root in existing:
                continue
            meta_path = f"{root}/{SNAPSHOT_METADATA_FNAME}"
            if meta_path not in all_paths:
                continue
            try:
                read_io = ReadIO(path=meta_path)
                self._storage.sync_read(read_io, self._loop)
                metadata = SnapshotMetadata.from_json(bytes(read_io.buf).decode())
            except Exception:  # noqa: BLE001 - torn metadata: skip
                logger.warning("catalog rebuild: unreadable metadata for %s (skipped)", root, exc_info=True)
                continue
            m = re.search(r"(\d+)$", root)
            rec = CatalogRecord(
                name=root,
                job="",
                step=int(m.group(1)) if m else -1,
                wall_time=0.0,
                base=None,
                chain_len=0,
                world_size=metadata.world_size,
            )
            if self.append(rec):
                written.append(rec)
        return written


# ---------------------------------------------------------------------------
# Auto-base selection (managed delta chains)
# ---------------------------------------------------------------------------


def auto_base_token(job: str, max_chain_len: int) -> str:
    """The ``base=`` sentinel of a ``job=`` take, resolved on rank 0 in the
    preflight round."""
    return f"{_AUTO_BASE_SCHEME}{max(1, int(max_chain_len))}/{job}"


def is_auto_base(base: Optional[str]) -> bool:
    return bool(base) and str(base).startswith(_AUTO_BASE_SCHEME)


def parse_auto_base(token: str) -> Tuple[str, int]:
    """``(job, max_chain_len)`` of an auto-base token."""
    rest = token[len(_AUTO_BASE_SCHEME) :]
    max_str, _, job = rest.partition("/")
    return job, max(1, int(max_str))


def note_commit(bucket_url: str, job: str, name: str, chain_len: int) -> None:
    """Cache a just-committed snapshot as its job's chain head, so the next
    same-job take selects it without storage I/O (every rank)."""
    _CHAIN_CACHE[(bucket_url, job)] = (name, chain_len)


def invalidate_chain_cache(bucket_url: str) -> None:
    """Drop the bucket's cached chain heads (retention may have condemned
    them); the next take reads the catalog."""
    for key in [k for k in _CHAIN_CACHE if k[0] == bucket_url]:
        _CHAIN_CACHE.pop(key, None)


def resolve_auto_base(token: str, snapshot_path: str) -> Tuple[Optional[str], int]:
    """``(base path or None, the base's chain length)`` for an auto-base
    token, from the catalog of ``snapshot_path``'s bucket: the latest
    committed same-job snapshot (from the chain cache when warm, else a
    catalog scan that probes the newest three records for their metadata).
    ``(None, 0)``, a full take, when ``TSS_TORCH_CATALOG`` is off, the
    bucket has no same-job record, the candidate's chain is already
    ``max_chain_len`` deep, or anything fails."""
    try:
        job, max_chain = parse_auto_base(token)
    except Exception:  # noqa: BLE001 - a malformed token: full snapshot
        logger.warning("malformed auto-base token %r; taking a full snapshot", token)
        return None, 0
    if not knobs.is_catalog_enabled():
        return None, 0
    split = split_bucket(snapshot_path)
    if split is None:
        return None, 0
    bucket, _name = split
    cached = _CHAIN_CACHE.get((bucket, job))
    if cached is not None:
        name, chain_len = cached
        if chain_len + 1 > max_chain:
            logger.info(
                "job %s: chain at %s is %d deltas deep (max %d); rebasing to a full snapshot",
                job, name, chain_len, max_chain,
            )
            return None, 0
        return join_bucket(bucket, name), chain_len
    try:
        with Catalog(bucket) as cat:
            records = cat.load(job=job)
        for rec in list(reversed(records))[:3]:
            if _metadata_exists(join_bucket(bucket, rec.name)):
                note_commit(bucket, job, rec.name, rec.chain_len)
                if rec.chain_len + 1 > max_chain:
                    logger.info(
                        "job %s: chain at %s is %d deltas deep (max %d); rebasing to a full snapshot",
                        job, rec.name, rec.chain_len, max_chain,
                    )
                    return None, 0
                return join_bucket(bucket, rec.name), rec.chain_len
    except Exception:  # noqa: BLE001 - fail-open: full snapshot
        logger.warning(
            "auto-base selection for job %s under %s failed; taking a full snapshot",
            job, snapshot_path, exc_info=True,
        )
    return None, 0


def chain_len_of_base(bucket_url: str, base: str) -> int:
    """The chain length a snapshot takes on by building on ``base`` (an
    explicit ``base=``): the base's recorded chain + 1, or 1 when the base
    is unrecorded or outside the bucket (an unknown base counts as full)."""
    split = split_bucket(base)
    if split is None or split[0] != bucket_url:
        return 1
    try:
        with Catalog(bucket_url) as cat:
            for rec in reversed(cat.load()):
                if rec.name == split[1]:
                    return rec.chain_len + 1
    except Exception:  # noqa: BLE001 - an unknown base counts as full
        pass
    return 1


def _metadata_exists(snapshot_url: str) -> bool:
    loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin(snapshot_url)
        try:
            storage.sync_read(ReadIO(path=SNAPSHOT_METADATA_FNAME), loop)
            return True
        except Exception:  # noqa: BLE001 - absent or unreadable: not usable
            return False
        finally:
            storage.sync_close(loop)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# Byte attribution, from the checksum sidecars
# ---------------------------------------------------------------------------


def byte_attribution(
    storage: StoragePlugin,
    world_size: int,
    base_url: Optional[str],
    event_loop: asyncio.AbstractEventLoop,
) -> Tuple[int, int, int]:
    """``(bytes_total, bytes_written, bytes_deduped)`` of a just-committed
    snapshot: totals from its sidecars; deduped are the objects whose
    (size, content key) the base's sidecars also hold. Rank 0 alone, no
    collective. ``(0, 0, 0)`` when the sidecars cannot be read."""
    from . import hashing
    from .snapshot import _read_checksum_sidecars

    try:
        merged, _ = _read_checksum_sidecars(storage, world_size, event_loop)
    except Exception:  # noqa: BLE001 - attribution is best-effort
        return 0, 0, 0
    base_keys: Set[Tuple[int, str]] = set()
    if base_url:
        loop = asyncio.new_event_loop()
        try:
            base_storage = url_to_storage_plugin(base_url)
            try:
                read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
                base_storage.sync_read(read_io, loop)
                base_world = SnapshotMetadata.from_json(bytes(read_io.buf).decode()).world_size
                base_merged, _ = _read_checksum_sidecars(base_storage, base_world, loop)
                for rec in base_merged.values():
                    size = hashing.record_size(rec)
                    if size is None:
                        continue
                    for key in hashing.record_content_keys(rec):
                        base_keys.add((size, key))
            finally:
                base_storage.sync_close(loop)
        except Exception:  # noqa: BLE001 - no view of the base: all bytes new
            base_keys = set()
        finally:
            loop.close()
    total = written = deduped = 0
    for rec in merged.values():
        size = hashing.record_size(rec)
        if size is None:
            continue
        total += size
        if base_keys and any((size, key) in base_keys for key in hashing.record_content_keys(rec)):
            deduped += size
        else:
            written += size
    return total, written, deduped


# ---------------------------------------------------------------------------
# Retention
# ---------------------------------------------------------------------------


@dataclass
class RetentionPolicy:
    """A retention policy, applied per job. Grammar: comma-separated
    ``key=value`` clauses::

        last=<K>      keep the newest K snapshots of each job
        hourly=<H>    and the newest snapshot of each of the last H distinct
                      hours (by record wall time)
        daily=<D>     and of each of the last D distinct days
        job=<glob>    apply to matching jobs only (others are kept whole);
                      repeatable

    Pinned snapshots are always kept. No clause keeps everything."""

    last: Optional[int] = None
    hourly: Optional[int] = None
    daily: Optional[int] = None
    job_globs: List[str] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "RetentionPolicy":
        policy = cls()
        spec = (spec or "").strip()
        if not spec:
            return policy
        for clause in spec.split(","):
            clause = clause.strip()
            if not clause:
                continue
            key, sep, value = clause.partition("=")
            if not sep:
                raise ValueError(f"retention clause {clause!r} is not key=value")
            key = key.strip()
            value = value.strip()
            if key in ("last", "hourly", "daily"):
                try:
                    count = int(value)
                except ValueError:
                    raise ValueError(f"retention clause {clause!r}: {value!r} is not an integer") from None
                if count < 0:
                    raise ValueError(f"retention clause {clause!r}: negative counts are meaningless")
                setattr(policy, key, count)
            elif key == "job":
                policy.job_globs.append(value)
            else:
                raise ValueError(
                    f"unknown retention clause {key!r} (grammar: last=K, hourly=H, daily=D, job=<glob>)"
                )
        return policy

    def applies_to(self, job: str) -> bool:
        if not self.job_globs:
            return True
        return any(fnmatch.fnmatch(job, g) for g in self.job_globs)

    def retained(self, records: List[CatalogRecord], now: Optional[float] = None) -> Set[str]:
        """Names kept of ONE job's records (any order)."""
        ordered = sorted(records, key=lambda r: r.order_key, reverse=True)
        if self.last is None and self.hourly is None and self.daily is None:
            return {r.name for r in ordered}
        keep: Set[str] = set()
        if self.last:
            keep.update(r.name for r in ordered[: self.last])
        for clause, bucket_s in (("hourly", 3600), ("daily", 86400)):
            count = getattr(self, clause)
            if not count:
                continue
            seen_buckets: Set[int] = set()
            for r in ordered:  # newest first: the first of each bucket wins
                if r.wall_time <= 0:
                    continue  # a rebuilt record has no wall clock
                b = int(r.wall_time // bucket_s)
                if b not in seen_buckets:
                    seen_buckets.add(b)
                    keep.add(r.name)
                if len(seen_buckets) >= count:
                    break
        return keep


@dataclass
class RetentionPlan:
    """What a policy run keeps and collects."""

    retained: List[str]
    condemned: List[str]
    pinned: List[str]
    by_job: Dict[str, Dict[str, List[str]]]


def plan_retention(
    records: List[CatalogRecord],
    pins: Set[str],
    policy: RetentionPolicy,
    now: Optional[float] = None,
) -> RetentionPlan:
    """``policy`` applied per job over the records; pins and jobs outside
    the policy's globs are kept. Any prefix of a chain may be condemned:
    snapshots are self-contained."""
    by_job: Dict[str, List[CatalogRecord]] = {}
    for r in records:
        by_job.setdefault(r.job, []).append(r)
    retained: Set[str] = set()
    per_job: Dict[str, Dict[str, List[str]]] = {}
    for job, recs in sorted(by_job.items()):
        kept = {r.name for r in recs} if not policy.applies_to(job) else policy.retained(recs, now=now)
        kept |= pins & {r.name for r in recs}
        retained |= kept
        per_job[job] = {"retained": sorted(kept), "condemned": sorted({r.name for r in recs} - kept)}
    all_names = {r.name for r in records}
    return RetentionPlan(
        retained=sorted(retained),
        condemned=sorted(all_names - retained),
        pinned=sorted(pins & all_names),
        by_job=per_job,
    )


def validate_chain_closure(bucket_url: str, retained: List[str], condemned: List[str]) -> None:
    """The check before any retention deletion: every object a RETAINED
    snapshot's manifest references must lie under its own root (never an
    absolute or parent-escaping location, never under a condemned root).
    Raises ``RuntimeError`` naming the violations, or when a retained
    snapshot's manifest cannot be read."""
    from .snapshot import _manifest_storage_locations

    condemned_set = set(condemned)
    violations: List[str] = []
    loop = asyncio.new_event_loop()
    try:
        for name in retained:
            try:
                storage = url_to_storage_plugin(join_bucket(bucket_url, name))
                try:
                    read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
                    storage.sync_read(read_io, loop)
                    metadata = SnapshotMetadata.from_json(bytes(read_io.buf).decode())
                finally:
                    storage.sync_close(loop)
            except Exception:  # noqa: BLE001 - an unreadable retained manifest
                raise RuntimeError(
                    f"retention: cannot read the manifest of retained snapshot {name!r} "
                    f"under {bucket_url} — refusing to collect anything"
                ) from None
            for loc in _manifest_storage_locations(metadata.manifest):
                if loc.startswith(("/", "..")) or any(loc.startswith(f"{c}/") for c in condemned_set):
                    violations.append(f"{name}: {loc}")
    finally:
        loop.close()
    if violations:
        raise RuntimeError(
            "retention: retained snapshots reference objects outside their own roots "
            "(collecting the condemned set would tear them): " + "; ".join(sorted(violations)[:8])
        )


def retain(
    bucket_url: str,
    policy: RetentionPolicy,
    dry_run: bool = True,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """Plan retention over the catalog, validate chain closure, and drive
    ``Snapshot.gc`` with the retained set as its keep set. Only recorded
    snapshots are condemned; uncommitted trees without a record (maybe a
    take in flight) are left alone, which makes this safe beside takes into
    the same bucket. Returns gc's report with the plan under ``policy``."""
    from .snapshot import Snapshot

    with Catalog(bucket_url) as cat:
        records = cat.load()
        pins = cat.pins()
        skipped = cat.last_scan_skipped
    if skipped:
        logger.warning(
            "retention under %s: %d catalog record(s) unreadable — their snapshots are "
            "implicitly retained this run (rebuild the catalog to reclaim them)",
            bucket_url,
            skipped,
        )
    plan = plan_retention(records, pins, policy, now=now)
    if plan.condemned:
        validate_chain_closure(bucket_url, plan.retained, plan.condemned)
    report = Snapshot.gc(
        bucket_url,
        dry_run=dry_run,
        keep_roots=set(plan.retained) | pins,
        roots=[r.name for r in records],
        collect_debris=False,
    )
    report["policy"] = {
        "retained": plan.retained,
        "condemned": plan.condemned,
        "pinned": plan.pinned,
        "by_job": plan.by_job,
    }
    if not dry_run:
        telemetry.counter_add("gc.roots_condemned", len(plan.condemned))
        invalidate_chain_cache(bucket_url)
    return report


def chain_of(records: List[CatalogRecord], name: str) -> List[CatalogRecord]:
    """The base chain ending at ``name``, oldest first, as far back as the
    records reach (for display; restore never walks it)."""
    by_name = {r.name: r for r in records}
    chain: List[CatalogRecord] = []
    cur = by_name.get(name)
    seen: Set[str] = set()
    while cur is not None and cur.name not in seen:
        seen.add(cur.name)
        chain.append(cur)
        cur = by_name.get(cur.base) if cur.base else None
    return list(reversed(chain))

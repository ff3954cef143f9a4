"""Deterministic fault injection for storage plugins.

:class:`FaultyStoragePlugin` wraps any :class:`~.io_types.StoragePlugin`
and injects faults from a seeded spec, so the chaos tests can replay the
same torn write, transient storm, stall, process kill or bit rot on fs,
memory and cloud backends alike. Installed by the ``TSS_TORCH_FAULTS``
knob: ``url_to_storage_plugin`` then wraps every plugin it builds, and
child ranks inherit the variable, so one string drives a whole fleet.
Unset, this module is never imported.

Spec grammar (rules separated by ``;``, fields by ``,``)::

    TSS_TORCH_FAULTS = "rule[;rule...]"
    rule  = seed=<int>                      # the RNG's seed (default 0)
          | backoff=<float>                 # transient-retry base backoff (s)
          | window=<float>                  # collective-progress window (s)
          | op=<op>[,<field>=<value>...]    # one injection rule

    op    = write | read | delete | stream_open | append | commit | abort
          | link | list | peer_serve | any
          | catalog_append | steprecord_append | cache_bitmap | beacon

    ``catalog_append`` / ``steprecord_append`` are derived write classes:
    they fire at plugin writes under ``.catalog/records/`` and
    ``.catalog/telemetry/``, so a kill point can target the lifecycle
    layer's publishes without counting data writes; only rules naming them
    match (``op=any`` does not). ``cache_bitmap`` (the read cache's bitmap
    rename) and ``beacon`` (the fleet beacon's publish) sit below or beside
    the wrapper and are driven through :func:`maybe_inject_local`.
    ``peer_serve`` fires in the swarm restore just before a rank posts a
    fetched chunk for its peers: ``stall`` delays the post past the chunk
    deadline, ``kill`` is peer death mid-serve, ``corrupt`` flips bytes of
    the posted copy only, ``fail``/``transient`` are a failed serve.

    kind  = transient  raise a retryable error (retried here, cloud_retry)
          | fail       raise a permanent InjectedFault
          | torn       transfer `bytes` bytes, then fail WITHOUT abort
          |            (a crash: atomic backends expose nothing, fs leaves
          |            a temp file for gc)
          | stall      sleep `secs` seconds before the op
          | kill       os._exit the process at the op (preemption)
          | corrupt    read ops: the read SUCCEEDS with `bytes` bytes
          |            (default 1) flipped at seeded offsets: silent bit
          |            rot, which only digest verification catches

    fields:
      at=<k>        inject at the k-th op of this class (0-based; once)
      after=<k>     inject on every op of this class with index >= k
      every=<n>     inject on every n-th op of this class
      p=<float>     inject with this probability (seeded)
      times=<n>     cap this rule's injections (default 1 for `at`)
      rank=<r>      only on this rank (the coordinator's rank)
      path=<substr> only on ops whose path contains this substring
      bytes=<k>     torn: bytes transferred first; corrupt: bytes flipped
      chunk=<k>     corrupt only: flip inside hash chunk k's extent
                    ([k*grain, (k+1)*grain) of the object, grain =
                    TSS_TORCH_HASH_CHUNK_BYTES); a ranged read translates
                    it, a read not covering it is left intact
      secs=<f>      stall: the sleep

Every op class keeps its own counter on the wrapper; plugins are built
fresh per take and restore, so ``at=``/``every=`` schedules repeat run to
run. Retries count as new ops. The same seed and op sequence give the
same schedule and the same corrupt offsets as the JAX package's spec.
Each injection adds one to ``faults.<kind>``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import telemetry
from .io_types import ReadIO, StoragePlugin, StorageWriteStream, WriteIO
from .storage_plugins.cloud_retry import CollectiveProgress, retry_transient

logger = logging.getLogger(__name__)

_OPS = (
    "write",
    "read",
    "delete",
    "stream_open",
    "append",
    "commit",
    "abort",
    "link",
    "list",
    "peer_serve",
    "catalog_append",
    "steprecord_append",
    "cache_bitmap",
    "beacon",
    "any",
)

# Literals, so importing this module never pulls the catalog in; the tests
# hold them to ``catalog.RECORD_DIR`` and ``STEP_TELEMETRY_DIR``.
_CATALOG_RECORD_PREFIX = ".catalog/records/"
_STEP_TELEMETRY_PREFIX = ".catalog/telemetry/"

_DERIVED_WRITE_OPS = (
    ("catalog_append", _CATALOG_RECORD_PREFIX),
    ("steprecord_append", _STEP_TELEMETRY_PREFIX),
)
_DERIVED_OP_SET = frozenset(op for op, _ in _DERIVED_WRITE_OPS) | {"cache_bitmap"}
_KINDS = ("transient", "fail", "torn", "stall", "kill", "corrupt")

# Plugin surface proxied without an injection point: housekeeping where a
# fault proves nothing about crash consistency.
_PASSTHROUGH_OPS = ("prune_empty", "close")

# The port's commit points: every function under torchsnapshot_tpu_torch/
# that performs a durable mutation itself (os.replace/rename/link/remove/
# unlink, or a mutating call on a storage plugin), as
# "<file's basename>:<qualname>" (the static analyzer's TSA1004 key),
# pinned to the op class whose rules reach it. "fail-open" marks a site whose loss is harmless by contract
# (telemetry sidecars, read-cache entries the next read refills, build
# artifacts). tests/test_torch_isolation.py scans the package and holds
# this table to what it finds, in both directions.
_CRASH_SURFACE = (
    ("catalog.py:Catalog._write_json", "steprecord_append"),
    ("catalog.py:Catalog.append", "catalog_append"),
    ("catalog.py:Catalog.pin", "write"),
    ("catalog.py:Catalog.unpin", "delete"),
    ("kernels.py:_build", "fail-open"),  # the CUDA kernels' .so
    ("__init__.py:_build", "fail-open"),  # native/: the I/O engine's .so
    ("scheduler.py:_WritePipeline._link_from_base", "link"),
    ("scheduler.py:_WritePipeline._storage_write", "write"),
    ("scheduler.py:_WritePipeline._stream_one", "append"),
    ("scheduler.py:_WritePipeline.run_to_completion", "write"),
    ("snapshot.py:Snapshot.gc", "delete"),
    ("snapshot.py:_scrub_repair", "write"),
    ("snapshot.py:_write_snapshot_metadata", "write"),
    ("storage_plugin.py:write_telemetry_artifact", "write"),
    ("cache.py:CachedStoragePlugin._drop_entry", "fail-open"),
    ("cache.py:CachedStoragePlugin._maybe_evict", "fail-open"),
    ("cache.py:CachedStoragePlugin._read_entry", "fail-open"),
    ("cache.py:CachedStoragePlugin._replace_bitmap", "cache_bitmap"),
    ("cache.py:CachedStoragePlugin._write_entry", "fail-open"),
    ("cache.py:CachedStoragePlugin._write_entry_range", "fail-open"),
    ("cache.py:CachedStoragePlugin.quarantine_path", "fail-open"),
    ("fs.py:FSStoragePlugin._link_in_inner", "link"),
    ("fs.py:FSStoragePlugin._write_file", "write"),
    ("fs.py:FSStoragePlugin.delete", "delete"),
    ("fs.py:_FSWriteStream._abort_work", "abort"),
    ("fs.py:_FSWriteStream._commit_work", "commit"),
    ("gcs.py:_GCSWriteStream.commit", "commit"),
    ("s3.py:_S3WriteStream.commit", "commit"),
    # The A/B probe writes throwaway `.probe` objects outside any snapshot.
    ("stream_select.py:_probe_streamed", "fail-open"),
    ("stream_select.py:_probe_whole", "fail-open"),
    ("aggregate.py:write_merged_chrome_trace", "fail-open"),
    ("export.py:write_trace_obj", "fail-open"),
    ("recorder.py:FlightRecorder.dump", "fail-open"),
)

# The exit code of a `kill` fault: an injected death is told apart from a
# real crash.
KILL_EXIT_CODE = 87


class InjectedFault(RuntimeError):
    """A permanently failing injected fault (``kind=fail`` / ``kind=torn``)."""


class InjectedTransientFault(InjectedFault):
    """A retryable injected fault (``kind=transient``); the wrapper's own
    retry classifies exactly this type as transient."""


class FaultSpecError(ValueError):
    """The ``TSS_TORCH_FAULTS`` spec does not parse."""


@dataclass
class FaultRule:
    op: str
    kind: str
    at: Optional[int] = None
    after: Optional[int] = None
    every: Optional[int] = None
    p: Optional[float] = None
    times: Optional[int] = None
    rank: Optional[int] = None
    path: Optional[str] = None
    bytes: int = 0
    chunk: Optional[int] = None
    secs: float = 0.0
    injected: int = 0  # how often this rule has fired

    def matches(self, op: str, index: int, path: str, rng: random.Random, rank: int) -> bool:
        if self.op != "any" and self.op != op:
            return False
        if self.rank is not None and self.rank != rank:
            return False
        if self.path is not None and self.path not in path:
            return False
        limit = self.times if self.times is not None else (1 if self.at is not None else None)
        if limit is not None and self.injected >= limit:
            return False
        if self.at is not None:
            return index == self.at
        if self.after is not None:
            return index >= self.after
        if self.every is not None:
            return index % self.every == self.every - 1
        if self.p is not None:
            # One seeded draw per matching op.
            return rng.random() < self.p
        return True


@dataclass
class FaultPlan:
    rules: List[FaultRule] = field(default_factory=list)
    seed: int = 0
    backoff_s: Optional[float] = None
    window_s: Optional[float] = None


_INT_FIELDS = ("at", "after", "every", "times", "rank", "bytes", "chunk")
_FLOAT_FIELDS = ("p", "secs")


def parse_fault_spec(spec: str) -> FaultPlan:
    """Parse a ``TSS_TORCH_FAULTS`` string; any malformed input raises
    :class:`FaultSpecError` (a typo'd schedule must not inject nothing)."""
    plan = FaultPlan()
    for raw_rule in spec.split(";"):
        raw_rule = raw_rule.strip()
        if not raw_rule:
            continue
        fields: Dict[str, str] = {}
        for raw_field in raw_rule.split(","):
            key, sep, value = raw_field.partition("=")
            key = key.strip()
            if not sep or not key or not value.strip():
                raise FaultSpecError(
                    f"malformed field {raw_field!r} in rule {raw_rule!r} (expected key=value)"
                )
            if key in fields:
                raise FaultSpecError(f"duplicate field {key!r} in rule {raw_rule!r}")
            fields[key] = value.strip()
        try:
            if "op" not in fields:
                for key, value in fields.items():
                    if key == "seed":
                        plan.seed = int(value)
                    elif key == "backoff":
                        plan.backoff_s = float(value)
                    elif key == "window":
                        plan.window_s = float(value)
                    else:
                        raise FaultSpecError(
                            f"unknown global field {key!r} in {raw_rule!r} (rules need op=...)"
                        )
                continue
            op = fields.pop("op")
            if op not in _OPS:
                raise FaultSpecError(f"unknown op {op!r} (expected one of {', '.join(_OPS)})")
            kind = fields.pop("kind", None)
            if kind not in _KINDS:
                raise FaultSpecError(f"rule {raw_rule!r} needs kind= one of {', '.join(_KINDS)}")
            rule = FaultRule(op=op, kind=kind)
            for key, value in fields.items():
                if key in _INT_FIELDS:
                    setattr(rule, key, int(value))
                elif key in _FLOAT_FIELDS:
                    setattr(rule, key, float(value))
                elif key == "path":
                    rule.path = value
                else:
                    raise FaultSpecError(f"unknown field {key!r} in rule {raw_rule!r}")
        except FaultSpecError:
            raise
        except ValueError as e:
            raise FaultSpecError(f"bad value in rule {raw_rule!r}: {e}") from e
        if rule.kind == "torn" and rule.op not in ("write", "append", "any"):
            raise FaultSpecError(f"kind=torn applies to write/append ops, not {rule.op!r}")
        if rule.kind == "corrupt" and rule.op not in ("read", "peer_serve", "any"):
            raise FaultSpecError(f"kind=corrupt applies to read/peer_serve ops, not {rule.op!r}")
        if rule.chunk is not None and rule.kind != "corrupt":
            raise FaultSpecError(f"chunk= targets corrupt rules only, not kind={rule.kind!r}")
        plan.rules.append(rule)
    return plan


def _current_rank() -> int:
    """This process's rank, for ``rank=`` filters: the rank of the port's
    coordinator (the installed one, the process group's, else 0)."""
    from .parallel.coordinator import get_coordinator

    return get_coordinator().get_rank()


@dataclass
class _Action:
    kind: str
    rule: FaultRule


def _writable_bytes(read_io: ReadIO) -> memoryview:
    """A writable byte view of a completed read's buffer. A backend that
    returned its own immutable object (``memory://``) gets a private copy
    first, so rot never reaches the store."""
    mv = memoryview(read_io.buf)
    if mv.readonly:
        read_io.buf = bytearray(mv)
        mv = memoryview(read_io.buf)
    return mv if mv.format == "B" and mv.ndim == 1 else mv.cast("B")


class FaultyStoragePlugin(StoragePlugin):
    """Wraps any plugin, injecting faults per a :class:`FaultPlan`; fully
    transparent when no rule matches. Transient faults are retried here
    through ``cloud_retry``, so a storm drives the real backoff and
    collective-progress window."""

    def __init__(self, inner: StoragePlugin, plan: FaultPlan) -> None:
        self.inner = inner
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._counters: Dict[str, int] = {}
        self._rank = _current_rank()
        self._progress = (
            CollectiveProgress(window_s=plan.window_s) if plan.window_s is not None else CollectiveProgress()
        )

    @property
    def supports_streaming(self) -> bool:  # type: ignore[override]
        return bool(getattr(self.inner, "supports_streaming", False))

    @property
    def scales_io_with_local_world(self) -> bool:  # type: ignore[override]
        return bool(getattr(self.inner, "scales_io_with_local_world", False))

    # -- injection ---------------------------------------------------------
    def _next_action(self, op: str, path: str) -> Optional[_Action]:
        index = self._counters.get(op, 0)
        self._counters[op] = index + 1
        for rule in self.plan.rules:
            if op in _DERIVED_OP_SET and rule.op != op:
                continue  # derived classes match only rules naming them
            if rule.matches(op, index, path, self._rng, self._rank):
                rule.injected += 1
                return _Action(kind=rule.kind, rule=rule)
        return None

    async def _guard(self, op: str, path: str) -> Optional[_Action]:
        """One injection point: raises, stalls or kills per the matched
        rule; returns the action of the kinds the caller carries out
        (torn, corrupt)."""
        act = self._next_action(op, path)
        if act is None:
            return None
        telemetry.counter_add(f"faults.{act.kind}")
        if act.kind == "stall":
            logger.warning("FAULT stall %.2fs on %s %s", act.rule.secs, op, path)
            await asyncio.sleep(act.rule.secs)
            return None
        if act.kind == "kill":
            logger.warning("FAULT kill at %s %s", op, path)
            # No atexit, no finally: the nearest portable stand-in for a
            # preempted host.
            os._exit(KILL_EXIT_CODE)
        if act.kind == "transient":
            raise InjectedTransientFault(f"injected transient {op} fault: {path}")
        if act.kind == "fail":
            raise InjectedFault(f"injected {op} failure: {path}")
        return act

    async def _retrying(self, run, label: str):
        return await retry_transient(
            run,
            lambda e: isinstance(e, InjectedTransientFault),
            self._progress,
            label,
            base_backoff_s=self.plan.backoff_s,
        )

    def _has_rule_for(self, op: str) -> bool:
        return any(rule.op == op for rule in self.plan.rules)

    # -- ops ---------------------------------------------------------------
    async def write(self, write_io: WriteIO) -> None:
        async def run() -> None:
            for derived, prefix in _DERIVED_WRITE_OPS:
                if write_io.path.startswith(prefix) and self._has_rule_for(derived):
                    await self._guard(derived, write_io.path)
            act = await self._guard("write", write_io.path)
            if act is not None and act.kind == "torn":
                # A crash mid-write: `bytes` bytes into a real stream of the
                # inner plugin, then neither commit nor abort.
                stream = await self.inner.write_stream(write_io.path)
                mv = memoryview(write_io.buf).cast("B")
                await stream.append(mv[: act.rule.bytes])
                raise InjectedFault(f"injected torn write after {act.rule.bytes} bytes: {write_io.path}")
            await self.inner.write(write_io)

        await self._retrying(run, "faults")

    async def read(self, read_io: ReadIO) -> None:
        async def run() -> None:
            act = await self._guard("read", read_io.path)
            # A retried read starts from an empty buffer (or overwrites the
            # caller's `into` from offset 0).
            read_io.buf = None
            await self.inner.read(read_io)
            if act is not None and act.kind == "corrupt":
                self._corrupt_buffer(read_io, act.rule)

        await self._retrying(run, "faults")

    def _corrupt_buffer(self, read_io: ReadIO, rule: FaultRule) -> None:
        """Flip ``rule.bytes`` bytes (at least 1) of the completed read at
        seeded offsets: anywhere, or inside hash chunk ``rule.chunk``."""
        buf = _writable_bytes(read_io)
        if buf.nbytes == 0:
            return
        lo, hi = 0, buf.nbytes
        if rule.chunk is not None:
            from .utils import knobs

            grain = knobs.get_hash_chunk_bytes()
            if grain <= 0:
                logger.warning("FAULT corrupt chunk=%d ignored: hash chunking is disabled (grain 0)", rule.chunk)
                return
            # Chunk extents are object coordinates; a ranged read's buffer
            # starts at byte_range[0].
            base = read_io.byte_range[0] if read_io.byte_range else 0
            lo = max(0, rule.chunk * grain - base)
            hi = min(buf.nbytes, (rule.chunk + 1) * grain - base)
            if hi <= lo:
                logger.warning(
                    "FAULT corrupt chunk=%d skipped: read %s%s does not cover the chunk's extent",
                    rule.chunk, read_io.path, f" range {read_io.byte_range}" if read_io.byte_range else "",
                )
                return
        for _ in range(max(1, rule.bytes)):
            buf[lo + self._rng.randrange(hi - lo)] ^= 0xFF
        logger.warning(
            "FAULT corrupt %d byte(s) on read %s%s", max(1, rule.bytes), read_io.path,
            f" (chunk {rule.chunk})" if rule.chunk is not None else "",
        )

    async def delete(self, path: str) -> None:
        async def run() -> None:
            await self._guard("delete", path)
            await self.inner.delete(path)

        await self._retrying(run, "faults")

    async def write_stream(self, path: str) -> StorageWriteStream:
        async def run() -> StorageWriteStream:
            await self._guard("stream_open", path)
            return await self.inner.write_stream(path)

        inner_stream = await self._retrying(run, "faults")
        return _FaultyWriteStream(self, path, inner_stream)

    async def link_in(self, src_abs_path: str, path: str) -> bool:
        await self._guard("link", path)
        return await self.inner.link_in(src_abs_path, path)

    async def list_prefix(self, prefix: str) -> List[str]:
        async def run() -> List[str]:
            await self._guard("list", prefix)
            return await self.inner.list_prefix(prefix)

        return await self._retrying(run, "faults")

    async def prune_empty(self) -> None:
        await self.inner.prune_empty()

    async def close(self) -> None:
        await self.inner.close()

    # -- the swarm's peer-serve point ---------------------------------------
    async def inject_peer_serve(self, path: str, payload: bytearray) -> None:
        """The swarm's peer-serving point, called with the chunk's POSTED
        copy just before this rank fans it out. ``corrupt`` flips seeded
        bytes of ``payload`` in place (the serving rank's own buffer stays
        clean: rot in flight, which the receiver's chunk check catches and
        blames on this rank); the other kinds act as at any op."""
        act = await self._guard("peer_serve", path)
        if act is None or act.kind != "corrupt" or not payload:
            return
        flips = max(1, act.rule.bytes)
        for _ in range(flips):
            payload[self._rng.randrange(len(payload))] ^= 0xFF
        logger.warning("FAULT corrupt %d byte(s) in peer-served chunk %s", flips, path)


def find_fault_injector(storage) -> Optional[FaultyStoragePlugin]:
    """The fault wrapper inside a (possibly layered) plugin stack, found
    along ``inner`` links; None when injection is not installed."""
    seen = 0
    while storage is not None and seen < 8:
        if isinstance(storage, FaultyStoragePlugin):
            return storage
        storage = getattr(storage, "inner", None)
        seen += 1
    return None


class _FaultyWriteStream(StorageWriteStream):
    """Injects at append, commit and abort; proxies the inner stream."""

    def __init__(self, plugin: FaultyStoragePlugin, path: str, inner: StorageWriteStream) -> None:
        self._plugin = plugin
        self._path = path
        self.inner = inner

    async def append(self, buf) -> None:
        act = await self._plugin._guard("append", self._path)
        if act is not None and act.kind == "torn":
            mv = memoryview(buf).cast("B")
            await self.inner.append(mv[: act.rule.bytes])
            raise InjectedFault(f"injected torn append after {act.rule.bytes} bytes: {self._path}")
        # Not retried: appends are ordered, and a blind re-append after a
        # partial transfer would corrupt the stream. Real plugins retry
        # inside their append; an injected fault surfaces to the caller,
        # whose job is to abort.
        await self.inner.append(buf)

    async def commit(self) -> None:
        await self._plugin._guard("commit", self._path)
        await self.inner.commit()

    async def abort(self) -> None:
        await self._plugin._guard("abort", self._path)
        await self.inner.abort()


def maybe_wrap_with_faults(plugin: StoragePlugin) -> StoragePlugin:
    """``plugin`` wrapped when ``TSS_TORCH_FAULTS`` is set; a malformed
    spec raises at once."""
    from .utils import knobs

    spec = knobs.get_faults_spec()
    if not spec:
        return plugin
    return FaultyStoragePlugin(plugin, parse_fault_spec(spec))


# ---------------------------------------------------------------------------
# Local injection points: commit points inside a plugin below the wrapper
# (the read cache's bitmap rename) or outside storage (the fleet beacon),
# driven by the same spec with counters and an RNG of their own, matching
# only rules that name their class.
# ---------------------------------------------------------------------------


class _LocalInjector:
    """Per-process synchronous injector of the local points."""

    def __init__(self, spec: str) -> None:
        self.spec = spec
        self.plan = parse_fault_spec(spec)
        self._rng = random.Random(self.plan.seed)
        self._rank = _current_rank()
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def inject(self, op: str, path: str) -> None:
        with self._lock:
            index = self._counters.get(op, 0)
            self._counters[op] = index + 1
            act = None
            for rule in self.plan.rules:
                if rule.op != op:
                    continue
                if rule.matches(op, index, path, self._rng, self._rank):
                    rule.injected += 1
                    act = rule
                    break
        if act is None:
            return
        telemetry.counter_add(f"faults.{act.kind}")
        if act.kind == "stall":
            logger.warning("FAULT stall %.2fs on %s %s", act.secs, op, path)
            time.sleep(act.secs)
            return
        if act.kind == "kill":
            logger.warning("FAULT kill at %s %s", op, path)
            os._exit(KILL_EXIT_CODE)
        if act.kind == "transient":
            raise InjectedTransientFault(f"injected transient {op} fault: {path}")
        # fail / torn / corrupt: these one-shot sites have no partial
        # transfer or buffer to work on.
        raise InjectedFault(f"injected {op} failure: {path}")


_LOCAL_INJECTOR: Optional[_LocalInjector] = None
_LOCAL_LOCK = threading.Lock()


def maybe_inject_local(op: str, path: str) -> None:
    """Run a local injection point: nothing unless ``TSS_TORCH_FAULTS`` is
    set and names ``op``."""
    from .utils import knobs

    spec = knobs.get_faults_spec()
    if not spec:
        return
    global _LOCAL_INJECTOR
    with _LOCAL_LOCK:
        if _LOCAL_INJECTOR is None or _LOCAL_INJECTOR.spec != spec:
            _LOCAL_INJECTOR = _LocalInjector(spec)
        injector = _LOCAL_INJECTOR
    injector.inject(op, path)

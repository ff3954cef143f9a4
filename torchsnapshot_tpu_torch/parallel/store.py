"""Key-value stores and a thread-safe two-phase barrier.

A port of ``torchsnapshot_tpu/parallel/store.py``. Checkpoint planning
traffic (manifests, load sizes, barrier markers) is small, and the async
commit runs on a background thread, so the control plane rides a KV store
rather than process-group collectives:

- :class:`C10dStore` adapts the c10d store of ``torch.distributed``'s
  default process group (already up wherever ``init_process_group`` ran);
- :class:`TCPStore` is a small self-contained socket store for runs without
  a process group; the server lives in the rank-0 process and every op is a
  framed pickle message;
- :class:`LocalStore` serves single-process runs and unit tests.

:class:`LinearBarrier` is a two-phase (arrive/depart) barrier with a
leader-held critical section and cross-rank error propagation: if any rank
reports an error, every other rank raises instead of deadlocking, and the
leader never commits.
"""

from __future__ import annotations

import abc
import contextlib
import pickle
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Dict, List, Optional

from ..collective_tracer import active_tracer
from ..telemetry import fleet
from ..utils import knobs

_DEFAULT_TIMEOUT_S = 300.0

_TELEMETRY_OP = threading.local()


@contextlib.contextmanager
def telemetry_op_scope():
    """Mark the store operations the calling thread issues inside as
    telemetry-plane traffic (fleet beacons and their reads): real store
    round trips, but rate-limited diagnostics rather than per-take
    coordination, so counts of the coordination plane
    (``dryrun.counting_store_ops``) leave them out."""
    prev = getattr(_TELEMETRY_OP, "on", False)
    _TELEMETRY_OP.on = True
    try:
        yield
    finally:
        _TELEMETRY_OP.on = prev


def in_telemetry_op() -> bool:
    """True inside :func:`telemetry_op_scope` on the calling thread."""
    return getattr(_TELEMETRY_OP, "on", False)


class Store(abc.ABC):
    """Minimal KV contract needed by the coordinator and LinearBarrier."""

    @abc.abstractmethod
    def set(self, key: str, value: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        """Blocking get: waits until ``key`` exists; raises
        ``TimeoutError`` when it does not within ``timeout_s``."""
        ...

    @abc.abstractmethod
    def try_get(self, key: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def add(self, key: str, delta: int) -> int:
        """Atomic increment; returns the new value (missing key counts as 0)."""
        ...

    def delete(self, key: str) -> None:
        """Best-effort removal of a key (and its counter). Default: no-op."""

    def try_get_many(self, keys: List[str]) -> List[Optional[bytes]]:
        """``try_get`` for each key, in order."""
        return [self.try_get(k) for k in keys]

    def delete_many(self, keys: List[str]) -> None:
        for k in keys:
            self.delete(k)

    def prefix(self, p: str) -> "PrefixStore":
        return PrefixStore(p, self)


class PrefixStore(Store):
    def __init__(self, prefix: str, store: Store) -> None:
        self._prefix = prefix
        self._store = store

    def set(self, key: str, value: bytes) -> None:
        self._store.set(f"{self._prefix}/{key}", value)

    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        return self._store.get(f"{self._prefix}/{key}", timeout_s)

    def try_get(self, key: str) -> Optional[bytes]:
        return self._store.try_get(f"{self._prefix}/{key}")

    def add(self, key: str, delta: int) -> int:
        return self._store.add(f"{self._prefix}/{key}", delta)

    def delete(self, key: str) -> None:
        self._store.delete(f"{self._prefix}/{key}")

    def try_get_many(self, keys: List[str]) -> List[Optional[bytes]]:
        return self._store.try_get_many([f"{self._prefix}/{k}" for k in keys])


# ---------------------------------------------------------------------------
# In-process store (single-process runs and unit tests)
# ---------------------------------------------------------------------------


class LocalStore(Store):
    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}
        self._counters: Dict[str, int] = {}
        self._cond = threading.Condition()

    def set(self, key: str, value: bytes) -> None:
        with self._cond:
            self._data[key] = value
            self._cond.notify_all()

    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    raise TimeoutError(f"Store.get timed out waiting for {key!r}")
            return self._data[key]

    def try_get(self, key: str) -> Optional[bytes]:
        with self._cond:
            return self._data.get(key)

    def add(self, key: str, delta: int) -> int:
        with self._cond:
            self._counters[key] = self._counters.get(key, 0) + delta
            self._cond.notify_all()
            return self._counters[key]

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)
            self._counters.pop(key, None)


# ---------------------------------------------------------------------------
# torch.distributed's c10d store
# ---------------------------------------------------------------------------


class C10dStore(Store):
    """Rides the c10d store of ``torch.distributed``'s default process group
    (the torch counterpart of the JAX package's coordination-service store).

    ``torch.distributed.distributed_c10d._get_default_store`` is private
    API; it has kept its name and meaning across torch releases, and it is
    the only way to reach the store a process group was built on. Keys live
    under ``tss/`` so they never meet c10d's own.

    A blocking get is a poll of ``check`` (non-blocking) rather than c10d's
    ``wait``: a ``wait`` holds the client's connection for its whole
    duration, which would stall the async commit thread's barrier ops
    behind a main-thread collective.

    c10d's libuv TCPStore server refuses a message above 8 MiB, so a value
    above :attr:`PART_BYTES` is stored as parts under ``<key>/#<i>``, written
    before a small header at ``<key>`` that names them: a reader that sees
    the header finds every part in place (the broadcast and swarm restores
    move objects of up to 256 MiB this way)."""

    _POLL_S = (0.001, 0.05)  # first and longest poll interval
    PART_BYTES = 4 * 1024 * 1024
    _HEADER = b"\x00tss-parts\x00"

    def __init__(self, store: Any = None, namespace: str = "tss") -> None:
        if store is None:
            from torch.distributed import distributed_c10d

            store = distributed_c10d._get_default_store()
        self._store = store
        self._ns = namespace

    def _k(self, key: str) -> str:
        return f"{self._ns}/{key}"

    def unprefixed(self) -> "C10dStore":
        """The same server without the process group's own key prefixes
        (``default_pg/``, the group name): keys any client of the raw
        ``host:port`` finds under ``tss/`` (the fleet beacons)."""
        raw = getattr(self._store, "_underlying_non_prefix_store", None)
        return C10dStore(raw, self._ns) if raw is not None else self

    def set(self, key: str, value: bytes) -> None:
        k = self._k(key)
        value = memoryview(value).cast("B")
        if value.nbytes <= self.PART_BYTES:
            self._store.set(k, bytes(value))
            return
        n = -(value.nbytes // -self.PART_BYTES)
        for i in range(n):
            self._store.set(f"{k}/#{i}", bytes(value[i * self.PART_BYTES : (i + 1) * self.PART_BYTES]))
        self._store.set(k, self._HEADER + f"{n}:{value.nbytes}".encode())

    def _value(self, k: str, raw: bytes) -> bytes:
        if not raw.startswith(self._HEADER):
            return raw
        n, total = (int(x) for x in raw[len(self._HEADER) :].decode().split(":"))
        out = bytearray()
        for i in range(n):
            out += self._store.get(f"{k}/#{i}")
        if len(out) != total:
            raise RuntimeError(f"store value {k!r}: {len(out)} bytes in its parts, {total} expected")
        return bytes(out)

    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        deadline = time.monotonic() + timeout_s
        poll = self._POLL_S[0]
        k = self._k(key)
        while not self._store.check([k]):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"Store.get timed out waiting for {key!r}")
            time.sleep(poll)
            poll = min(poll * 2, self._POLL_S[1])
        return self._value(k, bytes(self._store.get(k)))

    def try_get(self, key: str) -> Optional[bytes]:
        k = self._k(key)
        if not self._store.check([k]):
            return None
        return self._value(k, bytes(self._store.get(k)))

    def add(self, key: str, delta: int) -> int:
        return int(self._store.add(self._k(key), delta))

    def delete(self, key: str) -> None:
        """Never blocks: parts left without a header (a writer that died
        part-way, or a second deleter) are removed while they are found."""
        k = self._k(key)
        try:
            raw = bytes(self._store.get(k)) if self._store.check([k]) else b""
            if raw.startswith(self._HEADER):
                n = int(raw[len(self._HEADER) :].decode().split(":")[0])
                for i in range(n):
                    self._store.delete_key(f"{k}/#{i}")
            else:
                i = 0
                while self._store.check([f"{k}/#{i}"]):
                    self._store.delete_key(f"{k}/#{i}")
                    i += 1
            self._store.delete_key(k)
        except Exception:  # noqa: BLE001 - cleanup is best-effort
            pass


# ---------------------------------------------------------------------------
# Self-contained TCP store
# ---------------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionError("store connection closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _send_msg(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("!I", len(payload)) + payload)


def _recv_msg(sock: socket.socket) -> Any:
    (length,) = struct.unpack("!I", _recv_exact(sock, 4))
    return pickle.loads(_recv_exact(sock, length))


class _StoreServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    # Every rank's threads connect in one burst at the start of an
    # operation; the socketserver default backlog of 5 overflows.
    request_queue_size = 128

    def __init__(self, addr):
        super().__init__(addr, _StoreHandler)
        self.data: Dict[str, bytes] = {}
        self.counters: Dict[str, int] = {}
        self.cond = threading.Condition()


class _StoreHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: _StoreServer = self.server  # type: ignore[assignment]
        try:
            while True:
                op, key, arg = _recv_msg(self.request)
                if op == "set":
                    with server.cond:
                        server.data[key] = arg
                        server.cond.notify_all()
                    _send_msg(self.request, ("ok", None))
                elif op == "get":
                    deadline = time.monotonic() + arg
                    with server.cond:
                        while key not in server.data:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break
                            server.cond.wait(min(remaining, 1.0))
                        val = server.data.get(key)
                    _send_msg(self.request, ("timeout", None) if val is None else ("ok", val))
                elif op == "try_get":
                    with server.cond:
                        val = server.data.get(key)
                    _send_msg(self.request, ("ok", val))
                elif op == "mtry_get":
                    with server.cond:
                        vals = [server.data.get(k) for k in arg]
                    _send_msg(self.request, ("ok", vals))
                elif op == "delete":
                    with server.cond:
                        server.data.pop(key, None)
                        server.counters.pop(key, None)
                    _send_msg(self.request, ("ok", None))
                elif op == "add":
                    with server.cond:
                        server.counters[key] = server.counters.get(key, 0) + arg
                        val = server.counters[key]
                        server.cond.notify_all()
                    _send_msg(self.request, ("ok", val))
                else:
                    _send_msg(self.request, ("err", f"unknown op {op}"))
        except (ConnectionError, EOFError):
            pass


class TCPStore(Store):
    """Socket KV store; the server thread lives in the process of rank 0.
    Each client thread keeps its own connection."""

    def __init__(self, host: str, port: int, is_server: bool) -> None:
        self.host = host
        self.port = port
        self._server: Optional[_StoreServer] = None
        if is_server:
            self._server = _StoreServer((host, port))
            if port == 0:
                self.port = self._server.server_address[1]
            threading.Thread(target=self._server.serve_forever, daemon=True).start()
        self._local = threading.local()

    def _sock(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            deadline = time.monotonic() + 60
            last_err: Optional[Exception] = None
            while time.monotonic() < deadline:
                try:
                    sock = socket.create_connection((self.host, self.port), timeout=600)
                    break
                except OSError as e:
                    last_err = e
                    time.sleep(0.1)
            else:
                raise ConnectionError(f"cannot reach store: {last_err}")
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
        return sock

    def _call(self, op: str, key: str, arg: Any) -> Any:
        sock = self._sock()
        _send_msg(sock, (op, key, arg))
        status, val = _recv_msg(sock)
        if status == "timeout":
            raise TimeoutError(f"Store.get timed out waiting for {key!r}")
        if status != "ok":
            raise RuntimeError(val)
        return val

    def set(self, key: str, value: bytes) -> None:
        self._call("set", key, bytes(value))

    def get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> bytes:
        return self._call("get", key, timeout_s)

    def try_get(self, key: str) -> Optional[bytes]:
        return self._call("try_get", key, None)

    def add(self, key: str, delta: int) -> int:
        return self._call("add", key, delta)

    def delete(self, key: str) -> None:
        self._call("delete", key, None)

    def try_get_many(self, keys: List[str]) -> List[Optional[bytes]]:
        return self._call("mtry_get", "", list(keys))

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# LinearBarrier
# ---------------------------------------------------------------------------


class BarrierError(RuntimeError):
    """A peer reported failure through the barrier. Carries the failing
    rank, the phase it was in and its error's text."""

    def __init__(
        self,
        message: str,
        rank: Optional[int] = None,
        phase: Optional[str] = None,
        detail: Optional[str] = None,
    ) -> None:
        super().__init__(message)
        self.rank = rank
        self.phase = phase
        self.detail = detail if detail is not None else message


class BarrierTimeout(TimeoutError):
    """A barrier phase timed out. Carries the ranks whose arrival markers
    were still missing at the deadline."""

    def __init__(self, message: str, phase: str, missing_ranks: Optional[List[int]] = None) -> None:
        super().__init__(message)
        self.phase = phase
        self.missing_ranks = list(missing_ranks or [])


class LinearBarrier:
    """Two-phase store barrier with leader critical section and error
    fan-out::

        barrier = LinearBarrier(store, barrier_id, rank, world_size)
        try:
            barrier.arrive(timeout)     # all ranks' data is durable
            if rank == 0:
                commit_metadata()       # leader-only critical section
            barrier.depart(timeout)
        except Exception as e:
            barrier.report_error(e)     # unblocks and fails all peers
            raise
    """

    def __init__(self, store: Store, barrier_id: str, rank: int, world_size: int):
        self._store = store.prefix(f"barrier/{barrier_id}")
        self._barrier_id = barrier_id
        self._rank = rank
        self._world_size = world_size

    def arrive(self, timeout_s: Optional[float] = None) -> None:
        self._phase("arrive", self._resolve_timeout(timeout_s))

    def depart(self, timeout_s: Optional[float] = None) -> None:
        self._phase("depart", self._resolve_timeout(timeout_s))

    @staticmethod
    def _resolve_timeout(timeout_s: Optional[float]) -> float:
        return timeout_s if timeout_s is not None else knobs.get_barrier_timeout_s()

    @staticmethod
    def _unpickle_error(err: bytes) -> BarrierError:
        rank, phase, msg = pickle.loads(err)
        detail = f" during {phase}" if phase else ""
        return BarrierError(f"rank {rank} failed{detail}: {msg}", rank=rank, phase=phase, detail=msg)

    def _missing_ranks(self, phase: str) -> List[int]:
        """Ranks whose arrival markers for ``phase`` are absent: the peers
        everyone still waits on ([] on any store failure)."""
        try:
            # A diagnostic probe, not coordination.
            with telemetry_op_scope():
                vals = self._store.try_get_many([f"{phase}/r{r}" for r in range(self._world_size)])
        except Exception:  # noqa: BLE001 - attribution is best-effort
            return []
        return [r for r, v in enumerate(vals) if v is None and r != self._rank]

    def _phase(self, phase: str, timeout_s: float) -> None:
        wait_site = f"barrier.{phase}:{self._barrier_id}"
        try:
            self._wait_phase(phase, timeout_s, wait_site)
        finally:
            fleet.clear_blocked(wait_site)

    def _wait_phase(self, phase: str, timeout_s: float, wait_site: str) -> None:
        tracer = active_tracer()
        if tracer is not None:
            tracer.record(f"barrier.{phase}", self._barrier_id)
        # A per-rank marker beside the shared counter: the counter says how
        # many arrived, the markers say who (timeout attribution).
        self._store.set(f"{phase}/r{self._rank}", b"1")
        count = self._store.add(phase, 1)
        if count == self._world_size:
            self._store.set(f"{phase}/done", b"1")
        deadline = time.monotonic() + timeout_s
        poll_s = 0.25
        while True:
            err = self._store.try_get("error")
            if err is not None:
                raise self._unpickle_error(err)
            try:
                self._store.get(f"{phase}/done", timeout_s=poll_s)
            except TimeoutError:
                poll_s = 1.0
                # A poll round passed: the fleet beacons name the ranks this
                # rank waits on, and stay fresh while it waits.
                if fleet.enabled():
                    fleet.note_blocked(wait_site, self._missing_ranks(phase))
                    fleet.heartbeat()
                if time.monotonic() > deadline:
                    missing = self._missing_ranks(phase)
                    detail = ""
                    if missing:
                        detail = "; waiting on rank(s) " + ", ".join(str(r) for r in missing)
                    raise BarrierTimeout(
                        f"LinearBarrier {phase} timed out "
                        f"({count}/{self._world_size} arrived{detail})",
                        phase=phase,
                        missing_ranks=missing,
                    )
                continue
            # report_error() force-sets the done keys to unblock waiters, so
            # re-check for a peer failure before declaring success.
            err = self._store.try_get("error")
            if err is not None:
                raise self._unpickle_error(err)
            if tracer is not None and threading.current_thread() is threading.main_thread():
                # Every rank just passed this phase: cross-check the
                # lockstep fingerprint under the barrier's own namespace.
                # The async commit's barrier runs off the main thread; its
                # interleaving with main-thread planning is timing.
                tracer.crosscheck(self._store, self._rank, self._world_size, phase, timeout_s)
            return

    def report_error(self, e: BaseException, phase: Optional[str] = None) -> None:
        tracer = active_tracer()
        if tracer is not None:
            # Only the failing rank posts: journaled, never cross-checked.
            tracer.record("barrier.report_error", self._barrier_id, checked=False)
        self._store.set("error", pickle.dumps((self._rank, phase, repr(e))))
        # Unblock peers waiting on phase-done keys; they will see the error.
        self._store.set("arrive/done", b"1")
        self._store.set("depart/done", b"1")

"""Rank, world size and small-object collectives for the control plane.

A port of ``torchsnapshot_tpu/parallel/coordinator.py``. Checkpoint
planning traffic is tiny (manifests, load sizes, barrier markers), so it
runs over a KV store (:mod:`.store`), never over process-group
collectives: the async commit runs on a background thread, and a
process-group collective would queue behind the training job's own. No
tensor crosses processes: each rank streams its own part of the state
straight to storage, and reads back only the byte ranges it needs.

Generation counters make every collective use a fresh key namespace, so
the store needs no clean-up synchronisation between consecutive
collectives.
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional

from ..collective_tracer import active_tracer
from ..utils import knobs
from .store import C10dStore, LocalStore, Store


def _resolve_timeout(timeout_s: Optional[float]) -> float:
    """Default collective timeout, the barrier-timeout knob (commit barriers
    legitimately wait out the slowest rank's data write)."""
    return timeout_s if timeout_s is not None else knobs.get_barrier_timeout_s()


class Coordinator:
    """Rank/world size and object collectives over a :class:`Store`."""

    def __init__(self, store: Store, rank: int, world_size: int) -> None:
        self._store = store
        self._rank = rank
        self._world_size = world_size
        self._generation = 0
        # Keys this rank posted, pending deletion: [(generation, key)]. A
        # long run takes thousands of snapshots; without collection the
        # server of rank 0 would grow without bound.
        self._posted: List[tuple] = []
        # Once a barrier at generation b completes, every rank has finished
        # reading all keys of generations < b, so own keys older than the
        # last completed barrier may go.
        self._last_barrier_gen = 0
        self._deferred: List[str] = []

    # -- identity -----------------------------------------------------------
    def get_rank(self) -> int:
        return self._rank

    def get_world_size(self) -> int:
        return self._world_size

    @property
    def store(self) -> Store:
        return self._store

    def _next_ns(self, op: str):
        self._generation += 1
        self._gc_posted()
        prefix = f"coll/{op}/{self._generation}"
        return self._store.prefix(prefix), prefix

    def _post(self, ns_key: str) -> None:
        self._posted.append((self._generation, ns_key))

    def _gc_posted(self) -> None:
        while self._posted and self._posted[0][0] < self._last_barrier_gen:
            _, key = self._posted.pop(0)
            try:
                self._store.delete(key)
            except Exception:  # noqa: BLE001 - clean-up is best-effort
                break

    def defer_delete(self, key: str) -> None:
        """Delete ``key`` (of this coordinator's store) at the next
        :meth:`collect_deferred`: a payload of the broadcast and swarm
        restores, which peers read until the restore's final barrier."""
        self._deferred.append(key)

    def defer_delete_many(self, keys: List[str]) -> None:
        self._deferred.extend(keys)

    def collect_deferred(self) -> None:
        """Delete the deferred keys. Call only once every rank has passed
        a full-world barrier after they were posted."""
        keys, self._deferred = self._deferred, []
        try:
            self._store.delete_many(keys)
        except Exception:  # noqa: BLE001 - clean-up is best-effort
            pass

    def note_external_barrier(self) -> None:
        """A full-world rendezvous outside the coordinator completed (the
        commit LinearBarrier's depart): keys posted in earlier generations
        are safe to collect. Main thread only, like the collectives."""
        self._last_barrier_gen = self._generation

    # -- collectives --------------------------------------------------------
    def barrier(self, timeout_s: Optional[float] = None) -> None:
        if self._world_size == 1:
            return
        timeout_s = _resolve_timeout(timeout_s)
        ns, prefix = self._next_ns("barrier")
        tracer = active_tracer()
        if tracer is not None:
            tracer.record("coord.barrier", prefix)
        count = ns.add("count", 1)
        if count == self._world_size:
            ns.set("done", b"1")
            self._post(f"{prefix}/done")
            self._post(f"{prefix}/count")
        ns.get("done", timeout_s=timeout_s)
        self._last_barrier_gen = self._generation
        if tracer is not None:
            tracer.crosscheck(self._store, self._rank, self._world_size, prefix, timeout_s)

    def all_gather_object(self, obj: Any, timeout_s: Optional[float] = None) -> List[Any]:
        if self._world_size == 1:
            return [obj]
        timeout_s = _resolve_timeout(timeout_s)
        ns, prefix = self._next_ns("all_gather")
        tracer = active_tracer()
        if tracer is not None:
            tracer.record("coord.all_gather_object", prefix)
        ns.set(str(self._rank), pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        self._post(f"{prefix}/{self._rank}")
        return [pickle.loads(ns.get(str(r), timeout_s=timeout_s)) for r in range(self._world_size)]

    def broadcast_object(self, obj: Any, src: int = 0, timeout_s: Optional[float] = None) -> Any:
        if self._world_size == 1:
            return obj
        timeout_s = _resolve_timeout(timeout_s)
        ns, prefix = self._next_ns("broadcast")
        tracer = active_tracer()
        if tracer is not None:
            tracer.record("coord.broadcast_object", prefix)
        if self._rank == src:
            ns.set("obj", pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
            self._post(f"{prefix}/obj")
            return obj
        return pickle.loads(ns.get("obj", timeout_s=timeout_s))

    def gather_object(
        self, obj: Any, dst: int = 0, timeout_s: Optional[float] = None
    ) -> Optional[List[Any]]:
        if self._world_size == 1:
            return [obj]
        timeout_s = _resolve_timeout(timeout_s)
        ns, prefix = self._next_ns("gather")
        tracer = active_tracer()
        if tracer is not None:
            tracer.record("coord.gather_object", prefix)
        ns.set(str(self._rank), pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        self._post(f"{prefix}/{self._rank}")
        if self._rank != dst:
            return None
        return [pickle.loads(ns.get(str(r), timeout_s=timeout_s)) for r in range(self._world_size)]

    def scatter_object(
        self, objs: Optional[List[Any]], src: int = 0, timeout_s: Optional[float] = None
    ) -> Any:
        if self._world_size == 1:
            assert objs is not None
            return objs[0]
        timeout_s = _resolve_timeout(timeout_s)
        ns, prefix = self._next_ns("scatter")
        tracer = active_tracer()
        if tracer is not None:
            tracer.record("coord.scatter_object", prefix)
        if self._rank == src:
            assert objs is not None and len(objs) == self._world_size
            for r, o in enumerate(objs):
                ns.set(str(r), pickle.dumps(o, protocol=pickle.HIGHEST_PROTOCOL))
                self._post(f"{prefix}/{r}")
        return pickle.loads(ns.get(str(self._rank), timeout_s=timeout_s))


# One coordinator per process and process group: collective generation
# counters advance in lockstep across ranks only when every rank issues the
# same sequence of collectives against one long-lived coordinator.
_INSTALLED: Optional[Coordinator] = None
_C10D: Optional[tuple] = None  # (process group, its coordinator)
# The single-process coordinator: one per process, so what hangs off it
# across takes (the plan and prepared-take caches) persists.
_LOCAL: Optional[Coordinator] = None


def set_coordinator(coordinator: Optional[Coordinator]) -> None:
    """Make ``coordinator`` this process's default (None removes it); the
    multi-process launcher installs one over its TCPStore."""
    global _INSTALLED
    _INSTALLED = coordinator


def get_coordinator(coordinator: Optional[Coordinator] = None) -> Coordinator:
    """The coordinator of an operation. Order: the explicit argument, an
    installed coordinator, ``torch.distributed``'s default process group
    (rank and world size from it, traffic over its c10d store), else rank 0
    of 1 over a :class:`LocalStore`."""
    global _C10D, _LOCAL
    if coordinator is not None:
        return coordinator
    if _INSTALLED is not None:
        return _INSTALLED
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        if _C10D is None or _C10D[0] is not group:
            _C10D = (group, Coordinator(C10dStore(), dist.get_rank(), dist.get_world_size()))
        return _C10D[1]
    if _LOCAL is None:
        _LOCAL = Coordinator(LocalStore(), 0, 1)
    return _LOCAL

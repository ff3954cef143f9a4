"""The one general generator of every traffic mix.

A configuration (``configs/<name>.json``) says what state the system holds
and checkpoints: its ``"state"`` names ``states/<state>.py``, whose
``build`` makes it from the seed (``lib/state.py``). A traffic mix
(``traffic/<name>.json``) says what the window does with it:

- ``op``: the operation under test, ``ops/<op>.py``: its ``set_up(runner)``
  warms up the cell's own shapes and takes the plain reference's copy, its
  ``operation(runner, k)`` is the window's ``k``-th call, and an optional
  ``check(runner)`` replaces the default verdict (restore the newest
  snapshot and compare);
- ``storage``: the URL prefix every snapshot goes under, ending in ``/``
  or ``://`` and ``$VAR`` expanded (``memory://`` for the port's in-memory
  plugin, ``fs://$TMPDIR/`` for files);
- ``every_steps``: with ``N > 0`` a closed training loop runs steps back
  to back and calls the operation after every ``N``-th; with 0 the window
  runs the operation back to back and trains nothing;
- ``batch``: the training micro-batch, of sequences of the configuration's
  positions;
- ``warmup_steps``: the training steps set-up runs before the operation's
  own set-up, so that the window compiles and builds nothing.

A snapshot is deleted once the next one has committed, so storage holds at
most two. :class:`CellRunner` records every call it makes as an :class:`Op`
with host-clock bounds; the metric readers work from that record.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..reference.compare import StateCopy
from . import cells
from .state import sync

# Calls of the harness whose time is taken out of the window: the plain
# reference's own work.
EXCLUDED = frozenset({"copy_ref"})


@dataclasses.dataclass
class Op:
    """One call the harness made: ``kind`` (``step``, ``async_take``,
    ``wait``, ``take``, ``restore``, ``delete``, ``copy_ref``, ``fill``),
    its host-clock bounds (``time.monotonic()``) and what the port reported
    about it."""

    kind: str
    t0: float
    t1: float
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """What a run did, for the metric readers."""

    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    trace: bool
    ops: List[Op] = dataclasses.field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)
    setup: Dict[str, float] = dataclasses.field(default_factory=dict)
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_events: Optional[list] = None
    attempted: int = 0
    failed: int = 0

    def excluded(self) -> List[Tuple[float, float]]:
        """The window's intervals spent on the reference's work."""
        return [(op.t0, op.t1) for op in self.ops if op.kind in EXCLUDED and op.t0 >= self.window[0] and op.t1 <= self.window[1]]

    @property
    def window_s(self) -> float:
        """The window's seconds, less the reference's."""
        return self.window[1] - self.window[0] - sum(b - a for a, b in self.excluded())

    def in_window(self, kind: str) -> List[Op]:
        t0, t1 = self.window
        return [op for op in self.ops if op.kind == kind and op.t0 >= t0 and op.t1 <= t1]


class Commit:
    """Waits on a ``PendingSnapshot`` in a thread of its own, so the time
    its ``wait()`` returns is known to the host clock."""

    def __init__(self, pending: Any) -> None:
        self.pending = pending
        self.t_commit: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._wait, name="portbench-commit")
        self._thread.start()

    def _wait(self) -> None:
        try:
            self.pending.wait()
        except BaseException as e:  # noqa: BLE001 - reported as a failed operation
            self.error = e
        finally:
            self.t_commit = time.monotonic()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def join(self) -> None:
        self._thread.join()


def delete_snapshot(url: str) -> None:
    """Delete every object of the snapshot at ``url`` through its storage
    plugin's own interface."""
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    plugin = url_to_storage_plugin(url)

    async def delete_all() -> None:
        paths = await plugin.list_prefix("")
        await asyncio.gather(*(plugin.delete(p) for p in paths))
        await plugin.close()

    asyncio.run(delete_all())


class CellRunner:
    """Runs one cell's set-up, window and check, and records a :class:`Run`.
    Its methods are the calls an operation (``ops/<op>.py``) composes."""

    def __init__(self, run: Run, seed: int, device: torch.device) -> None:
        self.run = run
        self.seed = seed
        self.device = device
        self.traffic = run.traffic
        if not self.traffic["storage"].endswith("/"):
            raise ValueError(f"storage {self.traffic['storage']!r} does not end in '/'")
        self.op = cells.op(self.traffic["op"])
        self.state = cells.state(run.config["state"]).build(run.config, self.traffic, seed, device)
        storage = os.path.expandvars(self.traffic["storage"])
        self.base = f"{storage}portbench/{run.cell}/{seed}"
        self.n_snapshots = 0
        self.committed: Optional[str] = None  # newest committed snapshot
        self.pending: Optional[Tuple[str, Commit, Op]] = None
        self.reference: Optional[StateCopy] = None

    # ------------------------------------------------------------ recording
    def record(self, kind: str, fn: Callable[[], Any]) -> Tuple[Any, Op]:
        """Call ``fn`` and record it as an operation of ``kind``."""
        t0 = time.monotonic()
        out = fn()
        op = Op(kind, t0, time.monotonic())
        self.run.ops.append(op)
        return out, op

    def _session(self) -> Dict[str, Any]:
        """A telemetry session per operation in traced runs."""
        if not self.run.trace:
            return {}
        from torchsnapshot_tpu_torch import telemetry

        return {"_telemetry": telemetry.Telemetry()}

    def _next_url(self) -> str:
        self.n_snapshots += 1
        return f"{self.base}/{self.n_snapshots}"

    # ------------------------------------------------------------ calls
    def step(self) -> None:
        self.record("step", self.state.step)

    def take(self) -> None:
        from torchsnapshot_tpu_torch import Snapshot
        from torchsnapshot_tpu_torch import snapshot as snapshot_mod

        url = self._next_url()
        kw = self._session()
        self.run.attempted += 1
        try:
            _, op = self.record("take", lambda: Snapshot.take(url, self.state.app, **kw))
        except Exception as e:  # noqa: BLE001 - a failed take is counted and reported
            self._failed("take", e)
            delete_snapshot(url)
            return
        op.info.update(
            phases=dict(snapshot_mod.LAST_TAKE_PHASES),
            stats=dict(snapshot_mod.LAST_SYNC_DRAIN_STATS),
            tm=kw.get("_telemetry"),
        )
        self._committed(url)

    def async_take(self) -> None:
        """Wait for the previous async take to commit, take the reference's
        copy of the state, then ``async_take``."""
        from torchsnapshot_tpu_torch import Snapshot
        from torchsnapshot_tpu_torch import snapshot as snapshot_mod

        if self.pending is not None:
            self.record("wait", self.pending[1].join)
            self.settle()
        self.copy_reference()
        url = self._next_url()
        kw = self._session()
        self.run.attempted += 1
        try:
            pending, op = self.record("async_take", lambda: Snapshot.async_take(url, self.state.app, **kw))
        except Exception as e:  # noqa: BLE001 - a failed take is counted and reported
            self._failed("async_take", e)
            delete_snapshot(url)
            return
        op.info.update(phases=dict(snapshot_mod.LAST_TAKE_PHASES), tm=kw.get("_telemetry"))
        self.pending = (url, Commit(pending), op)

    def settle(self) -> None:
        """Finish the bookkeeping of a committed async take: its commit time,
        then the deletion of the snapshot before it."""
        if self.pending is None or not self.pending[1].done():
            return
        url, commit, op = self.pending
        self.pending = None
        op.info["t_commit"] = commit.t_commit
        if commit.error is not None:
            self._failed("async_take", commit.error)
            delete_snapshot(url)
            return
        self._committed(url)

    def restore(self, url: str) -> None:
        from torchsnapshot_tpu_torch import Snapshot

        kw = self._session()
        self.run.attempted += 1

        def call() -> None:
            Snapshot(url).restore(self.state.app, device=self.device, **kw)
            sync(self.device)

        try:
            _, op = self.record("restore", call)
        except Exception as e:  # noqa: BLE001 - a failed restore is counted and reported
            self._failed("restore", e)
            return
        op.info["tm"] = kw.get("_telemetry")

    def copy_reference(self) -> None:
        """The plain reference's copy of the state as it is now, on the
        host (``copy_ref``: its time is out of the window and out of
        ``setup_s``)."""

        def copy() -> None:
            named, scalars = self.state.named(), self.state.scalars()
            if self.reference is None:
                self.reference = StateCopy(named, scalars)
            else:
                self.reference.refresh(named, scalars)

        self.record("copy_ref", copy)

    def finish(self) -> None:
        """Wait for the last async take to commit."""
        if self.pending is not None:
            self.pending[1].join()
            self.settle()

    def _committed(self, url: str) -> None:
        if self.committed is not None:
            self.record("delete", lambda old=self.committed: delete_snapshot(old))
        self.committed = url

    def _failed(self, kind: str, error: BaseException) -> None:
        self.run.failed += 1
        print(f"portbench: {kind} failed: {error!r}", file=sys.stderr)

    # ------------------------------------------------------------ phases
    def set_up(self) -> None:
        """Warm up the cell's own shapes: training steps, then the
        operation's own set-up, which takes the reference's copy."""
        for _ in range(self.traffic.get("warmup_steps", 0)):
            self.state.step()
        self.op.set_up(self)
        self.run.setup["reference_s"] = sum(op.t1 - op.t0 for op in self.run.ops if op.kind in EXCLUDED)
        self.run.ops.clear()
        self.run.attempted = self.run.failed = 0
        self.run.numbers.update(self.state.numbers())

    def window(self, seconds: float) -> None:
        """The measured window: it opens now and closes when the last
        operation (with ``every_steps``, the last checkpoint interval)
        begun before ``seconds`` ran out has ended."""
        every = self.traffic.get("every_steps", 0)
        t0 = time.monotonic()
        deadline = t0 + seconds
        k = 0
        while time.monotonic() < deadline:
            k += 1
            self.op.operation(self, k)
            # Whole checkpoint intervals: the operation, then ``every``
            # steps, the first of which race its drain.
            for _ in range(every):
                self.step()
                self.settle()
        self.run.window = (t0, time.monotonic())

    def check(self) -> Dict[str, int]:
        """The plain reference's verdict: the operation's own check, or
        the newest snapshot restored into the state overwritten with a
        pattern and compared leaf by leaf."""
        if hasattr(self.op, "check"):
            return self.op.check(self)
        self.state.fill(0xFF)
        self.restore(self.committed)
        return self.compare()

    def compare(self) -> Dict[str, int]:
        """The live state against the reference's copy, byte for byte."""
        return self.reference.compare(self.state.named(), self.state.scalars())

    def close(self) -> None:
        self.finish()
        if self.committed is not None:
            delete_snapshot(self.committed)
            self.committed = None

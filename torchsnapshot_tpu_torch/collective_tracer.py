"""Debug-mode collective lockstep sanitizer (``TSS_TORCH_DEBUG_COLLECTIVES``).

A port of ``torchsnapshot_tpu/collective_tracer.py``. When the knob is set,
every coordinator collective (``barrier``, ``all_gather_object``,
``broadcast_object``, ``gather_object``, ``scatter_object``) and every
:class:`~.parallel.store.LinearBarrier` phase is journaled with:

- a **monotonic sequence number** (per process),
- the **op kind** and its **key fingerprint** (the collective's generation
  namespace / the barrier id + phase -- SPMD-invariant by construction, never
  payload contents, which legitimately differ per rank),
- the **originating call site** -- the first stack frame below the
  coordinator/store/tracer plumbing.

Each journaled lockstep op folds into a rolling sha256 fingerprint. At every
barrier (coordinator barrier, and LinearBarrier arrive/depart on the main
thread) the tracer cross-checks ``(sequence count, rolling fingerprint)``
against every peer through the coordinator store; a mismatch exchanges the
journals and raises :class:`CollectiveDivergenceError` on EVERY rank, naming
rank A @ site X vs rank B @ site Y and the **first divergent sequence
number**.

Ops that are *deliberately* asymmetric -- ``defer_delete`` (only the posting
rank registers its own key for GC), ``report_error`` (only the failing rank
posts), and any collective issued off the main thread (the async-commit
background barrier: its interleaving against main-thread planning is
timing-dependent, not SPMD-divergent) -- are journaled for attribution but
excluded from the checked fingerprint.

Production jobs leave the knob unset: no tracer object is ever allocated and
the collective paths pay one environment lookup per call.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading
import traceback
from typing import List, Optional, Tuple

__all__ = [
    "CollectiveTracer",
    "CollectiveDivergenceError",
    "active_tracer",
    "reset_tracer",
]

# Journal retention cap: the digest keeps rolling forever, but only the most
# recent entries are retained for divergence attribution (a divergence older
# than the window is still *detected*, just attributed approximately).
_MAX_JOURNAL = 65536


class CollectiveDivergenceError(RuntimeError):
    """Two ranks issued different collective sequences. Carries the first
    divergent sequence number and both ranks' call sites."""

    def __init__(
        self,
        message: str,
        seq: Optional[int] = None,
        rank_a: Optional[int] = None,
        site_a: Optional[str] = None,
        rank_b: Optional[int] = None,
        site_b: Optional[str] = None,
    ) -> None:
        super().__init__(message)
        self.seq = seq
        self.rank_a = rank_a
        self.site_a = site_a
        self.rank_b = rank_b
        self.site_b = site_b


_PLUMBING_FILES = ("collective_tracer.py", "coordinator.py", "store.py")


def _origin_site() -> str:
    """file:line(function) of the frame that issued the collective — the
    first frame below the tracer/coordinator/store plumbing."""
    for frame in reversed(traceback.extract_stack()):
        if os.path.basename(frame.filename) in _PLUMBING_FILES:
            continue
        filename = frame.filename
        marker = "torchsnapshot_tpu_torch"
        idx = filename.rfind(marker)
        if idx != -1:
            filename = filename[idx:]
        else:
            filename = filename.rsplit("/", 1)[-1]
        return f"{filename}:{frame.lineno} ({frame.name})"
    return "<unknown>"


class CollectiveTracer:
    """Thread-safe lockstep journal + store-backed cross-check.

    ``record`` appends ``(seq, op, key, site)`` entries; lockstep ops
    (``checked=True`` and issued from the main thread) additionally fold
    ``op`` and ``key`` into the rolling fingerprint that :meth:`crosscheck`
    compares across ranks. Journal entries are retained up to a cap for
    attribution; the fingerprint itself never truncates.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seq = 0  # checked (lockstep) sequence counter
        self._fp = b""  # rolling fingerprint over checked ops
        # Retained checked entries: (seq, op, key, site).
        self._journal: List[Tuple[int, str, str, str]] = []
        self._dropped = 0
        # Unchecked (asymmetric-by-design / off-main-thread) entries keep
        # their own annotation so a divergence report can still show them.
        self._unchecked: List[Tuple[int, str, str, str]] = []
        # Own digest keys posted by PREVIOUS successful crosschecks, safe to
        # delete once every rank passed them (i.e. at the next crosscheck).
        self._gc: List = []

    # ------------------------------------------------------------- recording
    def record(self, op: str, key: str = "", checked: bool = True) -> int:
        """Journal one collective; returns its sequence number. Lockstep ops
        must be recorded BEFORE the op blocks, so a peer diagnosing a hang
        sees the in-flight op at the tail of this rank's journal."""
        site = _origin_site()
        on_main = threading.current_thread() is threading.main_thread()
        with self._lock:
            if not (checked and on_main):
                self._unchecked.append((self._seq, op, key, site))
                if len(self._unchecked) > _MAX_JOURNAL:
                    del self._unchecked[: len(self._unchecked) // 2]
                return self._seq
            self._seq += 1
            self._fp = hashlib.sha256(
                self._fp + op.encode() + b"\0" + key.encode()
            ).digest()
            self._journal.append((self._seq, op, key, site))
            if len(self._journal) > _MAX_JOURNAL:
                drop = len(self._journal) // 2
                self._dropped += drop
                del self._journal[:drop]
            return self._seq

    # ------------------------------------------------------------ inspection
    def digest(self) -> Tuple[int, str]:
        """(checked sequence count, rolling fingerprint hex)."""
        with self._lock:
            return self._seq, self._fp.hex()

    def checked_entries(self) -> List[Tuple[int, str, str, str]]:
        with self._lock:
            return list(self._journal)

    def unchecked_entries(self) -> List[Tuple[int, str, str, str]]:
        with self._lock:
            return list(self._unchecked)

    # ------------------------------------------------------------ crosscheck
    def crosscheck(
        self,
        store,
        rank: int,
        world_size: int,
        tag: str,
        timeout_s: float = 60.0,
    ) -> None:
        """Compare this rank's (seq, fingerprint) against every peer.

        Called at the same program point on every rank (a barrier every rank
        just passed), with an identical ``tag`` — tags must be derived from
        the barrier's identity (generation counter / barrier id + phase),
        never from local state, so divergent ranks still rendezvous here.
        Raises :class:`CollectiveDivergenceError` on mismatch (on every
        rank), after exchanging journals for first-divergence attribution.
        """
        if world_size <= 1:
            return
        ns = store.prefix(f"colltrace/{tag}")
        # Keys from previous rounds: every rank passed those crosschecks, so
        # own postings are safe to reclaim now.
        with self._lock:
            gc, self._gc = self._gc, []
        for old_ns, old_key in gc:
            try:
                old_ns.delete(old_key)
            except Exception:  # noqa: BLE001 - cleanup is best-effort
                pass
        mine = self.digest()
        ns.set(str(rank), pickle.dumps(mine, protocol=pickle.HIGHEST_PROTOCOL))
        peers = {}
        for r in range(world_size):
            if r == rank:
                peers[r] = mine
            else:
                peers[r] = pickle.loads(ns.get(str(r), timeout_s=timeout_s))
        mismatched = sorted(r for r, d in peers.items() if d != mine)
        if not mismatched:
            with self._lock:
                self._gc.append((ns, str(rank)))
            return
        # Divergence: every rank observes the same digest set, so every rank
        # posts its journal and reads the lowest mismatching peer's.
        ns.set(
            f"journal/{rank}",
            pickle.dumps(
                (self._dropped, self.checked_entries()),
                protocol=pickle.HIGHEST_PROTOCOL,
            ),
        )
        other = mismatched[0]
        other_dropped, other_journal = pickle.loads(
            ns.get(f"journal/{other}", timeout_s=timeout_s)
        )
        raise self._divergence(rank, other, other_dropped, other_journal, tag)

    def _divergence(
        self,
        rank: int,
        other: int,
        other_dropped: int,
        other_journal: List[Tuple[int, str, str, str]],
        tag: str,
    ) -> CollectiveDivergenceError:
        mine = {seq: (op, key, site) for seq, op, key, site in self.checked_entries()}
        theirs = {seq: (op, key, site) for seq, op, key, site in other_journal}
        first = None
        for seq in sorted(set(mine) | set(theirs)):
            a, b = mine.get(seq), theirs.get(seq)
            if a is None or b is None or a[:2] != b[:2]:
                first = seq
                break
        if first is None:
            # Same retained entries yet different digests: the divergence
            # predates both retained windows.
            window = max(self._dropped, other_dropped)
            return CollectiveDivergenceError(
                f"collective lockstep divergence at {tag}: ranks {rank} and "
                f"{other} disagree before the retained journal window "
                f"(seq <= {window})",
                rank_a=rank,
                rank_b=other,
            )

        def describe(entry, who: int) -> str:
            if entry is None:
                return f"rank {who}: <no collective at this sequence number>"
            op, key, site = entry
            return f"rank {who}: {op}({key}) at {site}"

        a, b = mine.get(first), theirs.get(first)
        return CollectiveDivergenceError(
            f"collective lockstep divergence at {tag}, first divergent "
            f"sequence number {first}:\n"
            f"  {describe(a, rank)}\n"
            f"  {describe(b, other)}\n"
            "every collective must be issued identically on every rank",
            seq=first,
            rank_a=rank,
            site_a=a[2] if a else None,
            rank_b=other,
            site_b=b[2] if b else None,
        )


# One tracer per process (collective lockstep is a per-process property,
# like the coordinator itself). Created lazily on first use with the knob
# set; the knob is re-read per call so test overrides take effect, but the
# off path allocates nothing.
_TRACER: Optional[CollectiveTracer] = None


def active_tracer() -> Optional[CollectiveTracer]:
    """The process tracer when ``TSS_TORCH_DEBUG_COLLECTIVES`` is
    set, else None (the production path pays one env lookup, no allocation)."""
    global _TRACER
    from .utils import knobs

    if not knobs.is_debug_collectives_enabled():
        return None
    if _TRACER is None:
        _TRACER = CollectiveTracer()
    return _TRACER


def reset_tracer() -> None:
    """Drop the process tracer (tests; a fresh journal per scenario)."""
    global _TRACER
    _TRACER = None

"""Debug-mode budget-ledger sanitizer (``TSS_TORCH_DEBUG_LEDGER``).

A port of ``torchsnapshot_tpu/ledger.py``. When the knob is set, every
engine :class:`~.engine.executor.Budget` carries a :class:`BudgetLedger`:
each debit is tagged with its **owner** (the pipeline's label) and its
**site**, the first stack frame outside the ledger and budget plumbing,
i.e. the line of code that made the reservation (the engine's admission,
a node's ``recost``, a test's rogue debit). Credits consume entries by
exact amount when one matches, else most-recent-first, so the
estimate-correction idiom (``credit(cost); debit(nbytes)``) and aggregated
sweeps (``credit(outstanding)``) both reconcile.

At pipeline close and on every abort path the scheduler calls
:meth:`BudgetLedger.assert_balanced`: any outstanding bytes raise
:class:`LedgerLeakError` naming each leaking site and the leaked amount.

With the knob unset no ledger object is allocated and the budget's hot
path stays two integer adds.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import List, Optional, Tuple

__all__ = ["BudgetLedger", "LedgerLeakError", "maybe_ledger"]

# Frames of the budget plumbing that a site never names: the ledger itself
# and the Budget / NodeContext shims of engine/executor.py.
_SHIM_FUNCTIONS = ("debit", "credit", "recost")


class LedgerLeakError(RuntimeError):
    """The budget ledger found outstanding (or over-credited) bytes at a
    point where the pipeline asserts balance (close/abort)."""


def _origin_site() -> str:
    """file:line (function) of the frame that made the debit or credit:
    the first frame below the ledger and budget plumbing."""
    for frame in reversed(traceback.extract_stack()):
        if os.path.basename(frame.filename) == "ledger.py":
            continue
        if frame.name in _SHIM_FUNCTIONS:
            continue
        filename = frame.filename
        marker = "torchsnapshot_tpu_torch"
        idx = filename.rfind(marker)
        filename = filename[idx:] if idx != -1 else filename.rsplit("/", 1)[-1]
        return f"{filename}:{frame.lineno} ({frame.name})"
    return "<unknown>"


class BudgetLedger:
    """Thread-safe debit/credit journal with per-site attribution.

    Debits append ``[site, bytes]`` entries; credits reconcile against them
    (exact-amount match preferred, else LIFO consumption). Credits beyond
    every outstanding debit are kept as over-credit with their own site:
    both directions of imbalance are reported."""

    def __init__(self, owner: str) -> None:
        self.owner = owner
        self._lock = threading.Lock()
        self._entries: List[List] = []  # [site, bytes], insertion-ordered
        self._over_credits: List[Tuple[str, int]] = []

    def record_debit(self, nbytes: int) -> None:
        site = _origin_site()
        with self._lock:
            self._entries.append([site, int(nbytes)])

    def record_credit(self, nbytes: int) -> None:
        n = int(nbytes)
        with self._lock:
            # Exact-amount match first (admission and its credit), most
            # recent wins.
            for entry in reversed(self._entries):
                if entry[1] == n:
                    self._entries.remove(entry)
                    return
            # An aggregated credit: consume most-recent-first.
            while n > 0 and self._entries:
                entry = self._entries[-1]
                if entry[1] <= n:
                    n -= entry[1]
                    self._entries.pop()
                else:
                    entry[1] -= n
                    n = 0
            if n > 0:
                self._over_credits.append((_origin_site(), n))

    @property
    def outstanding_bytes(self) -> int:
        with self._lock:
            return sum(e[1] for e in self._entries) - sum(n for _, n in self._over_credits)

    def open_entries(self) -> List[Tuple[str, int]]:
        """Outstanding (site, bytes) debits, insertion-ordered."""
        with self._lock:
            return [(site, n) for site, n in self._entries]

    def assert_balanced(self, context: str) -> None:
        """Raise :class:`LedgerLeakError` naming every leaking site unless
        the outstanding bytes are exactly zero (both directions)."""
        with self._lock:
            entries = [(site, n) for site, n in self._entries]
            over = list(self._over_credits)
        if not entries and not over:
            return
        lines = [f"budget ledger imbalance at {context} (owner={self.owner}):"]
        for site, n in entries:
            lines.append(f"  leaked {n} bytes debited at {site}")
        for site, n in over:
            lines.append(f"  over-credited {n} bytes at {site}")
        raise LedgerLeakError("\n".join(lines))


def maybe_ledger(owner: str) -> Optional[BudgetLedger]:
    """A :class:`BudgetLedger` when ``TSS_TORCH_DEBUG_LEDGER`` is set,
    else None (nothing allocated)."""
    from .utils import knobs

    if not knobs.is_debug_ledger_enabled():
        return None
    return BudgetLedger(owner)

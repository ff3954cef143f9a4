"""Crash-state explorer: every durable-effect prefix must be restorable.

The effect journal (``effect_journal.py``, on with
``TSS_TORCH_DEBUG_EFFECTS``) records the order in which mutations reached
storage. A crash of one process at any instant leaves a prefix of that
order behind, plus, for a crash mid-write, part of the payload in flight.
:func:`explore` replays each prefix into a fresh directory and holds the
state to the lifecycle layer's crash-consistency contract:

A. **Restorable**: every snapshot with a ``.snapshot_metadata`` passes
   ``Snapshot.verify()``: every object the manifest names exists and
   matches its recorded digests. A ``restore_check`` callback may also
   drive a real restore.
B. **No publish before payload**: a catalog record never points at a
   snapshot whose ``.snapshot_metadata`` is absent, unless an earlier
   effect of the prefix deleted it (a *zombie* of a gc cut short, which the
   next gc finishes by contract).
C. **gc converges**: on a copy of the state, ``Snapshot.gc`` followed by a
   second run removes nothing more, and every snapshot that verified before
   still verifies after: gc never touches committed bytes.

A violation names the seq and call site of the last effect applied: "a
crash right after effect #N (site S) leaves an unrestorable state".

Replay model (the fs backend's crash window; conservative for atomic
backends): ``write``/``link`` land the object whole; ``stream_open``
creates a ``*.tmp.*`` file, ``append`` grows it, ``commit`` renames it onto
the final path; ``abort``/``delete`` remove. Interior samples (seeded) cut
a payload in flight and land its first bytes where a crash would: appended
to the stream's temp file, or as ``*.tmp.*`` debris of an atomic write,
never at the final path.

Origins from any backend replay onto the local file system, so a journal
of ``memory://`` runs is explored by the same code. Effects are read by
attribute, so a journal the JAX package recorded explores too. While
checking, ``TSS_TORCH_FAULTS``, ``TSS_TORCH_DEBUG_EFFECTS`` and
``TSS_TORCH_READ_CACHE_DIR`` are unset: the checks build their own plugins
and must see the replayed bytes.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import shutil
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

# Knobs that would make the *checks* (verify/gc, which build their own
# storage plugins) observe something other than the replayed bytes.
_NEUTRALIZED_KNOBS = (
    "TSS_TORCH_FAULTS",
    "TSS_TORCH_DEBUG_EFFECTS",
    "TSS_TORCH_READ_CACHE_DIR",
)

_METADATA_FNAME = ".snapshot_metadata"
_CATALOG_DIR = ".catalog"
_RECORD_DIR = ".catalog/records"


@contextlib.contextmanager
def _pristine_env():
    saved = {}
    for name in _NEUTRALIZED_KNOBS:
        if name in os.environ:
            saved[name] = os.environ.pop(name)
    try:
        yield
    finally:
        os.environ.update(saved)


@dataclass(frozen=True)
class Violation:
    """One crash state that breaks the contract, attributed to the last
    applied effect (crash 'immediately after effect #seq')."""

    prefix_len: int
    seq: int
    op: str
    path: str
    site: str
    problem: str
    interior: Optional[str] = None  # "k/n bytes" for mid-payload samples

    def render(self) -> str:
        where = f"effect #{self.seq} ({self.op} {self.path}) at {self.site}"
        cut = f" [interior: {self.interior}]" if self.interior else ""
        return (
            f"crash after {where}{cut} "
            f"(prefix of {self.prefix_len} effect(s)): {self.problem}"
        )


@dataclass
class ExplorationReport:
    prefixes: int = 0
    interior_samples: int = 0
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        head = (
            f"crash explorer: {self.prefixes} prefix(es), "
            f"{self.interior_samples} interior sample(s), "
            f"{len(self.violations)} violation(s)"
        )
        return "\n".join([head] + [f"  {v.render()}" for v in self.violations])


class CrashStateViolation(AssertionError):
    """Raised (by default) when any explored prefix breaks the contract."""

    def __init__(self, report: ExplorationReport) -> None:
        self.report = report
        super().__init__(report.render())


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def _common_base(origins: Sequence[str]) -> str:
    uniq = sorted(set(origins))
    if not uniq:
        return ""
    if len(uniq) == 1:
        return uniq[0]
    return os.path.commonpath(uniq)


class _ReplayState:
    """One incrementally-built crash state on disk.

    ``root`` mirrors the journal's common origin base (for the usual
    single-bucket run, the bucket itself)."""

    def __init__(self, root: str, base: str) -> None:
        self.root = root
        self.base = base
        os.makedirs(root, exist_ok=True)
        # stream_id -> (final abs path, temp abs path)
        self.streams: Dict[int, Tuple[str, str]] = {}
        # Mapped abs targets of every applied delete, for the zombie
        # exemption in invariant B.
        self.deleted: Set[str] = set()

    def map_path(self, origin: str, path: str) -> str:
        logical = os.path.normpath(os.path.join(origin, path))
        rel = os.path.relpath(logical, self.base)
        return os.path.normpath(os.path.join(self.root, rel))

    def _materialize(self, abs_path: str, payload: Optional[bytes]) -> None:
        os.makedirs(os.path.dirname(abs_path), exist_ok=True)
        with open(abs_path, "wb") as f:
            f.write(payload or b"")

    def apply(self, effect) -> None:
        abs_path = self.map_path(effect.origin, effect.path)
        if effect.op in ("write", "link"):
            self._materialize(abs_path, effect.payload)
        elif effect.op == "stream_open":
            tmp = f"{abs_path}.tmp.replay{effect.stream_id}"
            self._materialize(tmp, b"")  # fs opens the temp file eagerly
            self.streams[effect.stream_id] = (abs_path, tmp)
        elif effect.op == "append":
            entry = self.streams.get(effect.stream_id)
            if entry is not None:
                with open(entry[1], "ab") as f:
                    f.write(effect.payload or b"")
        elif effect.op == "commit":
            entry = self.streams.pop(effect.stream_id, None)
            if entry is not None and os.path.exists(entry[1]):
                os.replace(entry[1], entry[0])
        elif effect.op == "abort":
            entry = self.streams.pop(effect.stream_id, None)
            if entry is not None and os.path.exists(entry[1]):
                os.remove(entry[1])
        elif effect.op == "delete":
            self.deleted.add(abs_path)
            if os.path.isfile(abs_path):
                os.remove(abs_path)

    def apply_partial(self, effect, cut: int) -> None:
        """Land the first ``cut`` bytes of an in-flight payload where a
        real crash would leave them (see module docstring)."""
        partial = (effect.payload or b"")[:cut]
        abs_path = self.map_path(effect.origin, effect.path)
        if effect.op == "append":
            entry = self.streams.get(effect.stream_id)
            if entry is not None:
                with open(entry[1], "ab") as f:
                    f.write(partial)
        elif effect.op in ("write", "link"):
            self._materialize(f"{abs_path}.tmp.partial", partial)


# ---------------------------------------------------------------------------
# Invariant checks over one materialized crash state
# ---------------------------------------------------------------------------


def _committed_roots(state_root: str) -> List[str]:
    roots = []
    for dirpath, dirnames, filenames in os.walk(state_root):
        if _CATALOG_DIR in dirnames:
            dirnames.remove(_CATALOG_DIR)
        if _METADATA_FNAME in filenames:
            roots.append(dirpath)
    return sorted(roots)


def _catalog_record_targets(state_root: str) -> List[Tuple[str, str]]:
    """(record file, snapshot root abs path) for every parseable catalog
    record in the state (unparseable files are GC's problem, not ours)."""
    out = []
    for dirpath, _, filenames in os.walk(state_root):
        rel = os.path.relpath(dirpath, state_root).replace(os.sep, "/")
        if _RECORD_DIR not in f"{rel}/":
            continue
        bucket = dirpath
        while os.path.basename(bucket) != _CATALOG_DIR:
            bucket = os.path.dirname(bucket)
        bucket = os.path.dirname(bucket)
        for fname in filenames:
            record_file = os.path.join(dirpath, fname)
            try:
                with open(record_file, encoding="utf-8") as f:
                    name = str(json.load(f)["name"])
            except Exception:  # noqa: BLE001 - unclassifiable record
                continue
            out.append((record_file, os.path.join(bucket, name)))
    return sorted(out)


def _gc_targets(state_root: str) -> List[str]:
    """Directories ``Snapshot.gc`` should sweep: each bucket (dir holding a
    ``.catalog/`` or a committed child), or a bare committed root."""
    targets: Set[str] = set()
    for dirpath, dirnames, filenames in os.walk(state_root):
        if _CATALOG_DIR in dirnames:
            targets.add(dirpath)
        if _METADATA_FNAME in filenames:
            targets.add(
                state_root if dirpath == state_root else os.path.dirname(dirpath)
            )
    # Nested targets would double-sweep; keep outermost only.
    out: List[str] = []
    for t in sorted(targets):
        if not any(t.startswith(kept + os.sep) for kept in out):
            out.append(t)
    return out


def _check_state(
    state: _ReplayState,
    restore_check: Optional[Callable[[str], None]],
) -> List[str]:
    """Invariants A and B on the live state (read-only). Returns problem
    strings; the caller attributes them to the crash point."""
    from .snapshot import Snapshot

    problems: List[str] = []
    for root in _committed_roots(state.root):
        try:
            bad = Snapshot(path=root).verify()
        except Exception as e:  # noqa: BLE001 - any failure = unrestorable
            problems.append(f"committed snapshot {root} failed verify: {e}")
            continue
        if bad:
            worst = "; ".join(f"{p}: {why}" for p, why in sorted(bad.items()))
            problems.append(
                f"committed snapshot {root} is not bit-exact: {worst}"
            )
            continue
        if restore_check is not None:
            try:
                restore_check(root)
            except Exception as e:  # noqa: BLE001 - restore is the contract
                problems.append(
                    f"committed snapshot {root} failed restore check: {e}"
                )
    for record_file, snap_root in _catalog_record_targets(state.root):
        meta = os.path.join(snap_root, _METADATA_FNAME)
        if os.path.exists(meta):
            continue
        if meta in state.deleted:
            continue  # mid-GC zombie: record outlives metadata by contract
        problems.append(
            f"catalog record {os.path.relpath(record_file, state.root)} "
            f"published before {os.path.relpath(meta, state.root)} exists "
            "(publish-before-payload)"
        )
    return problems


def _check_gc_convergence(state_root: str, scratch: str) -> List[str]:
    """Invariant C on a copy: full-sweep GC converges in one run and never
    touches committed bytes."""
    from .snapshot import Snapshot

    problems: List[str] = []
    if os.path.exists(scratch):
        shutil.rmtree(scratch)
    shutil.copytree(state_root, scratch)
    clean_before = []
    for root in _committed_roots(scratch):
        try:
            if not Snapshot(path=root).verify():
                clean_before.append(root)
        except Exception:  # noqa: BLE001 - A already reported it
            pass
    for target in _gc_targets(scratch):
        try:
            Snapshot.gc(target, dry_run=False)
            second = Snapshot.gc(target, dry_run=False)
        except Exception as e:  # noqa: BLE001 - gc must not fail
            problems.append(f"gc failed on crash state under {target}: {e}")
            continue
        leftovers = second.get("remove", [])
        if leftovers:
            problems.append(
                f"gc did not converge under {target}: second run still "
                f"removes {sorted(leftovers)[:5]}"
            )
    for root in clean_before:
        try:
            bad = Snapshot(path=root).verify()
        except Exception as e:  # noqa: BLE001 - gc ate the snapshot
            problems.append(
                f"gc broke committed snapshot {root}: verify now fails: {e}"
            )
            continue
        if bad:
            worst = "; ".join(f"{p}: {why}" for p, why in sorted(bad.items()))
            problems.append(f"gc touched committed bytes under {root}: {worst}")
    shutil.rmtree(scratch, ignore_errors=True)
    return problems


# ---------------------------------------------------------------------------
# Exploration
# ---------------------------------------------------------------------------


def _interior_plan(effects, seed: int, interior_samples: int):
    """Deterministic (index, cut) samples: which in-flight payloads to cut,
    and where. Same seed + same journal => same plan."""
    rng = random.Random(seed)
    candidates = [
        i
        for i, e in enumerate(effects)
        if e.op in ("write", "append", "link") and e.nbytes > 1
    ]
    picked = sorted(rng.sample(candidates, min(interior_samples, len(candidates))))
    return [(i, rng.randrange(1, effects[i].nbytes)) for i in picked]


def explore(
    effects,
    workdir: str,
    *,
    seed: int = 0,
    interior_samples: int = 2,
    check_gc: bool = True,
    restore_check: Optional[Callable[[str], None]] = None,
    raise_on_violation: bool = True,
) -> ExplorationReport:
    """Replay every prefix of ``effects`` (plus seeded interior samples)
    under ``workdir`` and assert invariants A/B/C on each crash state.

    ``restore_check(root_abs_path)`` optionally drives a real restore per
    committed snapshot. Raises :class:`CrashStateViolation` naming the
    exact effect seq and call site unless ``raise_on_violation=False``."""
    effects = list(effects)
    report = ExplorationReport()
    base = _common_base([e.origin for e in effects])
    state_dir = os.path.join(workdir, "state")
    scratch = os.path.join(workdir, "scratch")
    if os.path.exists(state_dir):
        shutil.rmtree(state_dir)
    state = _ReplayState(state_dir, base)
    plan = dict(_interior_plan(effects, seed, interior_samples))

    def _record(problems, prefix_len, effect, interior=None):
        for problem in problems:
            report.violations.append(
                Violation(
                    prefix_len=prefix_len,
                    seq=effect.seq,
                    op=effect.op,
                    path=effect.path,
                    site=effect.site,
                    problem=problem,
                    interior=interior,
                )
            )

    with _pristine_env():
        for i, effect in enumerate(effects):
            cut = plan.get(i)
            if cut is not None:
                # Crash MID effect i: state holds effects[:i] plus a
                # partial tail of effect i's payload. Checked on a copy so
                # the live state stays an exact op-boundary prefix.
                partial_dir = os.path.join(workdir, "partial")
                if os.path.exists(partial_dir):
                    shutil.rmtree(partial_dir)
                shutil.copytree(state_dir, partial_dir)
                pstate = _ReplayState(partial_dir, base)
                pstate.deleted = set(state.deleted)

                def _reroot(p: str) -> str:
                    return os.path.join(
                        partial_dir, os.path.relpath(p, state_dir)
                    )

                pstate.streams = {
                    sid: (_reroot(final), _reroot(tmp))
                    for sid, (final, tmp) in state.streams.items()
                }
                pstate.apply_partial(effect, cut)
                interior = f"{cut}/{effect.nbytes} bytes"
                report.interior_samples += 1
                _record(
                    _check_state(pstate, restore_check), i, effect, interior
                )
                if check_gc:
                    _record(
                        _check_gc_convergence(partial_dir, scratch),
                        i,
                        effect,
                        interior,
                    )
                shutil.rmtree(partial_dir, ignore_errors=True)

            state.apply(effect)
            report.prefixes += 1
            _record(_check_state(state, restore_check), i + 1, effect)
            if check_gc:
                _record(_check_gc_convergence(state_dir, scratch), i + 1, effect)

    if report.violations and raise_on_violation:
        raise CrashStateViolation(report)
    return report


def explore_journal(workdir: str, **kwargs) -> ExplorationReport:
    """Explore the process-wide effect journal (the usual entry point:
    run a scenario under ``TSS_TORCH_DEBUG_EFFECTS=1``, then call this). Raises if the journal is disabled or empty — a silent no-op
    would read as coverage."""
    from . import effect_journal

    journal = effect_journal.get_journal()
    if journal is None:
        raise RuntimeError(
            "effect journal is disabled; set TSS_TORCH_DEBUG_EFFECTS=1 "
            "(or knobs.override_debug_effects) before the scenario runs"
        )
    effects = journal.effects()
    if not effects:
        raise RuntimeError("effect journal is empty; nothing was explored")
    return explore(effects, workdir, **kwargs)

"""The port's effect journal and crash explorer, held against the JAX
package's (``effect_journal.py``, ``dev/crash_explorer.py``).

Counterparts of ``tests/test_crash_explorer.py``, run on the port; then
the two explorers cross: the port's explores a journal the JAX package
recorded and reports what the JAX explorer reports, and a hand-broken
journal (the catalog record moved before ``.snapshot_metadata``, a payload
write dropped) is flagged by both at the same seq with the same problem.
"""

import asyncio
import os
import sys

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import torchsnapshot_tpu as jts  # noqa: E402
from dev import crash_explorer as jexplorer  # noqa: E402
from torchsnapshot_tpu import effect_journal as jjournal  # noqa: E402
from torchsnapshot_tpu.utils import knobs as jknobs  # noqa: E402

import torchsnapshot_tpu_torch as tts  # noqa: E402
from torchsnapshot_tpu_torch import crash_explorer as texplorer  # noqa: E402
from torchsnapshot_tpu_torch import effect_journal as tjournal  # noqa: E402
from torchsnapshot_tpu_torch.convert import from_numpy_tree  # noqa: E402
from torchsnapshot_tpu_torch.io_types import WriteIO  # noqa: E402
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin  # noqa: E402
from torchsnapshot_tpu_torch.utils import knobs  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_journals(monkeypatch):
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    tjournal.reset()
    jjournal.reset()
    yield
    tjournal.reset()
    jjournal.reset()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(512).astype(np.float32), "b": np.arange(64, dtype=np.int64) + seed, "step": seed}


def _state(seed):
    return {"s": tts.StateDict(from_numpy_tree(_tree(seed), device="cpu"))}


def _restore_check(root):
    """A bit-exact restore of a replayed root, through the port (the seed
    is the ``step_N`` suffix of its name)."""
    seed = int(os.path.basename(root).rsplit("_", 1)[1])
    want = _tree(seed)
    tgt = {"s": tts.StateDict(w=torch.zeros(512), b=torch.zeros(64, dtype=torch.int64), step=-1)}
    tts.Snapshot(root).restore(tgt, device="cpu")
    assert np.array_equal(tgt["s"]["w"].numpy().view(np.uint8), want["w"].view(np.uint8))
    assert np.array_equal(tgt["s"]["b"].numpy(), want["b"]) and tgt["s"]["step"] == seed


def _journaled_takes(bucket, seeds=(1, 2)):
    with knobs.override_debug_effects(True):
        tjournal.reset()
        for seed in seeds:
            tts.Snapshot.take(f"{bucket}/step_{seed}", _state(seed), job="j")
        effects = tjournal.get_journal().effects()
    tjournal.reset()
    return effects


def _jax_journaled_takes(bucket, seeds=(1, 2)):
    with jknobs.override_debug_effects(True):
        jjournal.reset()
        for seed in seeds:
            jts.Snapshot.take(f"{bucket}/step_{seed}", {"s": jts.StateDict(_tree(seed))}, job="j")
        effects = jjournal.get_journal().effects()
    jjournal.reset()
    return effects


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------


def test_journal_disabled_by_default(tmp_path):
    assert tjournal.get_journal() is None
    p = url_to_storage_plugin(str(tmp_path))
    while p is not None:
        assert not isinstance(p, tjournal.EffectRecordingPlugin)
        p = getattr(p, "inner", None)


def test_wrapper_journals_mutations_in_seq_order(tmp_path):
    with knobs.override_debug_effects(True):
        tjournal.reset()
        plugin = url_to_storage_plugin(str(tmp_path))
        loop = asyncio.new_event_loop()

        async def scenario():
            await plugin.write(WriteIO(path="a/obj", buf=memoryview(b"payload")))
            stream = await plugin.write_stream("a/streamed")
            await stream.append(b"chunk0")
            await stream.append(b"chunk1")
            await stream.commit()
            await plugin.delete("a/obj")
            await plugin.close()

        try:
            loop.run_until_complete(scenario())
        finally:
            loop.close()
        effects = tjournal.get_journal().effects()
    assert [e.op for e in effects] == ["write", "stream_open", "append", "append", "commit", "delete"]
    assert [e.seq for e in effects] == list(range(len(effects)))
    sid = effects[1].stream_id
    assert sid >= 0 and all(e.stream_id == sid for e in effects[1:5])
    assert effects[0].nbytes == len(b"payload") and effects[0].fingerprint != "-"
    assert effects[4].fingerprint == "-"
    assert "test_torch_crash_explorer" in effects[0].site


def test_journal_knob_reset_reevaluates():
    assert tjournal.get_journal() is None
    with knobs.override_debug_effects(True):
        assert tjournal.get_journal() is None  # the off decision is cached...
        tjournal.reset()  # ...until reset reads the knob again
        assert tjournal.get_journal() is not None


def test_journal_sites_name_the_port(tmp_path):
    effects = _journaled_takes(str(tmp_path / "bucket"), seeds=(1,))
    sites = {e.site.split(":")[0] for e in effects}
    assert "torchsnapshot_tpu_torch/snapshot.py" in sites and "torchsnapshot_tpu_torch/catalog.py" in sites
    assert not any(os.path.basename(s) in ("faults.py", "effect_journal.py", "cloud_retry.py") for s in sites)


# ---------------------------------------------------------------------------
# The explorer over the port's own runs
# ---------------------------------------------------------------------------


def test_real_take_every_prefix_restorable(tmp_path):
    effects = _journaled_takes(str(tmp_path / "bucket"))
    assert any(".catalog/records/" in e.path for e in effects)
    report = texplorer.explore(
        effects, str(tmp_path / "explore"), seed=7, interior_samples=3, restore_check=_restore_check
    )
    assert report.ok and report.prefixes == len(effects) and report.interior_samples == 3


def test_gc_schedule_every_prefix_restorable(tmp_path):
    bucket = str(tmp_path / "bucket")
    with knobs.override_debug_effects(True):
        tjournal.reset()
        tts.Snapshot.take(f"{bucket}/step_1", _state(1), job="j")
        tts.Snapshot.take(f"{bucket}/step_2", _state(2), job="j")
        tts.Snapshot.gc(bucket, dry_run=False, keep_roots={"step_2"})
        effects = tjournal.get_journal().effects()
    assert any(e.op == "delete" for e in effects)
    report = texplorer.explore(effects, str(tmp_path / "explore"), seed=0, interior_samples=2)
    assert report.ok and report.prefixes == len(effects)


def test_chaos_schedule_with_retake_every_prefix_restorable(tmp_path):
    """Take, gc, retake, journaled: every crash state, mid-gc zombies
    included, restores and converges."""
    bucket = str(tmp_path / "bucket")
    with knobs.override_debug_effects(True):
        tjournal.reset()
        tts.Snapshot.take(f"{bucket}/step_1", _state(1), job="chaos")
        tts.Snapshot.take(f"{bucket}/step_2", _state(2), job="chaos")
        tts.Snapshot.gc(bucket, dry_run=False, keep_roots={"step_2"})
        tts.Snapshot.take(f"{bucket}/step_3", _state(3), job="chaos")
        effects = tjournal.get_journal().effects()
    report = texplorer.explore(effects, str(tmp_path / "explore"), seed=0, interior_samples=4)
    assert report.ok, report.render()
    assert report.prefixes == len(effects)


def test_fault_suppressed_ops_are_never_journaled(tmp_path):
    """The journal sits below the fault injector: a write a rule failed
    never reached storage and is not in the journal."""
    url = str(tmp_path / "snap")
    with knobs.override_debug_effects(True):
        tjournal.reset()
        with knobs.override_faults("op=write,kind=fail,times=100"):
            with pytest.raises(Exception, match="injected"):
                tts.Snapshot.take(url, _state(1))
        effects = tjournal.get_journal().effects()
    assert not any(e.op == "write" for e in effects)
    assert not os.path.exists(os.path.join(url, ".snapshot_metadata"))


def test_prefix_enumeration_is_deterministic(tmp_path):
    effects = _journaled_takes(str(tmp_path / "bucket"), seeds=(1,))
    plan_a = texplorer._interior_plan(effects, seed=13, interior_samples=3)
    assert plan_a == texplorer._interior_plan(effects, seed=13, interior_samples=3)
    assert plan_a == jexplorer._interior_plan(effects, seed=13, interior_samples=3)
    assert len(plan_a) == 3
    for idx, cut in plan_a:
        assert effects[idx].op in ("write", "append", "link") and 1 <= cut < effects[idx].nbytes
    a = texplorer.explore(effects, str(tmp_path / "xa"), seed=13, interior_samples=3)
    b = texplorer.explore(effects, str(tmp_path / "xb"), seed=13, interior_samples=3)
    assert (a.prefixes, a.interior_samples) == (b.prefixes, b.interior_samples)


def test_nonatomic_catalog_publish_is_caught_with_attribution(tmp_path):
    effects = _journaled_takes(str(tmp_path / "bucket"), seeds=(1,))
    meta_i = next(i for i, e in enumerate(effects) if e.path == ".snapshot_metadata")
    rec_i = next(i for i, e in enumerate(effects) if ".catalog/records/" in e.path)
    assert meta_i < rec_i
    broken = list(effects)
    broken[meta_i], broken[rec_i] = broken[rec_i], broken[meta_i]
    with pytest.raises(texplorer.CrashStateViolation) as exc:
        texplorer.explore(broken, str(tmp_path / "explore"), seed=0, interior_samples=0)
    v = exc.value.report.violations[0]
    assert v.seq == effects[rec_i].seq and v.site == effects[rec_i].site
    assert "torchsnapshot_tpu_torch/catalog.py" in v.site and "publish-before-payload" in v.problem


def test_lost_payload_write_fails_bit_exact_restore(tmp_path):
    effects = _journaled_takes(str(tmp_path / "bucket"), seeds=(1,))
    payload_i = next(i for i, e in enumerate(effects) if e.path.startswith("0/"))
    broken = [e for i, e in enumerate(effects) if i != payload_i]
    with pytest.raises(texplorer.CrashStateViolation) as exc:
        texplorer.explore(broken, str(tmp_path / "explore"), seed=0, interior_samples=0)
    assert any("not bit-exact" in v.problem or "failed verify" in v.problem for v in exc.value.report.violations)


def test_explore_journal_requires_enabled_nonempty_journal(tmp_path):
    with pytest.raises(RuntimeError, match="disabled"):
        texplorer.explore_journal(str(tmp_path / "x"))
    with knobs.override_debug_effects(True):
        tjournal.reset()
        with pytest.raises(RuntimeError, match="empty"):
            texplorer.explore_journal(str(tmp_path / "x"))


def test_explore_journal_of_the_port(tmp_path):
    with knobs.override_debug_effects(True):
        tjournal.reset()
        tts.Snapshot.take(str(tmp_path / "b" / "step_1"), _state(1), job="j")
        report = texplorer.explore_journal(str(tmp_path / "x"), interior_samples=1)
    assert report.ok and report.prefixes >= 5


def test_explorer_neutralises_the_port_knobs(tmp_path, monkeypatch):
    """A fault spec or a read cache left in the environment must not reach
    the explorer's own verify and gc."""
    effects = _journaled_takes(str(tmp_path / "bucket"), seeds=(1,))
    monkeypatch.setenv("TSS_TORCH_FAULTS", "op=read,kind=fail")
    monkeypatch.setenv("TSS_TORCH_READ_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("TSS_TORCH_DEBUG_EFFECTS", "1")
    report = texplorer.explore(effects, str(tmp_path / "explore"), interior_samples=0)
    assert report.ok
    assert os.environ["TSS_TORCH_FAULTS"] == "op=read,kind=fail"
    assert not os.path.exists(tmp_path / "cache")


# ---------------------------------------------------------------------------
# The two explorers cross
# ---------------------------------------------------------------------------


def _same_violations(a, b):
    return [(v.prefix_len, v.seq, v.op, v.path, v.site, v.problem, v.interior) for v in a] == [
        (v.prefix_len, v.seq, v.op, v.path, v.site, v.problem, v.interior) for v in b
    ]


def test_port_explorer_over_a_jax_journal(tmp_path):
    """A journal the JAX package recorded (take, take, gc): the port's
    explorer reads it by attribute and reports the JAX explorer's prefixes,
    interior samples and 0 violations."""
    bucket = str(tmp_path / "bucket")
    with jknobs.override_debug_effects(True):
        jjournal.reset()
        jts.Snapshot.take(f"{bucket}/step_1", {"s": jts.StateDict(_tree(1))}, job="j")
        jts.Snapshot.take(f"{bucket}/step_2", {"s": jts.StateDict(_tree(2))}, job="j")
        jts.Snapshot.gc(bucket, dry_run=False, keep_roots={"step_2"})
        effects = jjournal.get_journal().effects()
    j = jexplorer.explore(effects, str(tmp_path / "x"), seed=3, interior_samples=2, raise_on_violation=False)
    t = texplorer.explore(effects, str(tmp_path / "x"), seed=3, interior_samples=2,
                          restore_check=_restore_check, raise_on_violation=False)
    assert (t.prefixes, t.interior_samples, len(t.violations)) == (j.prefixes, j.interior_samples, 0) == (
        len(effects), 2, 0)


@pytest.mark.parametrize("recorder", ["jax", "torch"])
def test_a_broken_journal_is_flagged_alike_by_both(tmp_path, recorder):
    """The catalog record moved before ``.snapshot_metadata`` and a payload
    write dropped: both explorers flag the same effects with the same
    problems."""
    bucket = str(tmp_path / "bucket")
    effects = (_jax_journaled_takes if recorder == "jax" else _journaled_takes)(bucket, seeds=(1,))
    meta_i = next(i for i, e in enumerate(effects) if e.path == ".snapshot_metadata")
    rec_i = next(i for i, e in enumerate(effects) if ".catalog/records/" in e.path)
    payload_i = next(i for i, e in enumerate(effects) if e.path.startswith("0/"))
    broken = list(effects)
    broken[meta_i], broken[rec_i] = broken[rec_i], broken[meta_i]
    broken = [e for i, e in enumerate(broken) if i != payload_i]
    work = str(tmp_path / "x")
    j = jexplorer.explore(broken, work, seed=0, interior_samples=0, raise_on_violation=False)
    t = texplorer.explore(broken, work, seed=0, interior_samples=0, raise_on_violation=False)
    assert j.violations and _same_violations(j.violations, t.violations), (j.render(), t.render())
    problems = " ".join(v.problem for v in t.violations)
    assert "publish-before-payload" in problems
    assert "not bit-exact" in problems or "failed verify" in problems
    first = t.violations[0]
    assert first.seq == effects[rec_i].seq and "publish-before-payload" in first.problem

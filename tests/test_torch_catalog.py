"""The port's lifecycle layer held against the JAX package's.

The catalog (records, pins, rebuild), managed delta chains
(``take(job=, step=, max_chain_len=)``), retention and ``Snapshot.gc``: the
same numpy states, made from a seed, go through both packages, and records,
plans, gc reports and the files left behind must agree exactly.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu import catalog as jcat
from torchsnapshot_tpu.utils import knobs as jknobs

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import catalog as tcat
from torchsnapshot_tpu_torch.convert import from_numpy_tree

FROZEN = np.random.default_rng(0).standard_normal(4000).astype(np.float32)


@pytest.fixture(autouse=True)
def _pinned_and_cold(monkeypatch):
    # tests/conftest.py pins the JAX package's sha256 digests; pin the
    # port's the same way, so every take can serve as a base.
    monkeypatch.setenv("TSS_TORCH_DEDUP_DIGESTS", "1")
    tcat._CHAIN_CACHE.clear()
    jcat._CHAIN_CACHE.clear()
    yield
    tcat._CHAIN_CACHE.clear()
    jcat._CHAIN_CACHE.clear()


def _tree(step: int):
    return {"frozen": FROZEN, "lora": np.full((64,), step, np.float32), "step": step}


def _tstate(step: int):
    return {"m": tts.StateDict(from_numpy_tree(_tree(step), device="cpu"))}


def _jstate(step: int):
    return {"m": jts.StateDict(_tree(step))}


def _assert_restores(path: str, step: int) -> None:
    """Bit-exact through both packages."""
    out = tts.StateDict(frozen=torch.zeros(4000), lora=torch.zeros(64), step=-1)
    tts.Snapshot(path).restore({"m": out}, device="cpu")
    assert out["step"] == step
    assert np.array_equal(out["frozen"].numpy().view(np.uint32), FROZEN.view(np.uint32))
    assert np.array_equal(out["lora"].numpy(), np.full((64,), step, np.float32))
    jout = jts.StateDict()
    jts.Snapshot(path).restore({"m": jout})
    assert jout["step"] == step and np.array_equal(np.asarray(jout["lora"]), np.full((64,), step, np.float32))
    assert tts.Snapshot(path).verify() == {}


def _records(mod, bucket):
    with mod.Catalog(bucket) as cat:
        return [json.loads(r.to_json()) for r in cat.load()]


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# Records and plumbing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "path",
    ["/ckpts/step_1", "/a/b/c/", "gs://bkt/run/step_1", "memory://bkt/s1", "memory://lonely", "/", "fs:///x/y"],
)
def test_split_bucket_parity(path):
    assert tcat.split_bucket(path) == jcat.split_bucket(path)


@pytest.mark.parametrize("job", ["j", "träiner/a", "a/b", "a_b", ""])
def test_record_and_pin_paths_parity(job):
    assert tcat.record_path(job, "step_7", 7) == jcat.record_path(job, "step_7", 7)
    assert tcat.pin_path(f"{job}x") == jcat.pin_path(f"{job}x")
    assert tcat.auto_base_token(job, 3) == jcat.auto_base_token(job, 3)
    assert tcat.parse_auto_base(tcat.auto_base_token(job, 0)) == jcat.parse_auto_base(jcat.auto_base_token(job, 0))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_record_written_by_either_package_is_read_by_the_other(tmp_path, writer):
    bucket = str(tmp_path)
    wmod, rmod = (jcat, tcat) if writer == "jax" else (tcat, jcat)
    rng = np.random.default_rng(1)
    recs = [
        wmod.CatalogRecord(
            name=f"s{i}", job="träiner/a" if i % 2 else "j", step=int(rng.integers(0, 100)),
            wall_time=float(rng.uniform(1e9, 2e9)), base=f"s{i - 1}" if i else None, chain_len=i,
            world_size=2, bytes_total=100 * i, bytes_written=10 * i, bytes_deduped=90 * i,
        )
        for i in range(4)
    ]
    with wmod.Catalog(bucket) as cat:
        assert all(cat.append(r) for r in recs)
        cat.pin("s1")
    # The same bytes as the reader's own serialization.
    for r in recs:
        with open(os.path.join(bucket, r.path), "rb") as f:
            theirs = rmod.CatalogRecord.from_json(f.read().decode())
        assert theirs.to_json() == r.to_json()
    assert _records(rmod, bucket) == _records(wmod, bucket)
    with rmod.Catalog(bucket) as rcat, wmod.Catalog(bucket) as wcat:
        assert rcat.pins() == wcat.pins() == {"s1"}
        for job in ("j", "träiner/a", "nope"):
            a, b = rcat.latest(job), wcat.latest(job)
            assert (a and a.to_json()) == (b and b.to_json())


def test_loaders_skip_newer_schema_and_junk_alike(tmp_path):
    bucket = str(tmp_path)
    with tcat.Catalog(bucket) as cat:
        cat.append(tcat.CatalogRecord(name="s1", job="j", step=1, wall_time=1.0))
    rec_dir = os.path.join(bucket, tcat.RECORD_DIR, "j")
    with open(os.path.join(rec_dir, "junk.json"), "w") as f:
        f.write("{not json")
    with open(os.path.join(rec_dir, "zzz.json"), "w") as f:
        f.write(tcat.CatalogRecord(name="s2", job="j", step=2, wall_time=2.0, schema=99).to_json())
    with tcat.Catalog(bucket) as cat:
        assert [r.name for r in cat.load()] == ["s1"] and cat.last_scan_skipped == 2
    assert _records(tcat, bucket) == _records(jcat, bucket)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_rebuild_writes_the_same_records_in_both_packages(tmp_path, writer):
    src = str(tmp_path / "src")
    for i in range(3):
        if writer == "jax":
            jts.Snapshot.take(f"{src}/step_{i}", _jstate(i), job="j", step=i)
        else:
            tts.Snapshot.take(f"{src}/step_{i}", _tstate(i), job="j", step=i)
    shutil.rmtree(os.path.join(src, tcat.CATALOG_DIR))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    with jcat.Catalog(a) as cat:
        jwritten = [r.to_json() for r in cat.rebuild()]
    with tcat.Catalog(b) as cat:
        twritten = [r.to_json() for r in cat.rebuild()]
        assert cat.rebuild() == []
    assert twritten == jwritten and len(twritten) == 3
    cat_a = {p: v for p, v in _files(a).items() if p.startswith(".catalog/")}
    cat_b = {p: v for p, v in _files(b).items() if p.startswith(".catalog/")}
    assert cat_a == cat_b
    assert _records(tcat, a) == _records(jcat, b)


# ---------------------------------------------------------------------------
# Retention grammar and math (the cases of tests/test_catalog.py)
# ---------------------------------------------------------------------------


def _cadence(mod):
    return [mod.CatalogRecord(name=f"s{i}", job="j", step=i, wall_time=1000000.0 + i * 20 * 60) for i in range(12)]


def _two_jobs(mod):
    return [mod.CatalogRecord(name=f"a{i}", job="a", step=i, wall_time=i) for i in range(4)] + [
        mod.CatalogRecord(name=f"b{i}", job="b", step=i, wall_time=i) for i in range(3)
    ]


def _synth(mod):
    return [mod.CatalogRecord(name="r0", job="j", step=50, wall_time=0.0)]


def _chain(mod):
    return [
        mod.CatalogRecord(name="s0", job="j", step=0, wall_time=0),
        mod.CatalogRecord(name="s1", job="j", step=1, wall_time=1, base="s0", chain_len=1),
        mod.CatalogRecord(name="s2", job="j", step=2, wall_time=2, base="s1", chain_len=2),
    ]


def _retention_case(mod, kind, spec, records, pins):
    try:
        policy = mod.RetentionPolicy.parse(spec)
    except ValueError as e:
        return ("ValueError", str(e))
    if kind == "parse":
        return (policy.last, policy.hourly, policy.daily, policy.job_globs)
    recs = records(mod)
    if kind == "retained":
        return sorted(policy.retained(recs))
    if kind == "chain_of":
        return [[r.name for r in mod.chain_of(recs, n)] for n in ("s0", "s1", "s2", "zz")]
    plan = mod.plan_retention(recs, pins=set(pins), policy=policy)
    return (plan.retained, plan.condemned, plan.pinned, plan.by_job)


@pytest.mark.parametrize(
    "kind,spec,records,pins",
    [
        ("parse", "last=3, hourly=24 ,daily=7,job=tr-*", None, ()),
        ("parse", "", None, ()),
        ("parse", "last", None, ()),
        ("parse", "last=x", None, ()),
        ("parse", "last=-1", None, ()),
        ("parse", "weekly=2", None, ()),
        ("parse", "job=a,job=b*,last=0", None, ()),
        ("retained", "last=2", _cadence, ()),
        ("retained", "hourly=2", _cadence, ()),
        ("retained", "daily=1,hourly=1", _cadence, ()),
        ("retained", "", _cadence, ()),
        ("retained", "hourly=5", _synth, ()),
        ("retained", "last=1", _synth, ()),
        ("plan", "last=1", _two_jobs, ("a0",)),
        ("plan", "last=1,job=a", _two_jobs, ()),
        ("plan", "last=2,job=b*", _two_jobs, ("b0", "zz")),
        ("plan", "", _two_jobs, ()),
        ("chain_of", "", _chain, ()),
    ],
    ids=lambda v: v.__name__ if callable(v) else None,
)
def test_retention_grammar_and_math_match_the_jax_package(kind, spec, records, pins):
    got = _retention_case(tcat, kind, spec, records, pins)
    want = _retention_case(jcat, kind, spec, records, pins)
    assert got == want


# ---------------------------------------------------------------------------
# Managed chains end to end
# ---------------------------------------------------------------------------


def test_job_take_chains_and_rebases_like_the_jax_package(tmp_path):
    tb, jb = str(tmp_path / "t"), str(tmp_path / "j")
    for i in range(6):
        kw = dict(job="j", step=i, max_chain_len=2)
        if i % 3 == 2:
            tts.Snapshot.async_take(f"{tb}/step_{i}", _tstate(i), **kw).wait()
        else:
            tts.Snapshot.take(f"{tb}/step_{i}", _tstate(i), **kw)
        jts.Snapshot.take(f"{jb}/step_{i}", _jstate(i), **kw)
    trecs, jrecs = _records(tcat, tb), _records(jcat, jb)
    strip = lambda recs: [{k: v for k, v in r.items() if k != "wall_time"} for r in recs]  # noqa: E731
    assert strip(trecs) == strip(jrecs)
    assert [(r["name"], r["base"], r["chain_len"]) for r in trecs] == [
        ("step_0", None, 0), ("step_1", "step_0", 1), ("step_2", "step_1", 2),
        ("step_3", None, 0), ("step_4", "step_3", 1), ("step_5", "step_4", 2),
    ]
    # The chain dedups for real: frozen shares one inode along each chain.
    ino = lambda n: os.stat(os.path.join(tb, n, "0", "m", "frozen")).st_ino  # noqa: E731
    assert ino("step_0") == ino("step_1") == ino("step_2") != ino("step_3") == ino("step_5")
    assert trecs[1]["bytes_deduped"] == FROZEN.nbytes
    assert trecs[1]["bytes_total"] == trecs[1]["bytes_written"] + trecs[1]["bytes_deduped"]
    for i in range(6):
        _assert_restores(f"{tb}/step_{i}", i)


def test_cold_process_scan_and_other_jobs_and_explicit_base(tmp_path):
    bucket = str(tmp_path)
    tts.Snapshot.take(f"{bucket}/a_0", _tstate(0), job="a", step=0)
    # A chain head written by the JAX package, found by a cold scan.
    jts.Snapshot.take(f"{bucket}/b_0", _jstate(0), job="b", step=0)
    tcat._CHAIN_CACHE.clear()
    tts.Snapshot.take(f"{bucket}/b_1", _tstate(1), job="b", step=1)
    by_name = {r["name"]: r for r in _records(tcat, bucket)}
    assert by_name["b_1"]["base"] == "b_0" and by_name["b_1"]["chain_len"] == 1
    assert by_name["b_1"]["bytes_deduped"] == FROZEN.nbytes
    # An explicit base wins, and records a chain of 1.
    tts.Snapshot.take(f"{bucket}/b_2", _tstate(2), job="b", step=2, base=f"{bucket}/a_0")
    rec = {r["name"]: r for r in _records(jcat, bucket)}["b_2"]
    assert rec["base"] == "a_0" and rec["chain_len"] == 1
    # The JAX package continues the port's chain from its own cold scan.
    jcat._CHAIN_CACHE.clear()
    jts.Snapshot.take(f"{bucket}/b_3", _jstate(3), job="b", step=3)
    assert {r["name"]: r for r in _records(jcat, bucket)}["b_3"]["base"] == "b_2"
    _assert_restores(f"{bucket}/b_3", 3)


def test_take_without_job_is_the_jax_package_with_its_catalog_disabled(tmp_path):
    # The port has no catalog switch: a take without ``job=`` is what the
    # JAX package's ``job=`` take is with its catalog turned off.
    tb, jb = str(tmp_path / "t"), str(tmp_path / "j")
    for i in range(2):
        tts.Snapshot.take(f"{tb}/step_{i}", _tstate(i))
        with jknobs.override_catalog(False):
            jts.Snapshot.take(f"{jb}/step_{i}", _jstate(i), job="j", step=i)
    for bucket in (tb, jb):
        assert sorted(os.listdir(bucket)) == ["step_0", "step_1"]
        ino = lambda n: os.stat(os.path.join(bucket, n, "0", "m", "frozen")).st_ino  # noqa: E731
        assert ino("step_0") != ino("step_1")  # both full
    assert not tcat._CHAIN_CACHE and not jcat._CHAIN_CACHE
    _assert_restores(f"{tb}/step_1", 1)
    _assert_restores(f"{jb}/step_1", 1)


def test_snapshot_at_a_root_goes_unrecorded(caplog):
    with caplog.at_level("WARNING", logger="torchsnapshot_tpu_torch.snapshot"):
        tts.Snapshot.take("memory://torch-rootsnap", _tstate(0), job="j", step=0)
    assert any("no parent bucket" in r.message for r in caplog.records)
    out = tts.StateDict(frozen=torch.zeros(4000), lora=torch.zeros(64), step=-1)
    tts.Snapshot("memory://torch-rootsnap").restore({"m": out}, device="cpu")
    assert out["step"] == 0


def test_stale_chain_head_degrades_to_a_full_take(tmp_path, caplog):
    bucket = str(tmp_path)
    tts.Snapshot.take(f"{bucket}/step_0", _tstate(0), job="j", step=0)
    assert tcat._CHAIN_CACHE
    shutil.rmtree(f"{bucket}/step_0")
    with caplog.at_level("WARNING", logger="torchsnapshot_tpu_torch.snapshot"):
        tts.Snapshot.take(f"{bucket}/step_1", _tstate(1), job="j", step=1)
    assert any("full snapshot" in r.message for r in caplog.records)
    _assert_restores(f"{bucket}/step_1", 1)


def test_auto_base_skips_zombie_records(tmp_path):
    bucket = str(tmp_path)
    tts.Snapshot.take(f"{bucket}/step_0", _tstate(0), job="j", step=0)
    tts.Snapshot.take(f"{bucket}/step_1", _tstate(1), job="j", step=1)
    os.remove(f"{bucket}/step_1/.snapshot_metadata")
    tcat._CHAIN_CACHE.clear()
    assert tcat.resolve_auto_base(tcat.auto_base_token("j", 4), f"{bucket}/step_2") == jcat.resolve_auto_base(
        jcat.auto_base_token("j", 4), f"{bucket}/step_2"
    ) == (f"{bucket}/step_0", 0)
    tcat._CHAIN_CACHE.clear()
    tts.Snapshot.take(f"{bucket}/step_2", _tstate(2), job="j", step=2)
    assert {r["name"]: r["base"] for r in _records(tcat, bucket)}["step_2"] == "step_0"


def test_append_failure_is_fail_open(tmp_path, caplog):
    bucket = str(tmp_path)
    os.makedirs(os.path.join(bucket, tcat.CATALOG_DIR))
    with open(os.path.join(bucket, tcat.RECORD_DIR), "w") as f:
        f.write("squatter")  # no record directory can be made
    with caplog.at_level("WARNING"):
        snap = tts.Snapshot.take(f"{bucket}/step_0", _tstate(0), job="j", step=0)
        tts.Snapshot.async_take(f"{bucket}/step_1", _tstate(1), job="j", step=1).wait()
    assert snap.verify() == {}
    assert any("catalog append" in r.message for r in caplog.records)
    _assert_restores(f"{bucket}/step_0", 0)
    _assert_restores(f"{bucket}/step_1", 1)


# ---------------------------------------------------------------------------
# Retention and gc: the same deletions as the JAX package
# ---------------------------------------------------------------------------


def _lifecycle_bucket(bucket: str, writer: str, monkeypatch) -> None:
    """Four chained takes, the fourth compressed and framed (``.ftab``
    tables), a pin, planted step-telemetry records (one of a condemned
    snapshot, one of a kept one), and crash debris."""
    for i in range(4):
        compressed = i == 3
        env = {}
        if compressed:
            env = {
                "TSS_TORCH_COMPRESSION": "zlib", "TSS_TORCH_COMPRESSION_FRAME_BYTES": "4096",
                "TORCHSNAPSHOT_TPU_COMPRESSION": "zlib", "TORCHSNAPSHOT_TPU_COMPRESSION_FRAME_BYTES": "4096",
            }
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        if writer == "jax":
            jts.Snapshot.take(f"{bucket}/step_{i}", _jstate(i), job="j", step=i)
        else:
            tts.Snapshot.take(f"{bucket}/step_{i}", _tstate(i), job="j", step=i)
        for k in env:
            monkeypatch.delenv(k)
    tts.Snapshot.take(f"{bucket}/other_0", _tstate(9), job="other", step=0)
    assert any(p.endswith(".ftab") for p in _files(f"{bucket}/step_3"))
    with tcat.Catalog(bucket) as cat:
        cat.pin("step_0")
    for name in ("step_1", "step_3"):
        path = os.path.join(bucket, tcat.STEP_TELEMETRY_DIR, "j", f"{name}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"name": name, "job": "j"}, f)
    os.makedirs(f"{bucket}/torn/0")
    for p in (f"{bucket}/torn/0/obj.tmp.1", f"{bucket}/loose.tmp", f"{bucket}/step_3/0/m/x.tmp.2"):
        with open(p, "w") as f:
            f.write("x")
    with open(os.path.join(bucket, tcat.CATALOG_DIR, "notes.txt"), "w") as f:
        f.write("unclassifiable")


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("mode", ["retain", "debris", "keep_roots"])
def test_retain_and_gc_delete_what_the_jax_package_deletes(tmp_path, monkeypatch, writer, mode):
    src = str(tmp_path / "src")
    _lifecycle_bucket(src, writer, monkeypatch)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")  # a: JAX package, b: port
    shutil.copytree(src, a)
    shutil.copytree(src, b)

    def run(mod, snapshot_cls, bucket, dry_run):
        if mode == "retain":
            return mod.retain(bucket, mod.RetentionPolicy.parse("last=2"), dry_run=dry_run)
        keep = {"step_3", "other_0"} if mode == "keep_roots" else None
        return snapshot_cls.gc(bucket, dry_run=dry_run, keep_roots=keep)

    for dry_run in (True, False):
        want = run(jcat, jts.Snapshot, a, dry_run)
        got = run(tcat, tts.Snapshot, b, dry_run)
        assert got == want
        assert sorted(_files(b)) == sorted(_files(a))
    assert want["removed"] > 0
    assert ".catalog/notes.txt" in _files(b)
    if mode == "retain":
        assert want["condemned"] == ["step_1"]  # pinned step_0 and other_0 kept
        assert not any("step_1" in p for p in _files(b))
    if mode == "keep_roots":
        assert want["condemned"] == ["step_1", "step_2"]
    if mode == "debris":
        assert {"torn/0/obj.tmp.1", "loose.tmp", "step_3/0/m/x.tmp.2"} <= set(want["remove"])
    for i in (0, 3):
        _assert_restores(f"{b}/step_{i}", i)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_crash_convergence_of_a_zombie_and_a_stale_record(tmp_path, pkg):
    """A zombie (metadata gone, tree and record left) and a stale record
    (tree gone) converge in one run, to what the JAX package leaves."""
    src = str(tmp_path / "src")
    for i in range(3):
        (jts if pkg == "jax" else tts).Snapshot.take(
            f"{src}/step_{i}", _jstate(i) if pkg == "jax" else _tstate(i), job="j", step=i
        )
    os.remove(f"{src}/step_0/.snapshot_metadata")
    shutil.rmtree(f"{src}/step_1")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    want = jcat.retain(a, jcat.RetentionPolicy.parse("last=3"), dry_run=False)
    got = tcat.retain(b, tcat.RetentionPolicy.parse("last=3"), dry_run=False)
    assert got == want and got["removed"] > 0
    assert sorted(_files(b)) == sorted(_files(a))
    assert not os.path.exists(f"{b}/step_0")
    assert [r["name"] for r in _records(tcat, b)] == ["step_2"]
    again = tcat.retain(b, tcat.RetentionPolicy.parse("last=3"), dry_run=False)
    assert again["removed"] == 0 and again["remove"] == [] and again["remove_records"] == []
    _assert_restores(f"{b}/step_2", 2)


def test_validate_chain_closure_refuses_an_unreadable_retained_snapshot(tmp_path):
    bucket = str(tmp_path)
    for i in range(2):
        tts.Snapshot.take(f"{bucket}/step_{i}", _tstate(i), job="j", step=i)
    tcat.validate_chain_closure(bucket, ["step_0", "step_1"], [])
    os.remove(f"{bucket}/step_1/.snapshot_metadata")
    for mod in (tcat, jcat):
        with pytest.raises(RuntimeError, match="refusing"):
            mod.validate_chain_closure(bucket, ["step_1"], ["step_0"])
    with pytest.raises(RuntimeError, match="refusing"):
        tcat.retain(bucket, tcat.RetentionPolicy.parse("last=1"), dry_run=False)
    assert os.path.exists(f"{bucket}/step_0/.snapshot_metadata")


def test_gc_keep_roots_rejected_on_a_single_root(tmp_path):
    path = str(tmp_path / "snap")
    tts.Snapshot.take(path, _tstate(0))
    with pytest.raises(ValueError, match="keep_roots"):
        tts.Snapshot.gc(path, keep_roots={"x"})
    open(os.path.join(path, "0", "m", "y.tmp.1"), "w").close()
    assert tts.Snapshot.gc(path) == jts.Snapshot.gc(path)
    assert tts.Snapshot.gc(path, dry_run=False)["remove"] == ["0/m/y.tmp.1"]
    _assert_restores(path, 0)


def test_retention_over_memory_buckets(request):
    """``memory://`` snapshots live in their own stores: the catalog's
    names are how retention finds them."""
    bucket = f"memory://ret-{request.node.name}"
    for i in range(4):
        tts.Snapshot.take(f"{bucket}/step_{i}", _tstate(i), job="j", step=i)
    report = tcat.retain(bucket, tcat.RetentionPolicy.parse("last=2"), dry_run=False)
    assert report["condemned"] == ["step_0", "step_1"]
    assert [r["name"] for r in _records(tcat, bucket)] == ["step_2", "step_3"]
    for i in (2, 3):
        out = tts.StateDict(frozen=torch.zeros(4000), lora=torch.zeros(64), step=-1)
        tts.Snapshot(f"{bucket}/step_{i}").restore({"m": out}, device="cpu")
        assert out["step"] == i
    with pytest.raises(tts.CheckpointAbortedError) as info:
        tts.Snapshot(f"{bucket}/step_0").restore({"m": tts.StateDict()}, device="cpu")
    assert info.value.phase == "restore.plan" and isinstance(info.value.__cause__, FileNotFoundError)


def test_continuous_drive_on_cpu(tmp_path):
    """``dryrun.continuous_checkpoints`` at a small size: chains, retention,
    bit-exact restores (direct and through a read cache) and the sweep."""
    from torchsnapshot_tpu_torch import dryrun
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=128, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=16)
    out = dryrun.continuous_checkpoints(cfg, str(tmp_path), device="cpu", batch=2, frozen_blocks=2)
    assert out["chain_lens"] == [0, 1, 2, 0, 1, 2]
    assert out["retain_applied"]["condemned"] == ["t1", "t2", "t3", "t4"]
    assert out["takes"]["t4"]["cache"]["prepared_cache_hit"]
    t6 = out["takes"]["t6"]["record"]
    assert 0 < t6["bytes_deduped"] and t6["bytes_written"] + t6["bytes_deduped"] == t6["bytes_total"]
    assert out["t6_cached_attribution"]["origin_bytes"] == t6["bytes_written"]
    assert out["bucket_bytes_after"][1] < out["bucket_bytes_before"][1]
    assert out["gc"]["applied"]["removed"] == 2


# ---------------------------------------------------------------------------
# Two ranks agree on the auto-resolved base, across plan-cache hits
# ---------------------------------------------------------------------------


def _two_rank_chain_worker(rank, world_size, bucket):
    os.environ["TSS_TORCH_DEDUP_DIGESTS"] = "1"
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch import catalog
    from torchsnapshot_tpu_torch import snapshot as snapshot_mod

    frozen = torch.arange(2048, dtype=torch.float32) + rank
    lora = torch.zeros(32)
    app = {"m": tts.StateDict(frozen=frozen, lora=lora, step=0)}
    seen = []
    for i in range(5):
        lora.fill_(float(i))
        app["m"]["step"] = i
        path = os.path.join(bucket, f"step_{i}")
        if i == 4:
            catalog._CHAIN_CACHE.clear()  # rank 0 scans; rank 1 learns it
        if i % 2:
            pending = tts.Snapshot.async_take(path, app, job="j", step=i, max_chain_len=2)
            hit = snapshot_mod.LAST_TAKE_CACHE["plan_cache_hit"]
            pending.wait()
            stats = pending.drain_stats
        else:
            tts.Snapshot.take(path, app, job="j", step=i, max_chain_len=2)
            hit = snapshot_mod.LAST_TAKE_CACHE["plan_cache_hit"]
            stats = snapshot_mod.LAST_SYNC_DRAIN_STATS
        seen.append((hit, stats.get("bytes_deduped", 0)))
    # Every delta linked this rank's frozen tensor from the base.
    hits = [h for h, _ in seen]
    assert hits == [False, True, True, True, True], hits
    deduped = [d for _, d in seen]
    assert deduped[0] == 0 and deduped[3] == 0, deduped  # step_0 and the rebase are full
    for i in (1, 2, 4):
        assert deduped[i] >= frozen.numel() * 4, (i, deduped)
    base_of = {"step_1": "step_0", "step_2": "step_1", "step_4": "step_3"}
    for name, base in base_of.items():
        assert os.stat(os.path.join(bucket, name, str(rank), "m", "frozen")).st_ino == os.stat(
            os.path.join(bucket, base, str(rank), "m", "frozen")
        ).st_ino
    for i in range(5):
        tgt = {"m": tts.StateDict(frozen=torch.zeros(2048), lora=torch.zeros(32), step=-1)}
        tts.Snapshot(os.path.join(bucket, f"step_{i}")).restore(tgt, device="cpu")
        assert tgt["m"]["step"] == i and torch.equal(tgt["m"]["frozen"], frozen)
        assert torch.equal(tgt["m"]["lora"], torch.full((32,), float(i)))


def test_two_ranks_agree_on_the_auto_resolved_base(tmp_path):
    from torchsnapshot_tpu_torch.test_utils import run_with_processes

    bucket = str(tmp_path)
    run_with_processes(_two_rank_chain_worker, 2, args=(bucket,), timeout_s=120)
    recs = _records(jcat, bucket)
    assert [(r["name"], r["base"], r["chain_len"], r["world_size"]) for r in recs] == [
        ("step_0", None, 0, 2), ("step_1", "step_0", 1, 2), ("step_2", "step_1", 2, 2),
        ("step_3", None, 0, 2), ("step_4", "step_3", 1, 2),
    ]
    assert all(r["bytes_deduped"] == 2 * 2048 * 4 for r in recs if r["base"])

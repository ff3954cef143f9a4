"""Operator CLI: inspect and audit snapshots without writing code.

The port's copy of ``python -m torchsnapshot_tpu``: the same subcommands,
arguments and output, over the port's modules (a snapshot written by
either package reads through either CLI). Subcommands:

    python -m torchsnapshot_tpu_torch ls <snapshot-path>
        List the global manifest: one line per entry with its type, dtype,
        shape, and storage location.

    python -m torchsnapshot_tpu_torch cat <snapshot-path> <rank/logical/path>
        Print one persisted value (numpy repr for arrays, read on the CPU)
        via the same ranged-read path as ``Snapshot.read_object``.

    python -m torchsnapshot_tpu_torch verify <snapshot-path>
        CRC32-audit every storage object against the recorded sidecars;
        exit code 1 if any problem is found.

    python -m torchsnapshot_tpu_torch scrub <snapshot-path> [--repair] [--json]
        Deep integrity sweep: stream every committed object through the
        budgeted read machinery and validate bytes against the sidecar
        digests (size + sha256/crc32) AND every ``.ftab`` frame table;
        prints a per-entry report. ``--repair`` rewrites corrupt/missing
        objects from a verified identical-content copy elsewhere in the
        snapshot (an alternate rank's replica) and quarantines unrepairable
        corrupt objects so restores fail fast instead of consuming rot.
        Exit code 1 if unresolved problems remain. See docs/robustness.md.

    python -m torchsnapshot_tpu_torch trace <snapshot-path> [-o trace.json]
        Traced read of every storage object the manifest references, under
        the usual memory budget + IO concurrency caps; writes a Chrome/
        Perfetto trace (open at https://ui.perfetto.dev) and prints the
        slowest objects + the metrics summary. The per-object spans come
        from the storage plugin itself, so what you see is what a restore
        pays per request.

    python -m torchsnapshot_tpu_torch gc <path> [--apply] [--policy SPEC]
        Reclaim crash debris: whole uncommitted snapshot trees (no
        ``.snapshot_metadata`` — invisible to readers by the atomic-commit
        contract) and files a committed manifest does not reference (temp
        files and data objects of torn takes). Dry-run by default; --apply
        deletes. With ``--policy`` (e.g. ``last=5,hourly=24``) the run is
        RETENTION-driven instead: snapshots the bucket's catalog records
        that the per-job policy drops are condemned and collected whole
        (crash-convergent deletion order; pins always survive; in-flight
        takes untouched). See docs/robustness.md and docs/lifecycle.md.

    python -m torchsnapshot_tpu_torch catalog {ls,pin,unpin,retain,rebuild} ...
        The bucket's snapshot catalog (docs/lifecycle.md): ``ls`` lists
        committed snapshots with their job, step, delta-chain shape and
        byte attribution; ``pin``/``unpin`` exempt a snapshot from every
        retention policy; ``retain --policy SPEC [--apply]`` applies a
        policy; ``rebuild`` reconstructs missing records by scanning the
        bucket (the catalog is advisory — scan-reconstructable by design).

    python -m torchsnapshot_tpu_torch stats <snapshot-path> [--trace out.json]
        Fleet view from the persisted ``.telemetry/rank_*.json`` artifacts
        alone (no live process needed): per-rank phase/byte breakdown,
        throughput, straggler identification, and commit-barrier wait
        attribution. ``--trace`` additionally writes the merged multi-rank
        Chrome/Perfetto trace (pid = rank). ``--op restore`` reads the
        restore-side artifacts instead.

    python -m torchsnapshot_tpu_torch compare <a> <b>
        Side-by-side deltas of two snapshots' aggregated telemetry (phase
        maxima, bytes, throughput, skew) — how a perf change moved the
        checkpoint, from the checkpoints themselves.

    python -m torchsnapshot_tpu_torch timeline <bucket> --job <j>
        Job-lifetime trend view from the per-step telemetry records the
        catalog keeps beside each ``take(job=, step=)`` commit: one row per
        step (stall, drain wall, throughput, bytes, preemptions, skew) with
        the health detectors' anomalies flagged in place (stall spike,
        drain cliff, streaming inversion, straggler drift). Exit code 1
        when any anomaly is flagged. See docs/observability.md.

    python -m torchsnapshot_tpu_torch monitor [dump.json]
        Render a live flight-recorder dump (written continuously when
        ``TSS_TORCH_RECORDER_DUMP`` is set): recent engine
        occupancy/budget samples and pause/stall events of the in-flight
        operation — introspection for a job that is still running.

Works against any storage URL the port supports (local path, memory://).
"""

from __future__ import annotations

import argparse
import sys


def _cmd_ls(args: argparse.Namespace) -> int:
    from .snapshot import Snapshot

    snap = Snapshot(args.path)
    for key, entry in sorted(snap.get_manifest().items()):
        kind = type(entry).__name__.replace("Entry", "").lower()
        detail = ""
        dtype = getattr(entry, "dtype", None)
        shape = getattr(entry, "shape", None)
        if dtype is not None and shape is not None:
            detail = f" {dtype}{list(shape)}"
        detail += _locations_detail(entry)
        print(f"{key}  [{kind}]{detail}")
    return 0


def _locations_detail(entry) -> str:
    """Storage location(s): on the entry itself for plain arrays/objects,
    per-member for chunked/sharded entries."""
    loc = getattr(entry, "location", "")
    if loc:
        detail = f" @ {loc}"
        byte_range = getattr(entry, "byte_range", None)
        if byte_range:
            detail += f"[{byte_range[0]}:{byte_range[1]}]"
        return detail
    members = [
        m.tensor.location
        for m in (getattr(entry, "chunks", None) or getattr(entry, "shards", None) or [])
    ]
    if not members:
        return ""
    extra = f" (+{len(members) - 2} more)" if len(members) > 2 else ""
    return f" @ {', '.join(members[:2])}{extra}"


def _cmd_cat(args: argparse.Namespace) -> int:
    from .snapshot import Snapshot

    value = Snapshot(args.path).read_object(
        args.object, memory_budget_bytes=args.memory_budget_bytes, device="cpu"
    )
    print(repr(_as_numpy(value)))
    return 0


def _as_numpy(value):
    """Tensors (in nested containers too) as numpy arrays, so a value
    prints as the JAX package's CLI prints it; a dtype numpy lacks keeps
    its torch repr."""
    import torch

    if isinstance(value, torch.Tensor):
        try:
            return value.numpy()
        except TypeError:
            return value
    if isinstance(value, dict):
        return type(value)((k, _as_numpy(v)) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return type(value)(_as_numpy(v) for v in value)
    return value


def _cmd_verify(args: argparse.Namespace) -> int:
    from .snapshot import Snapshot

    problems = Snapshot(args.path).verify()
    if not problems:
        print("clean")
        return 0
    for path, problem in sorted(problems.items()):
        print(f"{path}: {problem}", file=sys.stderr)
    print(f"{len(problems)} problem(s) found", file=sys.stderr)
    return 1


def _cmd_scrub(args: argparse.Namespace) -> int:
    import json

    from .snapshot import Snapshot

    report = Snapshot(args.path).scrub(repair=args.repair)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0 if report["clean"] else 1
    for path, e in sorted(report["entries"].items()):
        if e["status"] == "ok":
            continue
        detail = f" ({e['detail']})" if e["detail"] else ""
        line = f"{path}: {e['status']}{detail}"
        if e["status"] == "repaired":
            print(line)
        else:
            print(line, file=sys.stderr)
    print(
        f"scrubbed {report['objects']} object(s), "
        f"{report['bytes'] / 1e9:.3f} GB: "
        f"{report['problems']} problem(s), "
        f"{report['repaired']} repaired, "
        f"{report['quarantined']} quarantined"
    )
    return 0 if report["clean"] else 1


def _cmd_trace(args: argparse.Namespace) -> int:
    import asyncio

    from . import telemetry
    from .utils import knobs
    from .io_types import ReadIO
    from .snapshot import Snapshot, _manifest_storage_locations
    from .storage_plugin import url_to_storage_plugin

    tm = telemetry.Telemetry()
    prev = telemetry.activate(tm)
    event_loop = asyncio.new_event_loop()
    try:
        snap = Snapshot(args.path)
        storage = url_to_storage_plugin(args.path)
        try:
            with telemetry.span("trace.read_metadata", cat="cli"):
                metadata = snap._read_metadata(storage, event_loop)
            locations = sorted(_manifest_storage_locations(metadata.manifest))

            async def read_all() -> int:
                # Object sizes aren't known before the read, so the memory
                # guard is a conservative one: at most 8 whole-object reads
                # in flight (each treated as one-eighth of the budget),
                # further capped by the IO-concurrency knob — tracing a
                # snapshot of 512 MB shards can't OOM a small operator VM.
                sem = asyncio.Semaphore(min(8, knobs.get_max_concurrent_io_for(storage)))
                total = 0

                async def read_one(path: str) -> None:
                    nonlocal total
                    async with sem:
                        read_io = ReadIO(path=path)
                        await storage.read(read_io)
                        total += memoryview(read_io.buf).nbytes

                await asyncio.gather(*(read_one(p) for p in locations))
                return total

            with telemetry.span(
                "trace.read_objects", cat="cli", objects=len(locations)
            ):
                total = event_loop.run_until_complete(read_all())
        finally:
            storage.sync_close(event_loop)
    finally:
        telemetry.deactivate(tm, prev)
        event_loop.close()

    telemetry.write_chrome_trace(tm, args.output)
    reads = sorted(
        tm.spans(name="storage.read"), key=lambda s: -(s.dur or 0.0)
    )
    print(f"read {len(locations)} object(s), {total / 1e9:.3f} GB")
    for sp in reads[:10]:
        print(
            f"  {sp.dur or 0.0:8.3f}s  {sp.attrs.get('nbytes', 0) / 1e6:10.2f} MB"
            f"  {sp.attrs.get('path', '?')}"
        )
    metrics = tm.metrics.as_dict()
    if metrics:
        print("metrics:")
        for k in sorted(metrics):
            print(f"  {k} = {metrics[k]}")
    if tm.buffer.dropped:
        print(
            f"warning: trace truncated — {tm.buffer.dropped} span(s) dropped "
            f"past the {tm.buffer.capacity}-span buffer capacity"
        )
    print(f"trace written to {args.output} (open at https://ui.perfetto.dev)")
    return 0


def _cmd_gc(args: argparse.Namespace) -> int:
    from .snapshot import Snapshot

    if args.policy is not None:
        from . import catalog as catalog_mod

        report = catalog_mod.retain(
            args.path,
            catalog_mod.RetentionPolicy.parse(args.policy),
            dry_run=not args.apply,
        )
        return _print_retention_report(report, apply=args.apply)
    report = Snapshot.gc(args.path, dry_run=not args.apply)
    for root in report["committed"]:
        print(f"committed: {root or '.'}")
    for root in report["uncommitted"]:
        print(f"uncommitted (whole tree is debris): {root or '.'}")
    verb = "removed" if args.apply else "would remove"
    for p in report["remove"]:
        print(f"{verb}: {p}")
    print(
        f"{len(report['keep'])} file(s) kept, "
        f"{len(report['remove'])} debris file(s) "
        f"{'removed' if args.apply else 'found (dry run; pass --apply to delete)'}"
    )
    return 0


def _print_retention_report(report, apply: bool) -> int:
    policy = report["policy"]
    for name in policy["retained"]:
        pin = " [pinned]" if name in policy["pinned"] else ""
        print(f"retained: {name}{pin}")
    verb = "condemned (deleted)" if apply else "condemned (dry run)"
    for name in policy["condemned"]:
        print(f"{verb}: {name}")
    print(
        f"{len(policy['retained'])} snapshot(s) retained, "
        f"{len(policy['condemned'])} condemned, "
        f"{report['removed'] if apply else len(report['remove'])} file(s) "
        f"{'removed' if apply else 'to remove (dry run; pass --apply to delete)'}"
    )
    return 0


def _cmd_catalog(args: argparse.Namespace) -> int:
    import json

    from . import catalog as catalog_mod

    if args.catalog_cmd == "ls":
        with catalog_mod.Catalog(args.path) as cat:
            records = cat.load(job=args.job)
            pins = cat.pins()
        if args.json:
            print(
                json.dumps(
                    [json.loads(r.to_json()) for r in records], indent=2
                )
            )
            return 0
        if not records:
            print("no catalog records (run `catalog rebuild` to scan)")
            return 0
        for r in records:
            base = f" base={r.base} chain={r.chain_len}" if r.base else " full"
            pin = " [pinned]" if r.name in pins else ""
            attr = (
                f" {r.bytes_total / 1e6:.1f} MB"
                f" ({r.bytes_written / 1e6:.1f} new)"
                if r.bytes_total
                else ""
            )
            print(
                f"{r.name}  job={r.job or '-'} step={r.step}{base}{attr}{pin}"
            )
        return 0
    if args.catalog_cmd == "pin":
        with catalog_mod.Catalog(args.path) as cat:
            cat.pin(args.name)
        print(f"pinned: {args.name}")
        return 0
    if args.catalog_cmd == "unpin":
        with catalog_mod.Catalog(args.path) as cat:
            existed = cat.unpin(args.name)
        print(f"unpinned: {args.name}" if existed else f"not pinned: {args.name}")
        return 0
    if args.catalog_cmd == "rebuild":
        with catalog_mod.Catalog(args.path) as cat:
            written = cat.rebuild()
        for r in written:
            print(f"reconstructed: {r.name} (step {r.step})")
        print(f"{len(written)} record(s) reconstructed")
        return 0
    if args.catalog_cmd == "retain":
        report = catalog_mod.retain(
            args.path,
            catalog_mod.RetentionPolicy.parse(args.policy),
            dry_run=not args.apply,
        )
        return _print_retention_report(report, apply=args.apply)
    raise AssertionError(args.catalog_cmd)


def _cmd_stats(args: argparse.Namespace) -> int:
    from . import telemetry
    from .telemetry import aggregate as agg_mod

    with telemetry.span("stats.read_artifacts", cat="cli", path=args.path):
        world_size, artifacts, problems = agg_mod.read_snapshot_artifacts(
            args.path, op=args.op
        )
    if not artifacts:
        detail = "; ".join(f"rank {r}: {p}" for r, p in sorted(problems.items()))
        raise RuntimeError(
            f"no telemetry artifacts readable under {args.path}/.telemetry "
            f"({detail or 'none present'}) — the snapshot predates artifact "
            "persistence or was taken with "
            "TSS_TORCH_TELEMETRY_ARTIFACTS=0"
        )
    agg = agg_mod.aggregate(artifacts, world_size=world_size)
    for line in agg_mod.format_stats(agg):
        print(line)
    for r, problem in sorted(problems.items()):
        if problem != "missing":  # missing ranks already noted by format_stats
            print(
                f"note: rank {r} artifact {problem} — aggregation degraded",
                file=sys.stderr,
            )
    if agg["spans_dropped"]:
        print(
            f"warning: traces truncated — {agg['spans_dropped']} span(s) "
            "dropped past the trace-buffer capacity across ranks"
        )
    if args.trace:
        agg_mod.write_merged_chrome_trace(artifacts, args.trace)
        print(
            f"multi-rank trace written to {args.trace} "
            "(pid = rank; open at https://ui.perfetto.dev)"
        )
    return 0


def _cmd_compare(args: argparse.Namespace) -> int:
    from . import telemetry
    from .telemetry import aggregate as agg_mod

    aggs = []
    for path in (args.a, args.b):
        with telemetry.span("stats.read_artifacts", cat="cli", path=path):
            world_size, artifacts, problems = agg_mod.read_snapshot_artifacts(
                path, op=args.op
            )
        if not artifacts:
            raise RuntimeError(
                f"no telemetry artifacts readable under {path}/.telemetry"
            )
        for r, problem in sorted(problems.items()):
            print(
                f"note: {path}: rank {r} artifact {problem} — comparison "
                "degraded",
                file=sys.stderr,
            )
        aggs.append(agg_mod.aggregate(artifacts, world_size=world_size))
    for line in agg_mod.diff_stats(aggs[0], aggs[1], label_a="A", label_b="B"):
        print(line)
    print(f"A = {args.a}")
    print(f"B = {args.b}")
    return 0


def _cmd_timeline(args: argparse.Namespace) -> int:
    import json

    from . import catalog as catalog_mod
    from .telemetry import health

    with catalog_mod.Catalog(args.path) as cat:
        series = cat.load_step_telemetry(job=args.job)
    if not series:
        print(
            f"no step-telemetry records for job {args.job!r} under "
            f"{args.path} (takes must pass job=/step=, with "
            "TSS_TORCH_STEP_TELEMETRY and "
            "TSS_TORCH_TELEMETRY_ARTIFACTS enabled)"
        )
        return 0
    anomalies = health.detect_anomalies(series)
    if args.last:
        series = series[-args.last :]
        shown = {r.get("step") for r in series}
        anomalies = [a for a in anomalies if a.get("step") in shown]
    if args.json:
        print(
            json.dumps(
                {"job": args.job, "series": series, "anomalies": anomalies},
                indent=2,
                sort_keys=True,
            )
        )
        return 1 if anomalies else 0
    print(f"job {args.job}: {len(series)} step(s)")
    for line in health.render_timeline(series, anomalies):
        print(line)
    return 1 if anomalies else 0


def _cmd_fleet_monitor(args: argparse.Namespace) -> int:
    """``monitor --fleet``: render live beacons from the coordinator store
    instead of a flight-recorder dump. Shares timeline's exit contract —
    always 0 unless the store itself is unreachable (global handler, 2)."""
    import json
    import time as _time

    from .telemetry import aggregate, export, fleet

    store = fleet.connect(args.fleet)
    rounds = max(1, int(args.watch or 1))
    history: list = []
    view = None
    for i in range(rounds):
        beacons = fleet.read_beacons(store)
        history.extend(beacons.values())
        view = aggregate.fleet_view(beacons)
        if args.json:
            print(json.dumps(view, indent=2, sort_keys=True))
        else:
            if rounds > 1:
                print(f"--- round {i + 1}/{rounds} ---")
            for line in aggregate.format_fleet(view):
                print(line)
        if i + 1 < rounds:
            _time.sleep(max(0.05, view.get("interval_s") or 0.5))
    if args.trace:
        export.write_trace_obj(export.fleet_beacon_trace(history), args.trace)
        print(f"beacon trace ({len(history)} beacon(s)) -> {args.trace}")
    return 0


def _cmd_monitor(args: argparse.Namespace) -> int:
    import json

    from .utils import knobs

    if args.fleet:
        return _cmd_fleet_monitor(args)
    path = args.dump or knobs.get_recorder_dump_path()
    if not path:
        raise RuntimeError(
            "no dump file given and TSS_TORCH_RECORDER_DUMP is "
            "unset — point the job's recorder at a file first"
        )
    with open(path, encoding="utf-8") as f:
        dump = json.load(f)
    import time as _time

    age_s = _time.time() - dump.get("written_unix", 0.0)
    # A live recorder rewrites the dump every RECORDER_INTERVAL_S; a dump
    # much older than that is a dead process or a stale file, not an
    # in-flight operation.
    stale_after = max(3.0, 4.0 * knobs.get_recorder_interval_s())
    stale = age_s > stale_after
    if args.json:
        print(json.dumps(dump, indent=2, sort_keys=True))
        return 1 if (stale and args.expect_live) else 0
    samples = dump.get("samples") or []
    freshness = (
        f"written {age_s:.1f}s ago"
        if not stale
        else f"STALE — written {age_s:.1f}s ago (> {stale_after:.1f}s)"
    )
    print(
        f"flight recorder @ {path}: pid {dump.get('pid')}, "
        f"{len(samples)} sample(s) (capacity {dump.get('capacity')}, "
        f"{dump.get('dropped', 0)} overwritten), {freshness}"
    )
    engine_samples = [s for s in samples if s.get("kind") == "engine.sample"]
    events = [s for s in samples if s.get("kind") != "engine.sample"]
    if engine_samples:
        print(
            "      ts  engine      prio  paused  admitted   GB done  "
            "budget GB free  occupancy"
        )
        t_base = engine_samples[0].get("ts", 0.0)
        for s in engine_samples[-args.last :]:
            occ = " ".join(
                f"{k}={v}" for k, v in (s.get("occupancy") or {}).items() if v
            )
            print(
                f"{s.get('ts', 0.0) - t_base:8.2f}  {s.get('engine', '?'):<10}"
                f"{s.get('priority', '?'):>6}  {'yes' if s.get('paused') else 'no':>6}"
                f"{s.get('admitted', 0):>10}"
                f"{s.get('bytes_done', 0) / 1e9:>10.2f}"
                f"{s.get('budget_available', 0) / 1e9:>15.2f}  {occ}"
            )
    if events:
        print(f"events ({len(events)}):")
        for s in events[-args.last :]:
            detail = {
                k: v for k, v in s.items() if k not in ("ts", "kind")
            }
            print(f"  {s.get('kind')}: {detail}")
    return 1 if (stale and args.expect_live) else 0


def _cmd_fleet_health(args: argparse.Namespace) -> int:
    import json

    from .telemetry import aggregate, fleet, health
    from .utils import knobs

    store = fleet.connect(args.store)
    beacons = fleet.read_beacons(store)
    view = aggregate.fleet_view(beacons)
    interval_s = view.get("interval_s") or knobs.get_fleet_beacon_s()
    anomalies = health.detect_fleet_anomalies(
        beacons, interval_s, world_size=args.world_size
    )
    if args.json:
        print(
            json.dumps(
                {"view": view, "anomalies": anomalies},
                indent=2,
                sort_keys=True,
            )
        )
        return 1 if anomalies else 0
    for line in aggregate.format_fleet(view):
        print(line)
    if not beacons:
        print("no beacons published (is TSS_TORCH_FLEET_TELEMETRY on?)")
    if anomalies:
        print(f"anomalies ({len(anomalies)}):")
        for a in anomalies:
            rank = a.get("rank")
            where = f" rank={rank}" if rank is not None else ""
            print(f"  {a.get('kind')}{where}: {a.get('detail')}")
    else:
        print("fleet healthy: no anomalies")
    return 1 if anomalies else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch",
        description="Inspect and audit torchsnapshot_tpu_torch snapshots.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_ls = sub.add_parser("ls", help="list the snapshot manifest")
    p_ls.add_argument("path")
    p_ls.set_defaults(fn=_cmd_ls)

    p_cat = sub.add_parser("cat", help="print one persisted value")
    p_cat.add_argument("path")
    p_cat.add_argument("object", help='e.g. "0/model/weight"')
    p_cat.add_argument("--memory-budget-bytes", type=int, default=None)
    p_cat.set_defaults(fn=_cmd_cat)

    p_verify = sub.add_parser("verify", help="CRC32-audit the snapshot")
    p_verify.add_argument("path")
    p_verify.set_defaults(fn=_cmd_verify)

    p_scrub = sub.add_parser(
        "scrub",
        help=(
            "deep integrity sweep: validate every object against sidecar "
            "digests + .ftab frame tables; --repair self-heals from "
            "replicated copies and quarantines the rest"
        ),
    )
    p_scrub.add_argument("path")
    p_scrub.add_argument(
        "--repair",
        action="store_true",
        help=(
            "rewrite corrupt/missing objects from a verified identical-"
            "content copy; quarantine unrepairable corrupt objects"
        ),
    )
    p_scrub.add_argument(
        "--json",
        action="store_true",
        help="print the full structured report as JSON",
    )
    p_scrub.set_defaults(fn=_cmd_scrub)

    p_trace = sub.add_parser(
        "trace",
        help="traced read of the snapshot; writes a Perfetto trace JSON",
    )
    p_trace.add_argument("path")
    p_trace.add_argument(
        "-o",
        "--output",
        default="trace.json",
        help="Chrome/Perfetto trace-event JSON destination (default: trace.json)",
    )
    p_trace.set_defaults(fn=_cmd_trace)

    p_gc = sub.add_parser(
        "gc",
        help=(
            "reclaim crash debris: uncommitted snapshot trees and files "
            "unreferenced by the committed manifest (dry-run by default); "
            "--policy runs retention-driven collection off the bucket's "
            "snapshot catalog instead"
        ),
    )
    p_gc.add_argument("path")
    p_gc.add_argument(
        "--apply",
        action="store_true",
        help="actually delete the debris (default: dry-run report only)",
    )
    p_gc.add_argument(
        "--policy",
        default=None,
        metavar="SPEC",
        help=(
            "retention policy (e.g. 'last=5,hourly=24,daily=7'): condemn "
            "cataloged snapshots the policy drops (per job; pins always "
            "survive) instead of sweeping crash debris — safe to run "
            "concurrently with takes. Grammar: docs/lifecycle.md"
        ),
    )
    p_gc.set_defaults(fn=_cmd_gc)

    p_cat = sub.add_parser(
        "catalog",
        help=(
            "the bucket's snapshot catalog: list committed snapshots and "
            "their delta chains, pin/unpin, apply retention, or rebuild "
            "records by scanning (docs/lifecycle.md)"
        ),
    )
    cat_sub = p_cat.add_subparsers(dest="catalog_cmd", required=True)
    p_cat_ls = cat_sub.add_parser(
        "ls", help="list catalog records (chains, steps, byte attribution)"
    )
    p_cat_ls.add_argument("path", help="bucket (the snapshots' parent)")
    p_cat_ls.add_argument("--job", default=None, help="filter by job id")
    p_cat_ls.add_argument(
        "--json", action="store_true", help="machine-readable records"
    )
    p_cat_pin = cat_sub.add_parser(
        "pin", help="pin a snapshot: retained by every policy until unpinned"
    )
    p_cat_pin.add_argument("path", help="bucket (the snapshots' parent)")
    p_cat_pin.add_argument("name", help="snapshot name (bucket-relative)")
    p_cat_unpin = cat_sub.add_parser("unpin", help="remove a pin")
    p_cat_unpin.add_argument("path")
    p_cat_unpin.add_argument("name")
    p_cat_rebuild = cat_sub.add_parser(
        "rebuild",
        help=(
            "reconstruct missing records by scanning the bucket for "
            "committed snapshots (job/base unknown on synthesized records)"
        ),
    )
    p_cat_rebuild.add_argument("path")
    p_cat_retain = cat_sub.add_parser(
        "retain",
        help=(
            "apply a retention policy: report (and with --apply, collect) "
            "the snapshots the policy condemns"
        ),
    )
    p_cat_retain.add_argument("path")
    p_cat_retain.add_argument(
        "--policy", required=True, metavar="SPEC",
        help="e.g. 'last=5,hourly=24,daily=7,job=trainer-*'",
    )
    p_cat_retain.add_argument(
        "--apply", action="store_true",
        help="actually delete condemned snapshots (default: dry-run)",
    )
    p_cat.set_defaults(fn=_cmd_catalog)

    p_stats = sub.add_parser(
        "stats",
        help="fleet view from the snapshot's persisted telemetry artifacts",
    )
    p_stats.add_argument("path")
    p_stats.add_argument(
        "--op",
        choices=("take", "restore"),
        default="take",
        help="which operation's artifacts to aggregate (default: take)",
    )
    p_stats.add_argument(
        "--trace",
        default=None,
        metavar="OUT.json",
        help="also write the merged multi-rank Perfetto trace (pid = rank)",
    )
    p_stats.set_defaults(fn=_cmd_stats)

    p_compare = sub.add_parser(
        "compare",
        help="diff two snapshots' aggregated telemetry",
    )
    p_compare.add_argument("a")
    p_compare.add_argument("b")
    p_compare.add_argument(
        "--op", choices=("take", "restore"), default="take"
    )
    p_compare.set_defaults(fn=_cmd_compare)

    p_timeline = sub.add_parser(
        "timeline",
        help=(
            "per-step trend table for one job from the catalog's step-"
            "telemetry records, with health anomalies flagged "
            "(docs/observability.md)"
        ),
    )
    p_timeline.add_argument("path", help="bucket (the snapshots' parent)")
    p_timeline.add_argument("--job", required=True, help="job id to render")
    p_timeline.add_argument(
        "--last",
        type=int,
        default=None,
        metavar="N",
        help="render only the last N steps (detectors still see them all)",
    )
    p_timeline.add_argument(
        "--json",
        action="store_true",
        help="machine-readable series + anomalies",
    )
    p_timeline.set_defaults(fn=_cmd_timeline)

    p_monitor = sub.add_parser(
        "monitor",
        help=(
            "render a live flight-recorder dump "
            "(TSS_TORCH_RECORDER_DUMP) for an in-flight operation"
        ),
    )
    p_monitor.add_argument(
        "dump",
        nargs="?",
        default=None,
        help="dump file (default: $TSS_TORCH_RECORDER_DUMP)",
    )
    p_monitor.add_argument(
        "--last",
        type=int,
        default=20,
        metavar="N",
        help="show at most the last N samples/events (default: 20)",
    )
    p_monitor.add_argument(
        "--json", action="store_true", help="print the raw dump"
    )
    p_monitor.add_argument(
        "--expect-live",
        action="store_true",
        help=(
            "exit 1 when the dump is stale (older than "
            "4x TSS_TORCH_RECORDER_INTERVAL_S) — for scripted "
            "liveness checks"
        ),
    )
    p_monitor.add_argument(
        "--fleet",
        default=None,
        metavar="HOST:PORT",
        help=(
            "read live fleet beacons from the coordinator store at this "
            "address instead of a recorder dump (docs/observability.md)"
        ),
    )
    p_monitor.add_argument(
        "--watch",
        type=int,
        default=None,
        metavar="N",
        help="with --fleet: poll N rounds (one beacon interval apart)",
    )
    p_monitor.add_argument(
        "--trace",
        default=None,
        metavar="OUT.json",
        help=(
            "with --fleet: write a Perfetto trace of the accumulated "
            "beacon timeline (pid = rank)"
        ),
    )
    p_monitor.set_defaults(fn=_cmd_monitor)

    p_fleet = sub.add_parser(
        "fleet-health",
        help=(
            "fleet-level health verdict over live beacons: dead beacons, "
            "stragglers, wait cycles, QoS starvation — exit 1 on anomalies "
            "(same contract as timeline)"
        ),
    )
    p_fleet.add_argument(
        "store", help="coordinator store address (HOST:PORT)"
    )
    p_fleet.add_argument(
        "--world-size",
        type=int,
        default=None,
        help="expected rank count (default: max world_size seen in beacons)",
    )
    p_fleet.add_argument(
        "--json", action="store_true", help="machine-readable view + anomalies"
    )
    p_fleet.set_defaults(fn=_cmd_fleet_health)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except Exception as e:  # noqa: BLE001 - operator tool: scriptable errors
        # Any failure (bad object path, checksum-less snapshot, missing
        # snapshot, cloud NotFound/auth errors) exits 2 with a one-line
        # message, never a traceback — exit 1 is reserved for "verify found
        # problems". Set the CLI-traceback knob to debug.
        from .utils import knobs

        if knobs.is_cli_traceback_enabled():
            raise
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())

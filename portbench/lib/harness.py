"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line (the last line of standard output).

:func:`run_cell` is also the internal entry the CPU tests drive at toy
sizes: with ``device="cpu"`` it skips the look for a card and returns the
run's record and verdict without printing any device metric.
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from . import cells
from .workload import CellRunner, Run
from .readers import device_busy_s
from .trace import DeviceTrace, busy_intervals, idle_by_host_span, idle_gaps, subtract, top_device_ops

# The numbers compared with the plain reference, each with its limit: an
# exact comparison, so nothing may differ.
LIMITS = {"leaves_differing": 0, "bytes_differing": 0}

FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "torchsnapshot_tpu"})


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & FORBIDDEN_MODULES)


def host_info() -> Dict[str, Any]:
    """The card by ``nvidia-smi`` (name, power limit, clocks), the host's
    CPUs and ``MemAvailable``."""
    info: Dict[str, Any] = {"cpu_count": os.cpu_count(), "cpus_usable": len(os.sched_getaffinity(0))}
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                info["mem_available_bytes"] = int(line.split()[1]) * 1024
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        info["nvidia_smi"] = out.stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        info["nvidia_smi"] = f"unavailable: {e!r}"
    return info


def run_cell(
    cell: str,
    seed: int,
    seconds: float,
    trace: bool,
    device: str = "cuda",
    bench: Optional[Dict[str, Any]] = None,
    config: Optional[Dict[str, Any]] = None,
    traffic: Optional[Dict[str, Any]] = None,
    log: Callable[[Dict[str, Any]], None] = lambda record: None,
) -> Dict[str, Any]:
    """Run ``cell`` and return ``{"run": Run, "checks": ..., "metrics":
    ..., "memory_peak_bytes": ...}``; ``log`` gets the records of earlier
    lines. ``config`` and ``traffic`` replace the cell's files (the CPU
    tests' toy sizes)."""
    from torchsnapshot_tpu_torch import kernels

    bench = bench or cells.load_benchmark()
    w = cells.workload(bench, cell)
    run = Run(cell, config or cells.config(w["config"]), traffic or cells.traffic(w["traffic"]), trace)
    dev = torch.device(device)
    runner = CellRunner(run, seed, dev)
    runner.set_up()
    launches_setup = dict(kernels.LAUNCHES)
    devtrace = DeviceTrace() if trace and dev.type == "cuda" else None
    if devtrace is not None:
        devtrace.start()
    # The reference's copy is not the program's set-up.
    run.setup["setup_s"] = process_age_s() - run.setup["reference_s"]
    usage0 = resource.getrusage(resource.RUSAGE_SELF)
    runner.window(seconds)
    usage1 = resource.getrusage(resource.RUSAGE_SELF)
    if devtrace is not None:
        run.device_events = devtrace.stop()
        log({"device_events": len(run.device_events), "marker_lag_s": devtrace.marker_lag_s})
    runner.finish()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = {k: v - launches_setup.get(k, 0) for k, v in kernels.LAUNCHES.items()}
    log({"window_launches": launches, "setup_launches": launches_setup})
    log({"ops": op_summary(run), "window_usage": usage_delta(usage0, usage1)})
    checks = runner.check()
    runner.close()
    metrics = {}
    # Off the card no metric is reported: the tests call the readers.
    for m in cells.metrics_of(bench, cell, trace) if dev.type == "cuda" else []:
        value = cells.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"run": run, "checks": checks, "metrics": metrics, "memory_peak_bytes": peak}


def usage_delta(a: Any, b: Any) -> Dict[str, float]:
    """The process's page faults, context switches and CPU seconds between
    two ``getrusage`` readings."""
    return {
        "minflt": b.ru_minflt - a.ru_minflt,
        "majflt": b.ru_majflt - a.ru_majflt,
        "nvcsw": b.ru_nvcsw - a.ru_nvcsw,
        "nivcsw": b.ru_nivcsw - a.ru_nivcsw,
        "utime_s": b.ru_utime - a.ru_utime,
        "stime_s": b.ru_stime - a.ru_stime,
    }


def op_summary(run: Run) -> Dict[str, Any]:
    """Per kind of the window's operations: count and wall seconds (mean,
    min, median, max); per async take: stall, drain and capture."""
    out: Dict[str, Any] = {"window_s": run.window_s}
    for kind in sorted({op.kind for op in run.ops}):
        d = sorted(op.t1 - op.t0 for op in run.in_window(kind))
        if d:
            out[kind] = [len(d), sum(d) / len(d), d[0], d[len(d) // 2], d[-1]]
    out["takes"] = [
        [op.t1 - op.t0, (op.info.get("t_commit") or op.t1) - op.t1, op.info["phases"].get("capture")]
        for op in run.in_window("async_take")
    ]
    return out


def breakdown(run: Run) -> Dict[str, Any]:
    t0, t1 = run.window
    cut = run.excluded()
    events = [e for e in run.device_events or [] if not any(a <= e.t0 < b for a, b in cut)]
    gaps = subtract(idle_gaps(busy_intervals(events), t0, t1), cut)
    # The harness's own calls as host spans: bench.step, bench.async_take, ...
    spans = [(f"bench.{op.kind}", op.t0, op.t1) for op in run.ops]
    return {"device_ops": top_device_ops(events, t0, t1), "idle_gaps": idle_by_host_span(gaps, spans)}


def result_line(out: Dict[str, Any], chips: int, kind: str) -> Dict[str, Any]:
    """The result's JSON object: ``checks``, the numbers compared and their
    limits, comes last."""
    run: Run = out["run"]
    checks = out["checks"]
    correct = run.failed == 0 and all(checks[k] <= lim for k, lim in LIMITS.items())
    device = {
        "platform": "gpu",
        "kind": kind,
        "count": chips,
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    line: Dict[str, Any] = {
        "correct": correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": out["metrics"],
        "device": device,
    }
    if run.device_events is not None:
        device["busy_s"] = device_busy_s(run)
        device["window_s"] = run.window_s
        line["breakdown"] = breakdown(run)
    line["checks"] = {k: {"value": checks[k], "limit": lim} for k, lim in LIMITS.items()}
    return line


def main(args: Any) -> int:
    """The command: exits non-zero, printing no result, without the cards
    the cell needs or when JAX or the JAX package was loaded."""
    bench = cells.load_benchmark()
    w = cells.workload(bench, args.workload)
    chips = w["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); this host has {n}", file=sys.stderr)
        return 2

    def log(record: Dict[str, Any]) -> None:
        print("portbench " + json.dumps(record, default=str), flush=True)

    log({"cell": args.workload, "seed": args.seed, "seconds": args.seconds, "trace": args.trace, "host": host_info()})
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench, log=log)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: these modules were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(out, chips, torch.cuda.get_device_name(0))
    for k, v in line["checks"].items():
        print(f"portbench check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0

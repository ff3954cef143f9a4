"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout,
and the files a cell names by its entries there. A configuration is
``configs/<config>.json`` and names the state it holds,
``states/<state>.py``; a traffic mix is ``traffic/<traffic>.json`` and
names its operation, ``ops/<op>.py``; a metric's reader is
``metrics/<metric>.py``. A later cell or metric adds files; no code here
names one. Imports neither torch nor the port.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _load_json(kind: str, name: str) -> Dict[str, Any]:
    with open(os.path.join(PKG, kind, f"{name}.json")) as f:
        return json.load(f)


def config(name: str) -> Dict[str, Any]:
    return _load_json("configs", name)


def traffic(name: str) -> Dict[str, Any]:
    return _load_json("traffic", name)


def metrics_of(bench: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced. An entry with ``workloads``
    belongs to the cells listed; an end-to-end metric without it to every
    cell, a per-layer metric without it to every cell that reports the
    metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}

    def belongs(m: Dict[str, Any]) -> bool:
        return cell in m["workloads"] if "workloads" in m else m["moves"] in reported

    return [m for m in bench["per_layer"] if belongs(m)]


def _load_module(kind: str, name: str) -> ModuleType:
    path = os.path.join(PKG, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str) -> ModuleType:
    """The module ``metrics/<metric>.py``; its ``read(run)`` returns the
    metric's value, or None where the run holds nothing to read."""
    return _load_module("metrics", metric)


def op(name: str) -> ModuleType:
    """The module ``ops/<name>.py``: ``set_up(runner)``,
    ``operation(runner, k)`` and, optionally, ``check(runner)``."""
    return _load_module("ops", name)


def state(name: str) -> ModuleType:
    """The module ``states/<name>.py``: ``build(cfg, traffic, seed,
    device)`` makes the state a configuration holds."""
    return _load_module("states", name)

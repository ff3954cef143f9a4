"""``BENCHMARK.json`` against the rules its cells, metrics and files keep:
names, units and lengths; every metric's reader and every cell's files
present; each cell reporting ``setup_s``, another end-to-end metric and a
per-layer metric, and each per-layer metric's cells reporting the metric
it moves; the time a full check takes at 24 cells."""

import json
import os
import re

import pytest

from portbench.lib import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(_size$|_dim$|_rank$|expansion|per_tok|intermediate|latent)")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
PL_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    with open(os.path.join(cells.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text_ok(w) and not w.startswith("/") for w in BENCH["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = E2E_KEYS if "bound" in metric else PL_KEYS
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(cells.PKG, "metrics", f"{metric['name']}.py"))
    assert callable(cells.reader(metric["name"]).read)
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text_ok(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_setup_metric_and_its_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in cells.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = cells.metrics_of(BENCH, cell, True)
    assert layers
    # Every per-layer metric a cell reports moves an end-to-end metric the
    # cell reports.
    assert all(m["moves"] in e2e for m in layers)


def test_metrics_of_one_layer_name_it_alike():
    by_module = {}
    for m in BENCH["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values()), by_module


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and _text_ok(cell["why"])
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = cells.traffic(cell["traffic"])  # its data file exists and parses
    op = cells.op(traffic["op"])
    assert callable(op.set_up) and callable(op.operation)
    assert traffic["storage"].endswith("/")
    assert callable(cells.state(cells.config(cell["config"])["state"]).build)


def test_pairs_are_unique_and_four_chip_cells_few():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_and_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert _text_ok(cfg["source"]) and _text_ok(cfg["why"]) and len(cfg["reduced"]) <= 16
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    with open(os.path.join(cells.ROOT, cfg["file"])) as f:
        data = json.load(f)
    assert data["source"] == cfg["source"]
    # The file names every key it changed, and the entry lists the same;
    # what is no cut of scale is a departure, not a reduction.
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert not set(data["reduced"]) & set(data.get("departures", {}))
    assert all(NAME.match(k) and not WIDTH.search(k) for k in cfg["reduced"]), cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    n = 24
    assert (2 + 14 * n) * (rs + 60) + n * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, filenames in os.walk(cells.PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            rel = os.path.relpath(os.path.join(dirpath, f), cells.ROOT)
            if not f.endswith(".pyc"):
                assert PATH.match(rel), rel

"""The benchmark's files: found by name, inside the contract's limits, and
extended by adding files only."""

from __future__ import annotations

import json
import re

import pytest

from h100bench import counts, harness, specs
from h100bench.tests import tiny

BENCH = json.loads(harness.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
    script = BENCH["command"][1]
    assert script.startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert (harness.ROOT.parent / script).exists()
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    # A full check of 24 cells: 2 + 14 x 24 runs of rs + 60 s, 2 x 90 s a
    # cell to compile, 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if per_layer:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
        assert metric_reader_exists(metric["name"])
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def metric_reader_exists(name):
    return callable(harness.metric_reader(name))


def test_setup_metric_and_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert len(e2e) <= 16
    for cell in CELLS:
        c = harness.load_cell(cell)
        assert {m["name"] for m in c.end_to_end} - {"setup_s"}
        assert c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    assert c.config["name"] == entry["config"]
    assert (harness.ROOT / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert set(c.limits) >= {"step1_gap", "max_gap", "rrms"} or \
        set(c.limits) >= {"loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = specs.load_json("configs", entry["name"])
    assert entry["file"] == f"h100bench/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    # The FLOP table the file records is the frozen count's.
    assert cfg["flops"]["by_layer"] == counts.flops_by_layer(cfg)
    assert cfg["flops"]["forward_gflop_per_sample_step"] == \
        counts.forward_flops(cfg) / 1e9


def test_a_cell_added_as_new_files_runs(tmp_path):
    """Tiny configurations, traffic and cells added to a copy as new files
    and BENCHMARK.json entries run with no other edit."""
    root = tiny.make_copy(tmp_path)
    for f in ("configs/flagship.json", "traffic/forecast_b64.json",
              "harness.py", "drivers/forecast.py"):
        assert (root / "h100bench" / f).read_bytes() == \
            (tiny.REPO / "h100bench" / f).read_bytes()
    result = tiny.run(root, "tower_tiny.forecast_tiny")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"forecast_mgp_per_s",
                                      "forecast_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks"

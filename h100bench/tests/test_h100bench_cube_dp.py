"""The cubed-sphere forecast cell and the data-parallel training cell,
added to a copy at a tiny size as new files and entries only, run on the
CPU: the cube U-Net at its published widths on faces of 8 x 8, and the
flagship's training over 2 gloo ranks."""

from __future__ import annotations

import json

import pytest

from h100bench import counts, cube_counts, harness, specs
from h100bench.tests import tiny

CUBE_TRAFFIC = {"driver": "forecast_cube", "batch": 2, "steps": 3,
                "series_samples": 24, "draws": 16, "warmup": 1,
                "trace_seconds": 0.2, "check": {"first": 2, "picks": 1,
                                                "block": 2}}
DP_TRAFFIC = dict(tiny.TRAIN, driver="train_dp", ranks=2, timeout_s=120)


def add_cells(root):
    b = root / "h100bench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((b / "configs" / "dlwp_cs48.json").read_text())
    cfg.update(name="dlwp_cs_tiny", grid=dict(cfg["grid"], face_size=8))
    tiny._write(b / "configs" / "dlwp_cs_tiny.json", cfg)
    tiny._write(b / "traffic" / "forecast_cube_tiny.json", CUBE_TRAFFIC)
    tiny._write(b / "traffic" / "train_dp_tiny.json", DP_TRAFFIC)
    for cell, cfg_name, traffic, kind, like in (
            ("dlwp_cs_tiny.forecast_cube_tiny", "dlwp_cs_tiny",
             "forecast_cube_tiny", "forecast", "dlwp_cs48.forecast_s2s_b64"),
            ("flagship_tiny.train_dp_tiny", "flagship_tiny", "train_dp_tiny",
             "train", "flagship.train_dp4")):
        tiny._write(b / "cells" / f"{cell}.json",
                    {"limits": tiny.LIMITS[kind]})
        bench["workloads"].append({"name": cell, "config": cfg_name,
                                   "traffic": traffic, "chips": 1,
                                   "why": "tiny CPU cell of the tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    tiny._write(root / "BENCHMARK.json", bench)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_copy(tmp_path_factory.mktemp("cube_dp"))
    add_cells(root)
    return root


def test_the_new_cells_are_in_the_benchmark():
    bench = json.loads(harness.BENCHMARK.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["dlwp_cs48.forecast_s2s_b64"]["chips"] == 1
    assert cells["flagship.train_dp4"]["chips"] == 4
    assert harness.load_cell("flagship.train_dp4").traffic["ranks"] == 4
    names = {m["name"] for m in bench["per_layer"]}
    assert {"cube_pad_roofline_pct",
            "allreduce_device_ms_per_step.train"} <= names


def test_cube_counts_at_b64():
    cfg = specs.load_json("configs", "dlwp_cs48")
    # 2.38 GFLOP a sample-step; the ten pads of a step move 1.67 GB at
    # B = 64, 0.50 ms at 3.35 TB/s.
    assert round(counts.forward_flops(cfg) / 1e9, 2) == 2.38
    pads = cube_counts.pad_launches(cfg)
    assert [c for c, _ in pads] == [10, 32, 32, 64, 64, 128, 128, 64, 64, 32]
    total = sum(cube_counts.pad_bytes(c, n, 1, 64) for c, n in pads)
    assert round(total / 1e9, 2) == 1.67
    assert round(total / counts.PEAK_BYTES * 1e3, 2) == 0.50


def test_cube_forecast_cell_runs(root):
    result = tiny.run(root, "dlwp_cs_tiny.forecast_cube_tiny")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"forecast_mgp_per_s",
                                      "forecast_p95_ms", "setup_s"}
    assert result["attempted"] >= 1


def test_cube_forecast_cell_traced(root):
    result = tiny.run(root, "dlwp_cs_tiny.forecast_cube_tiny", trace=True)
    assert result["correct"], result["checks"]
    # On the CPU no kernel runs: the roofline and the card's idle share
    # have nothing to read there, the FLOP share does.
    assert "cube_pad_roofline_pct" not in result["metrics"]
    assert "mfu_pct.forecast" in result["metrics"]


def test_data_parallel_cell_runs_over_two_gloo_ranks(root):
    result = tiny.run(root, "flagship_tiny.train_dp_tiny")
    assert result["correct"], result["checks"]
    assert result["notes"]["ranks"] == 2
    assert result["notes"]["losses"] == pytest.approx(
        result["notes"]["reference_losses"], rel=1e-4)


def test_data_parallel_cell_traced(root):
    result = tiny.run(root, "flagship_tiny.train_dp_tiny", trace=True)
    assert result["correct"], result["checks"]
    assert "samples_per_s.train" in result["metrics"]
    # gloo runs no NCCL kernel: the all-reduce's device time is silent.
    assert "allreduce_device_ms_per_step.train" not in result["metrics"]


def test_data_parallel_calibration_over_two_gloo_ranks(root):
    """The data-parallel calibration tool: its control works from the
    inputs the cell's rank 0 makes (the same reference losses), and both
    faults, planted in every rank, fail the cell's limits."""
    import os
    import subprocess
    import sys

    cell, seed = "flagship_tiny.train_dp_tiny", 7
    env = dict(os.environ, PYTHONPATH=f"{root}:{tiny.REPO}",
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "h100bench/tools/calibrate_dp.py", "--workload",
         cell, "--control-seeds", str(seed), "--fault-seeds", str(seed),
         "--seconds", "0.3", "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    control = next(r for r in rows if "control" in r)
    result = tiny.run(root, cell, seed=seed)
    assert control["reference_losses"] == result["notes"]["reference_losses"]
    limits = tiny.LIMITS["train"]
    faults = {r["fault"]: r["program"] for r in rows if "fault" in r}
    assert set(faults) == {"allreduce_skipped", "half_batch"}
    for fault, numbers in faults.items():
        assert not harness.passes(numbers, limits), (fault, numbers)

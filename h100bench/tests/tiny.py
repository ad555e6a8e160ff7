"""A temporary copy of the benchmark with tiny cells, run on the CPU.

The copy holds ``h100bench/`` and ``BENCHMARK.json``; tiny configurations
(8 x 16 grid, the published layer widths), traffic mixes and cells are
added to it as new files and entries only, as a later change adds a cell.
A run goes through :func:`h100bench.harness.run_cell` in a subprocess
whose ``h100bench`` is the copy's, with ``device="cpu"`` (``run.py``
refuses to run without a card).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
GRID = {"nlat": 8, "nlon": 16, "lat0": 70.0, "dlat": -10.0, "lon0": 0.0,
        "dlon": 22.5}
FORECAST = {"driver": "forecast", "batch": 2, "steps": 3, "series_samples": 24,
            "draws": 16, "warmup": 1, "trace_seconds": 0.2,
            "check": {"first": 2, "picks": 1, "block": 2}}
TRAIN = {"driver": "train", "batch": 4, "sequence_steps": 2,
         "series_samples": 64, "validation_fraction": 0.25,
         "learning_rate": 2e-3, "alpha": 0.05, "decay_epochs": 50,
         "clip_norm": 1.0, "trace_epochs": 1, "check_steps": 3}
# The limits of the tiny cells: float32 on the CPU, program against the
# reference (summation order only).
LIMITS = {"forecast": {"step1_gap": 1e-4, "max_gap": 1e-4, "rrms": 1e-4},
          "train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}}
# Each tiny cell reports the metrics of the full-size cell it stands for.
LIKE = {"forecast": "flagship.forecast_b64", "train": "flagship.train_b32"}


def _write(path: Path, data) -> None:
    path.write_text(json.dumps(data, indent=1) + "\n")


def make_copy(tmp: Path) -> Path:
    """The copy, with cells ``flagship_tiny.forecast_tiny``,
    ``tower_tiny.forecast_tiny`` and ``flagship_tiny.train_tiny`` added."""
    root = tmp / "bench"
    shutil.copytree(REPO / "h100bench", root / "h100bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    add_cells(root, bench)
    return root


def add_cells(root: Path, bench: dict) -> None:
    b = root / "h100bench"
    for name in ("flagship", "tower"):
        cfg = json.loads((b / "configs" / f"{name}.json").read_text())
        cfg.update(name=f"{name}_tiny", grid=GRID)
        _write(b / "configs" / f"{name}_tiny.json", cfg)
    _write(b / "traffic" / "forecast_tiny.json", FORECAST)
    _write(b / "traffic" / "train_tiny.json", TRAIN)
    for cfg, traffic, kind in (("flagship_tiny", "forecast_tiny", "forecast"),
                               ("tower_tiny", "forecast_tiny", "forecast"),
                               ("flagship_tiny", "train_tiny", "train")):
        cell = f"{cfg}.{traffic}"
        _write(b / "cells" / f"{cell}.json", {"limits": LIMITS[kind]})
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": traffic, "chips": 1,
                                   "why": "tiny CPU cell of the tests"})
        like = LIKE[kind]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    _write(root / "BENCHMARK.json", bench)


RUNNER = """
import json, sys
import torch
from h100bench import harness
cell = harness.load_cell({cell!r})
run = harness.Run(cell=cell, seed={seed}, seconds={seconds}, trace={trace},
                  device=torch.device("cpu"), control={control!r})
fault = {fault!r}
if fault:
    from h100bench.tools.faults import plant
    with plant(fault, cell.config, cell.traffic["driver"]):
        result = harness.run_cell(run, harness.now())
else:
    result = harness.run_cell(run, harness.now())
print(json.dumps(result))
"""


def run(root: Path, cell: str, seed: int = 7, seconds: float = 0.3,
        trace: bool = False, fault: str | None = None,
        control: str | None = None, timeout: int = 240) -> dict:
    """One CPU run of ``cell`` in the copy at ``root``; its result."""
    code = textwrap.dedent(RUNNER.format(cell=cell, seed=seed,
                                         seconds=seconds, trace=trace,
                                         fault=fault, control=control))
    env = dict(os.environ, PYTHONPATH=f"{root}:{REPO}", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"run of {cell} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])

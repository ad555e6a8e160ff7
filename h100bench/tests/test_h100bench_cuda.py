"""On the card: the control (the plain reference in TF32 in the program's
place) fails the cells' limits while the program passes them, at a size a
test run holds (the cells' own sizes are read by
``h100bench/tools/calibrate.py``).

    python -m pytest --noconftest -m cuda h100bench/tests/test_h100bench_cuda.py
"""

from __future__ import annotations

import json

import pytest

from h100bench.tests import tiny

SMALL = {"forecast": {"batch": 8, "steps": 8, "series_samples": 64,
                      "draws": 16, "warmup": 1, "trace_seconds": 0.5,
                      "check": {"first": 2, "picks": 1, "block": 8}},
         "train": {"series_samples": 400, "batch": 32}}
# Each small cell takes the limits of the full-size cell it stands for.
CELLS = {"flagship.forecast_small": ("flagship", "forecast_b64"),
         "tower.forecast_small": ("tower", "forecast_b256"),
         "flagship.train_small": ("flagship", "train_b32")}


@pytest.fixture(scope="module")
def card_copy(tmp_path_factory):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny.make_copy(tmp_path_factory.mktemp("card"))
    b = root / "h100bench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, (cfg, full) in CELLS.items():
        traffic = json.loads((b / "traffic" / f"{full}.json").read_text())
        kind = traffic["driver"]
        traffic.update(SMALL[kind])
        name = cell.split(".", 1)[1]
        (b / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        limits = json.loads((b / "cells" / f"{cfg}.{full}.json").read_text())
        (b / "cells" / f"{cell}.json").write_text(json.dumps(limits))
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": name, "chips": 1,
                                   "why": "small card cell of the tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


RUNNER = tiny.RUNNER.replace('device=torch.device("cpu")',
                             'device=torch.device("cuda", 0)')


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", [3100000001, 3100000002, 3100000003])
def test_control_fails_where_the_program_passes(card_copy, cell, seed,
                                                monkeypatch):
    from h100bench import harness

    monkeypatch.setattr(tiny, "RUNNER", RUNNER)
    result = tiny.run(card_copy, cell, seed=seed, seconds=0.2,
                      control="tf32", timeout=600)
    limits = {k: v["limit"] for k, v in result["checks"].items()}
    assert result["correct"], result["checks"]
    assert not any(harness.passes(a, limits) for a in result["control"])

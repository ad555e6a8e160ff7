"""What the benchmark refuses: JAX and the JAX package anywhere in it, the
program in the reference, a run without a card, and a timed path broken
underneath (the check's faults)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench import harness
from h100bench.tests import tiny
from h100bench.tools.faults import FAULTS

HERE = harness.ROOT
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "dlwp_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    imports = top_level_imports(path)
    assert "dlwp_torch" not in imports
    assert imports <= {"__future__", "contextlib", "importlib", "math",
                       "numpy", "torch", "h100bench"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("dlwp_torch", "dlwp_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "dlwp_tpu", sys)
    assert harness.forbidden_modules() == ["dlwp_tpu", "jax"]


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "flagship.forecast_b64", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_answers_are_judged_one_by_one():
    limits = {"a": 1.0, "b": 2.0}
    ok, failed, rows = harness.judge([{"a": 0.5, "b": 1.0},
                                      {"a": 1.5, "b": 0.1}], limits)
    assert not ok and failed == 1
    assert rows == {"a": {"value": 1.5, "limit": 1.0},
                    "b": {"value": 1.0, "limit": 2.0}}
    assert not harness.judge([{"a": float("nan")}], limits)[0]
    assert not harness.judge([{"c": 0.0}], limits)[0]  # no limit
    assert not harness.judge([], limits)[0]


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["flagship_tiny.forecast_tiny",
                                  "flagship_tiny.train_tiny"])
def test_a_broken_timed_path_is_not_correct(copy_root, cell, fault):
    result = tiny.run(copy_root, cell, fault=fault)
    assert result["correct"] is False
    assert result["failed"] >= 1
    json.dumps(result)  # the line stays printable

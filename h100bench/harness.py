"""One run of one cell: find its files by name, set up, warm up, measure,
check, and assemble the result line.

A cell of ``BENCHMARK.json`` names a configuration
(``h100bench/configs/<config>.json``) and a traffic mix
(``h100bench/traffic/<traffic>.json``); the traffic names its driver
(``h100bench/drivers/<driver>.py``), the cell's correctness limits are in
``h100bench/cells/<cell>.json``, and each per-layer metric is read by
``h100bench/metrics/<metric>.py``. Adding any of them is adding files and
entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from h100bench import inputs, specs, tracing

ROOT = specs.ROOT
BENCHMARK = ROOT.parent / "BENCHMARK.json"
# Top-level module names that no run may have loaded.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dlwp_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # this cell's end-to-end metric entries
    per_layer: list  # this cell's per-layer metric entries


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench_path: Path = BENCHMARK) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = json.loads(Path(bench_path).read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(
        name=name, chips=entry["chips"],
        config=specs.load_json("configs", entry["config"]),
        traffic=specs.load_json("traffic", entry["traffic"]),
        limits=specs.load_json("cells", name)["limits"],
        end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """``read(ctx)`` of ``h100bench/metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"h100bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the seed's sub-seeds, the window, the
    device, and whether the window is traced."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    control: str | None = None  # "tf32": also read the control's numbers

    @property
    def cfg(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic

    def seeds(self, n: int) -> list[int]:
        return inputs.sub_seeds(self.seed, n)

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self):
        return tracing.window(self.trace, self.device.type)


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    setup_end: float  # perf_counter at the window's start
    attempted: int  # forecasts or train steps in the window
    end_to_end: dict  # metric name -> value, every one the driver measures
    units: dict  # counts the per-layer readers divide by
    answers: list  # one {number name: value} for each answer compared
    memory_peak_bytes: int
    summary: tracing.Summary | None = None
    control: list | None = None  # the control's answers, when asked
    notes: dict = dataclasses.field(default_factory=dict)


def worst(answers: list) -> dict:
    """Each number's largest reading over the answers (NaN wins)."""
    out = {}
    for a in answers:
        for k, v in a.items():
            if k not in out or math.isnan(v) or v > out[k]:
                out[k] = v
    return out


def passes(answer: dict, limits: dict) -> bool:
    """Every number within its limit; a missing limit or a number that is
    not finite fails."""
    return bool(answer) and all(
        limits.get(k) is not None and math.isfinite(v) and v <= limits[k]
        for k, v in answer.items())


def judge(answers: list, limits: dict) -> tuple[bool, int, dict]:
    """(correct, answers that failed, {number: {value, limit}}) with each
    number's worst reading."""
    failed = sum(not passes(a, limits) for a in answers)
    rows = {k: {"value": v, "limit": limits.get(k)}
            for k, v in worst(answers).items()}
    return bool(answers) and failed == 0, failed, rows


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(run: Run, peak: int, summary) -> dict:
    import torch

    info = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(run.device)
                     if run.device.type == "cuda" else "cpu"),
            "count": run.cell.chips,
            "memory_peak_bytes": int(peak)}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info


def run_cell(run: Run, t_start: float) -> dict:
    """Run the cell once; returns the result object (without printing)."""
    driver = importlib.import_module(
        f"h100bench.drivers.{run.traffic['driver']}")
    out: Outcome = driver.run(run)
    setup_s = out.setup_end - t_start
    # Set-up by phase: process start to the driver, the seeded inputs, the
    # program's build, the warm-up.
    stamps = out.notes.pop("stamps", None)
    if stamps:
        marks = [t_start] + list(stamps.values())
        out.notes["setup_phases_s"] = {
            k: b - a for k, a, b in zip(stamps, marks, marks[1:])}
    ok, failed, rows = judge(out.answers, run.cell.limits)
    metrics = {}
    if not run.trace:
        values = dict(out.end_to_end, setup_s=setup_s)
        for m in run.cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        # A reader added later may need the configuration or the traffic
        # (a new kernel's roofline from its shapes), so they come along.
        ctx = {"trace": out.summary, "units": out.units, "cfg": run.cfg,
               "traffic": run.traffic, "cell": run.cell.name}
        for m in run.cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": ok,
        "attempted": out.attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(run, out.memory_peak_bytes, out.summary),
    }
    if out.summary is not None:
        result["breakdown"] = {"device_ops": out.summary.device_ops,
                               "idle_gaps": out.summary.idle_gaps}
    if out.control is not None:
        result["control"] = out.control
    result["notes"] = out.notes
    result["checks"] = rows
    return result


def now() -> float:
    return time.perf_counter()


def host_clocks() -> dict:
    """What :func:`host_since` subtracts from: the wall clock and this
    process's and this thread's CPU time."""
    return {"wall": time.perf_counter(), "process": time.process_time(),
            "thread": time.thread_time()}


def host_since(start: dict) -> dict:
    """Seconds of wall, of this process's CPU and of this thread's CPU
    since ``start``: where the process's CPU time falls short of the wall,
    the host held it back."""
    end = host_clocks()
    return {k: end[k] - start[k] for k in start}

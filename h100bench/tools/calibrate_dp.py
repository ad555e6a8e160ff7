"""Readings that the data-parallel training cell's correctness limits are
set from (``drivers/train_dp.py``), in one process.

    python3 h100bench/tools/calibrate_dp.py --workload flagship.train_dp4 \\
        --control-seeds 1,2,3 [--fault-seeds 4,5] \\
        [--faults allreduce_skipped,half_batch] [--seconds 1] \\
        [--device cuda] [--out calibrate_dp.jsonl]

- ``--control-seeds``: for each seed, the control's numbers: the plain
  reference in TF32 against the reference in float32 on the inputs that
  the cell's rank 0 makes from the seed (its weights, its series and its
  first three global batches). The program does not run, so this needs
  one card whatever the cell's ranks.
- ``--fault-seeds``: for each seed and fault, one run of the cell (all its
  ranks) with the fault planted in every rank:

  - ``allreduce_skipped``: the gradient all-reduce does nothing, so each
    rank steps on its own block's gradient and reports its own loss;
  - ``half_batch``: each rank's loss is the mean over the first half of
    its block (``tools/faults.py``), so half of the global batch is left
    out.

The upper reading of a number is its smallest over the control's seeds
and the faults'. Never run by the benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
FAULTS = ("allreduce_skipped", "half_batch")
# The fault a spawned rank plants: each rank is a process of its own.
FAULT_ENV = "H100BENCH_DP_FAULT"


@contextlib.contextmanager
def plant(fault: str, cfg: dict):
    """Patch this process's program for the duration of the block."""
    from dlwp_torch.train import trainer

    from h100bench.tools import faults

    if fault == "allreduce_skipped":
        old = trainer.all_reduce_mean
        trainer.all_reduce_mean = lambda tensors, group=None: tensors
        try:
            yield
        finally:
            trainer.all_reduce_mean = old
    elif fault == "half_batch":
        with faults.plant("half_batch", cfg, "train"):
            yield
    else:
        raise ValueError(f"fault must be one of {FAULTS}")


def _faulty_child(rank, world, port, run):
    """A rank other than 0 with the fault of :data:`FAULT_ENV` planted."""
    from h100bench.drivers import train_dp

    with plant(os.environ[FAULT_ENV], run.cfg):
        train_dp._child(rank, world, port, run)


def fault_run(cell, seed: int, fault: str, seconds: float, dev) -> dict:
    """One run of the cell with ``fault`` planted in every rank: the
    result's numbers, and its ``setup_s``."""
    from h100bench import harness
    from h100bench.drivers import train_dp

    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                      device=dev)
    child, os.environ[FAULT_ENV] = train_dp._child, fault
    train_dp._child = _faulty_child
    try:
        with plant(fault, cell.config):
            res = harness.run_cell(run, harness.now())
    finally:
        train_dp._child = child
        del os.environ[FAULT_ENV]
    return ({k: v["value"] for k, v in res["checks"].items()},
            res["metrics"]["setup_s"]["value"])


def control_gaps(cell, seed: int, dev) -> tuple[dict, list]:
    """The control's numbers on the inputs of ``seed``, as
    ``train_dp.run`` reads them, without running the program; and the
    float32 reference's losses."""
    import torch

    from h100bench import harness, inputs
    from h100bench.drivers.train import gaps, reference_batches
    from h100bench.reference import load as load_reference

    run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=dev)
    cfg, t = run.cfg, run.traffic
    T, S, B = cfg["input_time_steps"], t["sequence_steps"], t["batch"]
    s_weights, s_series, s_sampler = run.seeds(3)
    ref = load_reference(cfg["reference"])
    weights = inputs.make_weights(cfg, inputs.generator(s_weights, dev), dev)
    n = t["series_samples"]
    series, sol, _ = inputs.make_series(cfg, n, inputs.generator(s_series,
                                                                 dev), dev)
    n_train = n - int(n * t["validation_fraction"])
    nb = (n_train - (T + T * S) + 1) // B  # the device sampler's epoch
    batches = reference_batches(run, series, sol, s_sampler, n_train, nb,
                                t["check_steps"])
    cfg_train = {"learning_rate": t["learning_rate"], "alpha": t["alpha"],
                 "decay_steps": t["decay_epochs"] * nb,
                 "clip_norm": t["clip_norm"]}
    out = {}
    for tf32 in (False, True):
        with ref.precision(tf32):
            out[tf32] = ref.train(weights, cfg, batches, cfg_train)
        out[tf32]["params0"] = weights
    del series, sol, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return gaps(out[True], out[False]), out[False]["losses"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default=",".join(FAULTS))
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:] = [s for s in sys.path
                   if s and Path(s).resolve() != Path(__file__).resolve().parent]
    sys.path.insert(0, str(CHECKOUT))
    from h100bench import run as entry

    entry.set_caches()
    import torch

    from h100bench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate_dp: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device(args.device)
    cell = harness.load_cell(args.workload)
    rows = []

    def seeds(text):
        return [int(v) for v in text.split(",") if v]

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    for s in seeds(args.control_seeds):
        t0 = time.perf_counter()
        control, losses = control_gaps(cell, s, dev)
        emit({"cell": cell.name, "seed": s, "control": control,
              "reference_losses": losses,
              "seconds": time.perf_counter() - t0})
    for fault in filter(None, args.faults.split(",")):
        for s in seeds(args.fault_seeds):
            t0 = time.perf_counter()
            numbers, setup_s = fault_run(cell, s, fault, args.seconds, dev)
            emit({"cell": cell.name, "seed": s, "fault": fault,
                  "program": numbers, "setup_s": setup_s,
                  "seconds": time.perf_counter() - t0})
    summary = {"cell": cell.name, "control_min": {}, "faults_min": {}}
    for r in rows:
        into = (summary["faults_min"].setdefault(r["fault"], {})
                if "fault" in r else summary["control_min"])
        for k, v in r.get("program", r.get("control", {})).items():
            into[k] = min(into.get(k, float("inf")), v)
    summary["control_seeds"] = sum("control" in r for r in rows)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            for r in rows + [{"summary": summary}]:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

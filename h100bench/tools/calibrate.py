"""Readings that a cell's correctness limits are set from, in one process.

    python3 h100bench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 1] [--faults half_batch,altered] [--fault-seeds 3] \\
        [--out chiprun_out/calibrate.jsonl]

For each seed: one run of the cell with a short window, its numbers, and
the control's on the same inputs (the plain reference in TF32 in the
program's place). With ``--faults``, runs with each fault planted
(``h100bench/tools/faults.py``) on the first ``--fault-seeds`` seeds. The
lower reading of a number is its largest over the program's seeds, the
upper its smallest over the control's (and the faults'). Needs the card;
the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:] = [s for s in sys.path
                   if s and Path(s).resolve() != Path(__file__).resolve().parent]
    sys.path.insert(0, str(CHECKOUT))
    from h100bench import run as entry

    entry.set_caches()
    import torch

    from h100bench import harness
    from h100bench.tools.faults import plant

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []

    def one(seed, fault=None, control=None):
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds,
                          trace=False, device=dev, control=control)
        t0 = time.perf_counter()
        if fault:
            with plant(fault, cell.config, cell.traffic["driver"]):
                res = harness.run_cell(run, harness.now())
        else:
            res = harness.run_cell(run, harness.now())
        row = {"cell": cell.name, "seed": seed, "fault": fault,
               "program": {k: v["value"] for k, v in res["checks"].items()},
               "control": (harness.worst(res["control"])
                           if res.get("control") else None),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)

    for s in seeds:
        one(s, control="tf32")
    for fault in filter(None, args.faults.split(",")):
        for s in seeds[:args.fault_seeds]:
            one(s, fault=fault)
    clean = [r for r in rows if r["fault"] is None]
    summary = {"cell": cell.name, "seeds": len(clean),
               "lower": harness.worst([r["program"] for r in clean]),
               "control_min": {k: min(r["control"][k] for r in clean)
                               for k in clean[0]["control"]},
               "faults_min": {}}
    for r in rows:
        if r["fault"]:
            f = summary["faults_min"].setdefault(r["fault"], {})
            for k, v in r["program"].items():
                f[k] = min(f.get(k, float("inf")), v)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            for r in rows + [{"summary": summary}]:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One traced run of a cell, with its window's device time and launch
calls placed on the program's spans.

    python3 h100bench/tools/span_split.py --workload <cell> --seed <n> \\
        [--seconds 20] [--out split.json]

Runs the cell as ``run.py --trace 1`` does, keeps the driver's profile,
and prints one JSON object: the run's result line (``correct`` and the
per-layer metrics), the window's device idle share, the part of it
inside the step spans (``rollout.step`` or ``train.step``), the launch
calls inside ``train.optimizer`` a train step, the span counts, each
span's host self time a step, and the window's idle time by innermost
span (``spans.idle_by_innermost``). The per-layer metrics of the
benchmark read the spans alone; this reads them against the device's
time line. Needs the card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def measure(cell_name: str, seed: int, seconds: float, device) -> dict:
    """The run's result and the split of its window, on ``device``."""
    from dlwp_torch.utils import profiling
    from h100bench import harness, spans, tracing

    class KeptRun(harness.Run):
        """A run whose driver's profile outlives the driver."""

        prof = None

        @contextlib.contextmanager
        def window(self):
            with tracing.window(self.trace, self.device.type) as prof:
                self.prof = prof
                yield prof

    cell = harness.load_cell(cell_name)
    run = KeptRun(cell=cell, seed=seed, seconds=seconds, trace=True,
                  device=device)
    profiling.clear_spans()
    result = harness.run_cell(run, harness.now())
    tl = spans.timeline(run.prof)
    records = profiling.spans(tl.t0_ns, tl.t1_ns)
    window = tl.t1_ns - tl.t0_ns
    train = cell.traffic["driver"] == "train"
    step = "train.step" if train else "rollout.step"
    by_name = collections.defaultdict(list)
    for r in records:
        by_name[r.name].append(r)
    steps = len(by_name[step])
    own = spans.self_ns(records)
    idle = spans.idle_by_innermost(tl, records)
    idle_s = sum(idle.values())
    out = {
        "cell": cell_name, "seed": seed, "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "window_s": window / 1e9,
        "device_idle_pct": 100.0 * (window - spans.total_ns(tl.busy_ns))
        / window,
        "step": step, "steps": steps,
        "dispatch_idle_pct": 100.0 * spans.idle_within(
            tl, [spans.clip(r, tl) for r in by_name[step]]) / window,
        "launches_per_step": len(tl.launch_ns) / steps if steps else None,
        "span_counts": {k: len(v) for k, v in by_name.items()},
        "self_ms_per_step": {
            k: sum(own[r.id] for r in v) / 1e6 / steps
            for k, v in by_name.items()} if steps else {},
        "idle_s": idle_s,
        "idle_share_by_innermost": {k: v / idle_s for k, v in idle.items()}
        if idle_s else {},
    }
    if train and steps:
        out["optimizer_launches_per_step"] = spans.launches_within(
            tl, [spans.clip(r, tl) for r in by_name["train.optimizer"]]) \
            / steps
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:] = [s for s in sys.path
                   if s and Path(s).resolve() != Path(__file__).resolve().parent]
    sys.path.insert(0, str(CHECKOUT))
    from h100bench import run as entry

    entry.set_caches()
    import torch

    if not torch.cuda.is_available():
        print("span_split: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(entry.HOST_THREADS)
    t0 = time.perf_counter()
    out = measure(args.workload, args.seed, args.seconds,
                  torch.device("cuda", 0))
    out["run_s"] = time.perf_counter() - t0
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m h100bench.run ...``) from the root of a checkout. Loads,
warms up, measures for ``--seconds``, checks the window's outputs against
the plain reference, and prints one JSON line last on standard output; the
numbers compared, each beside its limit, are the last lines on standard
error. Exits non-zero without a result when no card (or too few) is
there, when the program is missing, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# Caches of the program live in fixed directories of the checkout, so only
# a checkout's first run builds and compiles (the nvcc libraries stay in
# dlwp_torch/kernels/_build/).
CACHE = CHECKOUT / "h100bench" / ".cache"
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "CUDA_CACHE_PATH": "nv"}
HOST_THREADS = 1


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_caches() -> None:
    for var, sub in CACHE_DIRS.items():
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def fail(msg: str) -> int:
    print(f"h100bench: {msg}", file=sys.stderr, flush=True)
    return 2


def print_checks(rows: dict) -> None:
    for name, row in rows.items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    # Run as a script, the script's folder heads sys.path: the checkout
    # takes its place, so that the harness imports as the h100bench package.
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(here)]
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    set_caches()
    import torch

    from h100bench import harness

    try:
        cell = harness.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(str(e))
    if not torch.cuda.is_available():
        return fail("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} present")
    torch.set_num_threads(HOST_THREADS)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0))
    result = harness.run_cell(run, T_START)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"forbidden modules loaded: {', '.join(bad)}")
    print(json.dumps(result), flush=True)
    print_checks(result["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

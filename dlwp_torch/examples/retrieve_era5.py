#!/usr/bin/env python
"""ERA5 retrieval smoke script (reference ``examples/retrieve_era5.py``):
submit CDS requests for a 2-degree geopotential subset. Requires cdsapi +
credentials in deployment; ``--dry-run`` prints the request. Host only: no
device flag."""

from __future__ import annotations

import argparse
import json
from datetime import datetime


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root-directory", default=None)
    p.add_argument("--variables", default="geopotential")
    p.add_argument("--levels", default="500")
    p.add_argument("--years", default="2003")
    p.add_argument("--grid", type=float, default=2.0)
    p.add_argument("--dry-run", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from dlwp_torch.data.era5 import ERA5Reanalysis

    era = ERA5Reanalysis(root_directory=args.root_directory)
    variables = args.variables.split(",")
    levels = [int(l) for l in args.levels.split(",")]
    era.set_variables(variables)
    era.set_levels(levels)
    dates = [datetime(int(y), 1, 1) for y in args.years.split(",")]
    kwargs = {"grid": [args.grid, args.grid]}
    if args.dry_run:
        for v in variables:
            for l in levels:
                print(f"== {v}/{l} -> {era.file_path(v, l)}")
                print(json.dumps(era.build_request(v, l, dates, kwargs),
                                 indent=2))
        return
    era.retrieve(variables, levels, dates, request_kwargs=kwargs,
                 verbose=True)
    print("done")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""CFS reanalysis retrieval and monthly decode smoke script
(reference ``examples/write_cfs.py``). Requires network access and pygrib
in deployment; ``--dry-run`` prints the planned transfers offline. Host
only: no device flag."""

from __future__ import annotations

import argparse
from datetime import datetime


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root-directory", default=None)
    p.add_argument("--start", default="2003-01-01")
    p.add_argument("--end", default="2003-01-03")
    p.add_argument("--resolution", default="l", choices=["l", "h"])
    p.add_argument("--variables", default="HGT")
    p.add_argument("--levels", default="500")
    p.add_argument("--dry-run", action="store_true",
                   help="print URLs without downloading")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from dlwp_torch.data.cfs import CFSReanalysis

    cfs = CFSReanalysis(root_directory=args.root_directory,
                        resolution=args.resolution)
    start = datetime.fromisoformat(args.start)
    end = datetime.fromisoformat(args.end)
    cfs.set_dates([start, end])
    print(f"{len(cfs.dataset_dates)} analysis times")
    if args.dry_run:
        for dt in cfs.dataset_dates[:8]:
            print(" ", cfs.grib_url(dt))
        return
    cfs.retrieve(verbose=True)
    cfs.write(variables=args.variables.split(","),
              levels=[int(l) for l in args.levels.split(",")],
              verbose=True)
    print("done")


if __name__ == "__main__":
    main()

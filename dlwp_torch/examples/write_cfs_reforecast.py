#!/usr/bin/env python
"""CFS Reforecast retrieval and monthly decode workflow (reference
``examples/write_cfs_reforecast.py``): download the 45-day/4-month hindcast
GRIBs for a variable set, then decode them into monthly
``(f_hour, time, lat, lon)`` HDF5 files, optionally spline-regridded onto
the reanalysis grid for skill comparison (reference cfsr.py:1014-1019,
used by examples/validate.py:278-301).

Requires network access and pygrib in deployment; ``--dry-run`` prints the
planned transfers offline. Host only: no device flag.
"""

from __future__ import annotations

import argparse
from datetime import datetime


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root-directory", default=None,
                   help="reforecast GRIB/HDF5 storage root")
    p.add_argument("--meta-root", default=None,
                   help="CFSReanalysis root whose grid the reforecast is "
                        "regridded onto (omit to keep the native 1-degree "
                        "grid)")
    p.add_argument("--start", default="2003-01-01")
    p.add_argument("--end", default="2003-01-07")
    p.add_argument("--variables", default="z500",
                   help="comma-separated reforecast variables")
    p.add_argument("--max-f-hours", type=int, default=144)
    p.add_argument("--dry-run", action="store_true",
                   help="print URLs without downloading")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from dlwp_torch.data.cfs import CFSReanalysis, CFSReforecast

    variables = args.variables.split(",")
    start = datetime.fromisoformat(args.start)
    end = datetime.fromisoformat(args.end)

    cfs = CFSReforecast(root_directory=args.root_directory)
    cfs.set_dates([start, end])
    print(f"{len(cfs.dataset_dates)} reforecast initialization times")
    if args.dry_run:
        for dt in cfs.dataset_dates[:4]:
            for var in variables:
                print(" ", cfs.grib_url(var, dt))
        return

    regrid_to = None
    if args.meta_root:
        # Interpolate onto the reanalysis grid so forecast/analysis verify
        # on identical coordinates (reference write + interpolate=...).
        meta = CFSReanalysis(root_directory=args.meta_root)
        meta.set_dates([start, end])
        meta.open()
        regrid_to = (meta.lat, meta.lon)

    cfs.retrieve(variables=variables, verbose=True)
    cfs.write(variables=variables, max_f_hours=args.max_f_hours,
              regrid_to=regrid_to, verbose=True)
    print("done")


if __name__ == "__main__":
    main()

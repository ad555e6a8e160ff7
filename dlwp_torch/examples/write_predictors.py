#!/usr/bin/env python
"""Build a predictor file from an opened data source.

Equivalent of the reference's ``examples/write_cfs_predictors.py``:
data source -> Preprocessor.data_to_series (streamed, scaled) -> HDF5
predictor file consumable by SeriesSampler/training. Works with the CFS
reader (``--cfs-root`` after retrieve/write), or synthetic data by default.
Host only (numpy and h5py): no device flag.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfs-root", default=None,
                   help="CFSReanalysis root directory with monthly files")
    p.add_argument("--months", default=None,
                   help="comma list of YYYYMM months to open")
    p.add_argument("--variables", default="HGT,THICK")
    p.add_argument("--levels", default="500,300-700")
    p.add_argument("--pairwise", action="store_true", default=True)
    p.add_argument("--no-scale", action="store_true")
    p.add_argument("--batch-samples", type=int, default=1000)
    p.add_argument("--n-samples", type=int, default=600,
                   help="synthetic-source archive length (6-hourly samples)")
    p.add_argument("--output-file", default="predictors.h5")
    return p.parse_args(argv)


def build(args):
    """The Preprocessor of ``args`` after ``data_to_series`` (the series
    in memory): ``(preprocessor, dataset)``."""
    from dlwp_torch.data import Preprocessor

    if args.cfs_root:
        from dlwp_torch.data.cfs import CFSReanalysis

        cfs = CFSReanalysis(root_directory=args.cfs_root)
        months = [
            (int(m[:4]), int(m[4:6])) for m in args.months.split(",")
        ] if args.months else None
        source = cfs.open(months)
    else:
        from dlwp_torch.examples._synthetic import SyntheticGlobalSource

        print("no --cfs-root; using synthetic source")
        source = SyntheticGlobalSource(n_samples=args.n_samples)

    variables = args.variables.split(",")
    levels = [l if "-" in l else int(l) for l in args.levels.split(",")]
    pp = Preprocessor(source)
    ds = pp.data_to_series(
        variables, levels, pairwise=args.pairwise,
        scale_variables=not args.no_scale,
        batch_samples=args.batch_samples,
    )
    return pp, ds


def main(argv=None):
    """Write the predictor file; returns the dataset."""
    args = parse_args(argv)
    pp, ds = build(args)
    pp.to_file(args.output_file)
    print(f"wrote {args.output_file}: dims {ds.dims}, varlev {ds.varlev}")
    return ds


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Generate a barotropic-dynamics training archive (the "paper run" data).

The reference trains and validates on downloaded reanalysis archives
(examples/write_cfs_predictors.py); the equivalent chaotic-dynamics archive
comes from the package's own spectral barotropic core (the reference's
physics baseline): a multi-year, 6-hourly, perturbed-restart Z500 +
relative-vorticity series at the reference's 2.5-degree T72 configuration
(run_barotropic.py:23-25,40-41), streamed through the Preprocessor into a
standard predictor file.

Downstream, the usual workflow applies unchanged:
    python -m dlwp_torch.examples.train_convlstm --predictor-file archive.h5
    python -m dlwp_torch.examples.validate --predictor-file archive.h5 \\
        --model-file ...

Flags as in the JAX package's script, plus ``--device``. ``--step-impl``
takes the port's names, 'plain' or 'kernel' (the ``barotropic_step``
kernel where the source integrates a single member).
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--years", type=float, default=4.0,
                   help="total archive length in years (6-hourly samples)")
    p.add_argument("--nlat", type=int, default=73)
    p.add_argument("--nlon", type=int, default=144)
    p.add_argument("--truncation", type=int, default=72)
    p.add_argument("--dt", type=float, default=1800.0,
                   help="model step [s] (reference run_barotropic.py: 1800)")
    p.add_argument("--segment-days", type=int, default=92,
                   help="days per perturbed-restart segment")
    p.add_argument("--damping", type=float, default=5e-6)
    p.add_argument("--wave-rms", type=float, default=120.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--step-impl", default="plain", choices=["plain", "kernel"])
    p.add_argument("--truth-truncation", type=int, default=None,
                   help="two-truth mode: integrate the generating dynamics "
                        "at this HIGHER truncation on a finer grid and "
                        "band-limit snapshots to --truncation on the "
                        "archive grid, so a baseline core at --truncation "
                        "has genuine model error (e.g. 106 for a T72 "
                        "archive)")
    p.add_argument("--truth-nlat", type=int, default=None,
                   help="truth-integration grid rows (default: grid-"
                        "spacing halving, 2*(nlat-1)+1)")
    p.add_argument("--truth-nlon", type=int, default=None,
                   help="truth-integration grid columns (default: 2*nlon)")
    p.add_argument("--batch-samples", type=int, default=1000)
    p.add_argument("--output-file", default="barotropic_archive.h5")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch version of the kernel)")
    return p.parse_args(argv)


def archive_source(args):
    """The :class:`~dlwp_torch.data.BarotropicArchiveSource` of ``args``;
    its fields integrate at first use."""
    from dlwp_torch.data import BarotropicArchiveSource

    return BarotropicArchiveSource(
        n_samples=int(args.years * 365.25 * 4),
        nlat=args.nlat,
        nlon=args.nlon,
        truncation=args.truncation,
        dt=args.dt,
        segment_days=args.segment_days,
        damping_coefficient=args.damping,
        wave_rms=args.wave_rms,
        seed=args.seed,
        step_impl=args.step_impl,
        truth_truncation=args.truth_truncation,
        truth_nlat=args.truth_nlat,
        truth_nlon=args.truth_nlon,
        device=args.device,
    )


def write_archive(args, src, output_file):
    """Stream ``src``'s HGT/500 and VRT/500 series, scaled, through the
    Preprocessor into ``output_file`` (HDF5; None keeps it in memory);
    returns the dataset."""
    from dlwp_torch.data import Preprocessor

    return Preprocessor(src).data_to_series(
        ["HGT", "VRT"], [500, 500], pairwise=True, scale_variables=True,
        batch_samples=args.batch_samples, output_file=output_file,
    )


def main(argv=None):
    """Write the archive; returns its (lazily read) dataset."""
    args = parse_args(argv)
    src = archive_source(args)
    t0 = time.time()
    ds = write_archive(args, src, args.output_file)
    print(
        f"wrote {args.output_file}: dims {ds.dims}, varlev {ds.varlev}, "
        f"{src.n_segments} segments x {src.segment_days} d, "
        f"{time.time() - t0:.0f} s"
    )
    return ds


if __name__ == "__main__":
    main()

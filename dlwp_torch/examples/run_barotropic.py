#!/usr/bin/env python
"""Batch barotropic model integration.

Equivalent of the reference's ``examples/run_barotropic.py``: initialize the
spectral barotropic model from 500-hPa height fields at a batch of analysis
times and integrate 144 hours, saving 6-hourly height snapshots (the
reference steps one init time at a time through Fortran transforms).

Flags as in the JAX package's script, plus ``--device``. ``--step-impl``
takes the port's names: 'plain' (the PyTorch engine, the JAX script's
'xla') or 'kernel' (the fused ``barotropic_step`` kernel, its 'pallas'),
which runs a single member: with one init time the whole integration is
one kernel launch a snapshot interval on a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictor-file", default=None,
                   help="series predictor file with an HGT channel")
    p.add_argument("--truncation", type=int, default=42)
    p.add_argument("--dt", type=float, default=1800.0, help="seconds")
    p.add_argument("--hours", type=float, default=144.0)
    p.add_argument("--snapshot-hours", type=float, default=6.0)
    p.add_argument("--damping", type=float, default=5e-6)
    p.add_argument("--n-init", type=int, default=4, help="batched init times")
    p.add_argument("--output-file", default="barotropic_forecast.h5")
    p.add_argument("--step-impl", choices=["plain", "kernel"], default="plain",
                   help="'kernel' = the fused barotropic_step kernel "
                        "(single member)")
    p.add_argument("--fourier", choices=["fft", "matmul"], default="fft",
                   help="longitude transform implementation")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch version of the kernel)")
    return p.parse_args(argv)


def integrate(args):
    """The integration of ``args``: ``(t_snap seconds, z snapshots
    (n_snaps, n_init, nlat, nlon) as numpy, grid, init times)``."""
    import torch

    from dlwp_torch.barotropic import BarotropicModelPsi
    from dlwp_torch.device import resolve_device
    from dlwp_torch.grid import LatLonGrid

    device = resolve_device(args.device)
    if args.predictor_file:
        from dlwp_torch.data import PredictorDataset

        data = PredictorDataset.from_file(args.predictor_file)
        hgt = [i for i, v in enumerate(data.varlev) if v.startswith("HGT")]
        z0 = data.inverse_scale(
            np.asarray(data.predictors)[: args.n_init]
        )[:, hgt[0]]
        lat, lon = np.asarray(data.lat), np.asarray(data.lon)
        times = np.asarray(data.sample[: args.n_init])
    else:
        print("no predictor file; using synthetic initial heights")
        from dlwp_torch.examples._synthetic import SyntheticGlobalSource

        src = SyntheticGlobalSource(n_samples=args.n_init, nlat=73, nlon=144)
        z0 = src.field("HGT", 500)
        lat, lon = src.lat, src.lon
        times = src.times

    grid = (
        LatLonGrid.regular(len(lat), len(lon))
        if abs(abs(lat[0]) - 90.0) < 1e-6
        else LatLonGrid.from_coords(lat, lon)
    )
    model = BarotropicModelPsi(
        grid, args.truncation, dt=args.dt,
        damping_coefficient=args.damping, dtype=torch.float32,
        fourier=args.fourier, step_impl=args.step_impl, device=device,
    )
    z0 = np.asarray(z0, dtype=np.float32)
    # The fused kernel takes single-member states; with one init time,
    # drop the batch axis so --step-impl kernel engages (batched states
    # run the plain engine).
    squeeze_member = args.step_impl == "kernel" and args.n_init == 1
    if args.step_impl == "kernel" and args.n_init > 1:
        print("note: step_impl='kernel' is single-member; batched init "
              "times use the plain engine")
    state = model.from_z(z0[0] if squeeze_member else z0)
    snap_every = int(args.snapshot_hours * 3600.0 / args.dt)
    n_snaps = int(args.hours / args.snapshot_hours)

    t0 = time.time()
    _, t_snap, zs = model.run_with_snapshots(state, n_snaps, snap_every)
    zs = zs.cpu().numpy()  # (n_snaps, n_init, nlat, nlon)
    elapsed = time.time() - t0
    if squeeze_member:
        zs = zs[:, None]  # restore the member axis for the output file
    n_steps = n_snaps * snap_every
    print(
        f"integrated {args.n_init} x {n_steps} steps in {elapsed:.2f}s "
        f"({args.n_init * n_steps / elapsed:.0f} member-steps/s)"
    )
    return np.asarray(t_snap), zs, grid, times


def main(argv=None):
    """Integrate and write the snapshots to ``--output-file`` (HDF5)."""
    args = parse_args(argv)
    t_snap, zs, grid, times = integrate(args)
    # Overflow check (reference run_barotropic.py:52-53).
    if not np.isfinite(zs).all():
        raise RuntimeError("numerical overflow in barotropic integration")

    import h5py

    with h5py.File(args.output_file, "w") as f:
        f.create_dataset("z", data=zs)
        f.create_dataset("f_hour", data=t_snap / 3600.0)
        f.create_dataset("lat", data=grid.lat)
        f.create_dataset("lon", data=grid.lon)
        f.create_dataset(
            "init_time",
            data=np.asarray(times, dtype="datetime64[ns]").astype(np.int64),
        )
    print(f"saved {args.output_file}")


if __name__ == "__main__":
    main()

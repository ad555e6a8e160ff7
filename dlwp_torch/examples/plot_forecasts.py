#!/usr/bin/env python
"""Plot example forecast maps (reference ``examples/plot_forecasts.py``).

Rolls out a forecast, then renders verification-vs-forecast panels and a
spectral vorticity diagnostic (the spherical Laplacian of height -- the
reference computes this via the spharm engine, plot_forecasts.py:173).
Needs matplotlib. Flags as in the JAX package's script, plus ``--device``.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictor-file", default=None)
    p.add_argument("--model-file", default=None)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--out-prefix", default="forecast_plot")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p.parse_args(argv)


def quick_model(data, device, width=32, seed=0, epochs=3, shuffle=False):
    """The plot scripts' stand-in model when no ``--model-file`` is given:
    two convs (``width`` features) trained ``epochs`` epochs."""
    from dlwp_torch.data import SeriesSampler
    from dlwp_torch.models import DLWPNeuralNet

    dlwp = DLWPNeuralNet(time_dim=1, scaler_type=None, device=device)
    s0 = SeriesSampler(data, model=dlwp, batch_size=64, shuffle=shuffle,
                       seed=seed)
    c = s0.convolution_shape[0]
    dlwp.build_model([
        ("CyclicConv2D", (width, 3), {"activation": "tanh"}),
        ("CyclicConv2D", (c, 3), {}),
    ], seed=seed)
    dlwp.fit_generator(s0, epochs=epochs, verbose=False)
    return dlwp


def main(argv=None):
    args = parse_args(argv)
    import torch

    from dlwp_torch.data import SeriesSampler
    from dlwp_torch.device import resolve_device
    from dlwp_torch.examples._synthetic import load_or_synthetic
    from dlwp_torch.forecast import TimeSeriesEstimator
    from dlwp_torch.grid import LatLonGrid
    from dlwp_torch.plot import forecast_example_plot, plot_global_map
    from dlwp_torch.spectral import SphericalHarmonics
    from dlwp_torch.utils import load_model

    device = resolve_device(args.device)
    data = load_or_synthetic(args.predictor_file, note=None)

    if args.model_file:
        dlwp = load_model(args.model_file, device=device)
    else:
        dlwp = quick_model(data, device)

    gen = SeriesSampler(data, model=dlwp, input_time_steps=dlwp.time_dim,
                        output_time_steps=dlwp.time_dim, batch_size=64)
    est = TimeSeriesEstimator(dlwp, gen)
    fc = est.predict(args.steps, samples=[0], unscale=True)

    series = np.asarray(data.predictors)
    phys = data.inverse_scale(series[args.steps])
    forecast_example_plot(
        phys[0], fc.values[-1, 0, 0], data.lat, data.lon,
        f_hour=fc.f_hour[-1], file_path=f"{args.out_prefix}_panels.png",
    )
    print(f"saved {args.out_prefix}_panels.png")

    # Spherical-Laplacian vorticity diagnostic of the forecast height.
    lat = np.asarray(data.lat)
    grid = (
        LatLonGrid.regular(len(lat), len(data.lon))
        if abs(abs(lat[0]) - 90.0) < 1e-6
        else LatLonGrid.from_coords(lat, np.asarray(data.lon))
    )
    sh = SphericalHarmonics.build(grid, max(8, min(42, grid.nlat - 2)),
                                  device=device)
    z = torch.as_tensor(fc.values[-1, 0, 0], dtype=torch.float32,
                        device=device)
    lap = sh.laplacian(z).cpu().numpy()
    ax = plot_global_map(
        data.lat, data.lon, lap, title="laplacian(z) diagnostic",
        cmap="RdBu_r",
    )
    ax.figure.savefig(f"{args.out_prefix}_laplacian.png", dpi=120,
                      bbox_inches="tight")
    print(f"saved {args.out_prefix}_laplacian.png")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Animated forecast movie (reference ``examples/plot_movie.py``): roll a
forecast out (default 16 steps) and render an animated GIF of the height
field. Needs matplotlib. Flags as in the JAX package's script, plus
``--device``."""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictor-file", default=None)
    p.add_argument("--model-file", default=None)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--output-file", default="forecast_movie.gif")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from dlwp_torch.data import SeriesSampler
    from dlwp_torch.device import resolve_device
    from dlwp_torch.examples._synthetic import load_or_synthetic
    from dlwp_torch.examples.plot_forecasts import quick_model
    from dlwp_torch.forecast import TimeSeriesEstimator
    from dlwp_torch.plot import plot_movie
    from dlwp_torch.utils import load_model

    device = resolve_device(args.device)
    data = load_or_synthetic(args.predictor_file, note=None)

    if args.model_file:
        dlwp = load_model(args.model_file, device=device)
    else:
        dlwp = quick_model(data, device)

    gen = SeriesSampler(data, model=dlwp, batch_size=64)
    est = TimeSeriesEstimator(dlwp, gen)
    fc = est.predict(args.steps, samples=[0], unscale=True)
    frames = fc.values[:, 0, 0]
    titles = [f"+{int(h)}h" for h in fc.f_hour]
    plot_movie(frames, data.lat, data.lon, args.output_file, titles=titles)
    print(f"saved {args.output_file}")


if __name__ == "__main__":
    main()

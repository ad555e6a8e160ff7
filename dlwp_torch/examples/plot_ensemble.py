#!/usr/bin/env python
"""Multi-model ensemble spaghetti verification
(reference ``examples/plot_ensemble.py``): roll out forecasts from several
saved models (or quickly trained variants) and plot their RMSE curves plus
the ensemble mean. Needs matplotlib. Flags as in the JAX package's script,
plus ``--device``."""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictor-file", default=None)
    p.add_argument("--model-files", nargs="*", default=None,
                   help="saved model prefixes; default trains 3 seeds")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--plot-file", default="ensemble_rmse.png")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    """Plot the curves; returns them (scaled RMSE by model name)."""
    args = parse_args(argv)
    from dlwp_torch.data import SeriesSampler
    from dlwp_torch.device import resolve_device
    from dlwp_torch.examples._synthetic import load_or_synthetic
    from dlwp_torch.examples.plot_forecasts import quick_model
    from dlwp_torch.forecast import TimeSeriesEstimator, verify
    from dlwp_torch.utils import load_model

    device = resolve_device(args.device)
    data = load_or_synthetic(args.predictor_file, note=None)

    models = []
    if args.model_files:
        for mf in args.model_files:
            models.append((mf, load_model(mf, device=device)))
    else:
        for seed in range(3):
            models.append((f"seed{seed}", quick_model(
                data, device, width=16 + 16 * seed, seed=seed,
                shuffle=True)))

    curves = {}
    fcs = []
    for name, dlwp in models:
        gen = SeriesSampler(data, model=dlwp, batch_size=64)
        est = TimeSeriesEstimator(dlwp, gen)
        fc = est.predict(args.steps)
        ver, f_hour = verify.verification_from_series(
            data, forecast_steps=fc.values.shape[0],
            dt_hours=int(est._dt_hours), init_times=fc.times, all_data=data,
        )
        out_idx = data.varlev_index(fc.varlev)
        curves[name] = verify.forecast_error(
            fc.values[:, :, 0], ver[:, :, out_idx][:, :, 0], method="rmse",
            axis=tuple(range(1, fc.values[:, :, 0].ndim)),
        )
        fcs.append(fc.values)

    ens_mean = np.nanmean(np.stack(fcs), axis=0)
    curves["ensemble_mean"] = verify.forecast_error(
        ens_mean[:, :, 0], ver[:, :, out_idx][:, :, 0], method="rmse",
        axis=tuple(range(1, ens_mean[:, :, 0].ndim)),
    )

    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    for name, c in curves.items():
        style = {"lw": 2.5, "color": "k"} if name == "ensemble_mean" else {"alpha": 0.7}
        ax.plot(f_hour, c, label=name, **style)
    ax.set_xlabel("forecast hour")
    ax.set_ylabel("RMSE (scaled units)")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(args.plot_file, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {args.plot_file}")
    return curves


if __name__ == "__main__":
    main()

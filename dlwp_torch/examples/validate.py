#!/usr/bin/env python
"""Forecast validation workflow.

Equivalent of the reference's ``examples/validate.py``: load a trained
model, roll out autoregressive forecasts with TimeSeriesEstimator, and
compare RMSE-vs-forecast-hour against persistence, climatology, and the
barotropic dynamical core. Produces an RMSE plot and a pickled result dict.

Runs end-to-end on synthetic demo data when no files are given (it trains a
small model in-line first). Flags as in the JAX package's script, plus
``--device``; the forecast and the barotropic baseline run there.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictor-file", default=None)
    p.add_argument("--model-file", default=None,
                   help="saved model prefix (default: quick in-line train)")
    p.add_argument("--forecast-steps", type=int, default=12,
                   help="model iterations (x dt hours each)")
    p.add_argument("--validation-fraction", type=float, default=0.2)
    p.add_argument("--plot-file", default="validate_rmse.png")
    p.add_argument("--output-file", default="validate_results.pkl")
    p.add_argument("--emit-json", default=None, metavar="PATH",
                   help="also write a small auditable JSON artifact: "
                        "leads x {forecast, persistence, climatology, "
                        "monthly_climo, barotropic} RMSE in physical "
                        "units, plus the run configuration and its hash "
                        "(commit-able, regression-diffable -- unlike the "
                        "pickle, which holds raw arrays)")
    p.add_argument("--barotropic", action="store_true", default=True,
                   help="include the barotropic physics baseline")
    p.add_argument("--barotropic-form", default="psi",
                   choices=["psi", "vrt"],
                   help="baseline core: 'psi' (geostrophic Z500 init, the "
                        "reference's configuration, model.py:202-346) or "
                        "'vrt' (pure vorticity form -- use for archives "
                        "generated by BarotropicArchiveSource, whose "
                        "superrotation base state the psi form's "
                        "southern-hemisphere f0 convention mistreats)")
    p.add_argument("--barotropic-truncation", type=int, default=None,
                   help="baseline spectral truncation (default: min(42, "
                        "nlat-2), the reference validate.py:250-273 scale)")
    p.add_argument("--init-batch-size", type=int, default=256,
                   help="chunk the forecast init times through the rollout "
                        "in fixed-size device batches (bounds device "
                        "memory for large validation sets)")
    p.add_argument("--variable", default="HGT/500")
    p.add_argument("--lat-range", default="20,70",
                   help="verification latitude band 'south,north' "
                        "(reference validate.py:89-93 scores 20-70N; "
                        "'all' scores every row incl. poles, where "
                        "cos-weighted training assigns ~zero weight)")
    p.add_argument("--add-insolation", default="auto",
                   choices=["auto", "on", "off"],
                   help="insolation input channel for the validation "
                        "sampler; 'auto' matches the loaded model's "
                        "trained input shape (the reference requires "
                        "re-specifying this by hand, validate.py:191-194)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    """Score the forecast and the baselines; returns the RMSE rows
    (scaled units) with ``f_hour``."""
    args = parse_args(argv)
    from dlwp_torch.data import SeriesSampler
    from dlwp_torch.device import resolve_device
    from dlwp_torch.examples._synthetic import load_or_synthetic
    from dlwp_torch.forecast import TimeSeriesEstimator, verify
    from dlwp_torch.models import DLWPNeuralNet
    from dlwp_torch.utils import load_model, train_test_split_ind

    device = resolve_device(args.device)
    data = load_or_synthetic(args.predictor_file)

    if args.model_file:
        dlwp = load_model(args.model_file, device=device)
        # Reconcile the spatial grid with the trained input shape: a model
        # trained under train.py's --crop-north-pole default expects one
        # fewer latitude row (reference train.py:86-87).
        trained = dlwp.input_sample_shape
        if (trained is not None and data.lat[0] == 90.0
                and trained[-2] == data.predictors.shape[-2] - 1):
            print("auto: cropping the 90N row to match the trained grid")
            data.predictors = np.asarray(data.predictors)[..., 1:, :]
            data.lat = data.lat[1:]
    else:
        dlwp = None

    n = data.predictors.shape[0]
    n_val = int(n * args.validation_fraction)
    train_idx, val_idx = train_test_split_ind(n, n_val, method="last")
    val_data = data.isel_sample(val_idx)

    if dlwp is None:
        print("training a quick demo model in-line...")
        dlwp = DLWPNeuralNet(time_dim=1, scaler_type=None, device=device)
        sampler0 = SeriesSampler(
            data.isel_sample(train_idx), model=dlwp, batch_size=64
        )
        c = sampler0.convolution_shape[0]
        dlwp.build_model(
            [("CyclicConv2D", (32, 3), {"activation": "tanh"}),
             ("CyclicConv2D", (c, 3), {})],
        )
        dlwp.fit_generator(sampler0, epochs=5, verbose=False)

    if args.add_insolation == "auto":
        # Match the trained input shape: +1 channel per time step means the
        # model was trained with the insolation forcing channel.
        probe = SeriesSampler(val_data, model=dlwp,
                              input_time_steps=dlwp.time_dim,
                              output_time_steps=dlwp.time_dim, batch_size=64)
        trained = dlwp.input_sample_shape
        add_sol = (trained is not None
                   and tuple(trained) != tuple(probe.convolution_shape))
        if add_sol:
            print("auto: model was trained with an insolation channel")
    else:
        add_sol = args.add_insolation == "on"
    val_gen = SeriesSampler(val_data, model=dlwp,
                            input_time_steps=dlwp.time_dim,
                            output_time_steps=dlwp.time_dim, batch_size=64,
                            add_insolation=add_sol)
    if (dlwp.input_sample_shape is not None
            and tuple(val_gen.convolution_shape)
            != tuple(dlwp.input_sample_shape)):
        raise SystemExit(
            f"validation sampler item shape {val_gen.convolution_shape} "
            f"does not match the model's trained input shape "
            f"{dlwp.input_sample_shape}; check --add-insolation and the "
            f"predictor file's variable set"
        )
    estimator = TimeSeriesEstimator(dlwp, val_gen)
    n_iter = args.forecast_steps // estimator._out_ts
    forecast = estimator.predict(
        max(1, n_iter), init_batch_size=args.init_batch_size
    )
    dt_hours = estimator._dt_hours
    steps_out = forecast.values.shape[0]

    # Verification: state at init + (f+1) dt for each init time.
    ver, f_hour = verify.verification_from_series(
        val_data, forecast_steps=steps_out, dt_hours=int(dt_hours),
        init_times=forecast.times, all_data=data,
    )
    out_idx = val_data.varlev_index(forecast.varlev)
    ver = ver[:, :, out_idx]

    v = forecast.varlev.index(args.variable) if args.variable in forecast.varlev else 0
    # Verification latitude band (reference validate.py:89-93): scoring is
    # restricted to rows inside it -- pole rows carry ~zero cos(lat)
    # training weight and the spectral height inversion is ill-conditioned
    # there, so global-mean RMSE would be dominated by rows no method is
    # asked to predict.
    if args.lat_range == "all":
        lat_sel = slice(None)
    else:
        lo, hi = (float(s) for s in args.lat_range.split(","))
        lat_sel = np.where(
            (np.asarray(data.lat) >= lo) & (np.asarray(data.lat) <= hi)
        )[0]
        if len(lat_sel) == 0:
            raise SystemExit(f"no latitude rows in band {args.lat_range}")
    fc_v = forecast.values[:, :, v][..., lat_sel, :]
    ver_v = ver[:, :, v][..., lat_sel, :]
    err_axis = tuple(range(1, ver_v.ndim))
    results = {"f_hour": f_hour}
    results["forecast_rmse"] = verify.forecast_error(
        fc_v, ver_v, method="rmse", axis=err_axis,
    )
    # Persistence baseline: the initial state held fixed, scored against
    # the SAME lead-aligned verification as the forecast (the reference
    # repeats the init state over the f_hour axis, validate.py:306-317).
    init_idx = [
        int(np.where(np.asarray(val_data.sample) == t)[0][0])
        for t in forecast.times
    ]
    init = np.asarray(val_data.predictors)[init_idx][:, out_idx][:, v]
    init = init[..., lat_sel, :]
    results["persistence_rmse"] = verify.forecast_error(
        np.repeat(init[None], steps_out, axis=0), ver_v,
        method="rmse", axis=err_axis,
    )
    # Constant-climatology baseline on the same verification axis.
    series = np.asarray(val_data.predictors)[:, out_idx][:, v][..., lat_sel, :]
    climo = np.nanmean(series, axis=0)
    results["climatology_rmse"] = verify.forecast_error(
        np.broadcast_to(climo, (steps_out,) + ver_v.shape[1:]),
        ver_v, method="rmse", axis=err_axis,
    )
    # Month-aware climatology baseline (the reference's workflow,
    # validate.py:319-325): climatology from the full archive, a
    # month-of-valid-time climo "forecast" for each (init, lead) pair of
    # the same verification subset. Skipped when the archive spans less
    # than a year (months without samples).
    full_times = np.asarray(data.sample, dtype="datetime64[ns]")
    span_days = (full_times.max() - full_times.min()) / np.timedelta64(1, "D")
    if span_days >= 360.0:
        full_series = np.asarray(data.predictors)[:, out_idx][:, v]
        full_series = full_series[..., lat_sel, :]
        months_all = full_times.astype("datetime64[M]").astype(int) % 12
        climo12 = np.stack([
            np.nanmean(full_series[months_all == m], axis=0)
            if (months_all == m).any()
            else np.full(full_series.shape[1:], np.nan)
            for m in range(12)
        ])
        lead_min = ((np.arange(steps_out) + 1)
                    * int(round(dt_hours * 60))).astype("timedelta64[m]")
        ver_times = (
            np.asarray(forecast.times, dtype="datetime64[ns]")[None, :]
            + lead_min[:, None]
        )
        ver_months = ver_times.astype("datetime64[M]").astype(int) % 12
        results["monthly_climo_rmse"] = verify.forecast_error(
            climo12[ver_months], ver_v, method="rmse", axis=err_axis,
        )
    else:
        print("archive spans < 1 year; monthly climatology baseline skipped"
              " (constant climatology row applies)")

    if args.barotropic:
        results["barotropic_rmse"] = barotropic_baseline(
            data, val_data, forecast, ver, v, dt_hours, steps_out, lat_sel,
            form=args.barotropic_form,
            truncation=args.barotropic_truncation, device=device,
        )

    # Report in physical units for the chosen variable.
    std = data.std[out_idx][v] if data.std is not None else 1.0
    print(f"\nRMSE vs forecast hour ({args.variable}, physical units):")
    print(f"{'f_hour':>8}" + "".join(
        f"{k.split('_')[0]:>14}" for k in results if k.endswith("_rmse")
    ))
    for i, fh in enumerate(f_hour):
        row = f"{fh:>8.0f}"
        for k in results:
            if k.endswith("_rmse"):
                row += f"{results[k][i] * std:>14.2f}"
        print(row)

    try:
        from dlwp_torch.plot import history_plot  # noqa: F401
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        for k in results:
            if k.endswith("_rmse"):
                ax.plot(f_hour, np.asarray(results[k]) * std,
                        label=k.replace("_rmse", ""))
        ax.set_xlabel("forecast hour")
        ax.set_ylabel(f"RMSE ({args.variable})")
        ax.legend()
        ax.grid(alpha=0.3)
        fig.savefig(args.plot_file, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"saved {args.plot_file}")
    except Exception as e:
        print(f"plotting skipped: {e}")

    with open(args.output_file, "wb") as f:
        pickle.dump(results, f)
    print(f"saved {args.output_file}")

    if args.emit_json:
        import hashlib
        import json

        # The device is left out: the rows agree across devices within
        # the port's float32 limits, so a card run and a CPU run of one
        # configuration share its hash.
        config = {k: v for k, v in sorted(vars(args).items())
                  if k not in ("emit_json", "plot_file", "output_file",
                               "device")}
        payload = {
            "config": config,
            "config_hash": hashlib.sha256(
                json.dumps(config, sort_keys=True).encode()
            ).hexdigest()[:16],
            "variable": args.variable,
            "units": "physical (scaled by the predictor file's std)",
            "n_init_times": int(forecast.values.shape[1]),
            "f_hour": [float(fh) for fh in f_hour],
            "rmse": {
                k.replace("_rmse", ""): [
                    round(float(x) * float(std), 4) for x in results[k]
                ]
                for k in results if k.endswith("_rmse")
            },
        }
        with open(args.emit_json, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"saved {args.emit_json}")
    return results


def barotropic_baseline(data, val_data, forecast, ver, v, dt_hours,
                        steps_out, lat_sel=slice(None), form="psi",
                        truncation=None, device=None):
    """Barotropic physics baseline (reference validate.py:250-273): a
    float32 core from the unscaled variable ``v`` at each init time, run
    on ``device`` to every lead and scored in scaled units."""
    import torch

    from dlwp_torch.barotropic import BarotropicModel, BarotropicModelPsi
    from dlwp_torch.forecast import verify
    from dlwp_torch.grid import LatLonGrid

    out_idx = val_data.varlev_index(forecast.varlev)
    lat, lon = np.asarray(data.lat), np.asarray(data.lon)
    if abs(abs(lat[0]) - 90.0) < 1e-6:
        grid = LatLonGrid.regular(len(lat), len(lon))
    else:
        grid = LatLonGrid.from_coords(lat, lon)
    # Initialize from the (unscaled) first variable at each init time.
    init_idx = [
        int(np.where(np.asarray(val_data.sample) == t)[0][0])
        for t in forecast.times
    ]
    z0_scaled = np.asarray(val_data.predictors)[init_idx][:, out_idx][:, v]
    mean = data.mean[out_idx][v] if data.mean is not None else 0.0
    std = data.std[out_idx][v] if data.std is not None else 1.0
    z0 = z0_scaled * std + mean
    dt = 1800.0
    cls = BarotropicModel if form == "vrt" else BarotropicModelPsi
    trunc = truncation or min(42, grid.nlat - 2)
    model = cls(grid, trunc, dt=dt, damping_coefficient=5e-6,
                dtype=torch.float32, device=device)
    state = model.from_z(z0)
    every = max(1, int(dt_hours * 3600.0 / dt))
    _, _, zs = model.run_with_snapshots(state, steps_out, every)
    zs = (zs.cpu().numpy() - mean) / std  # back to scaled space
    zs = zs[..., lat_sel, :]
    return verify.forecast_error(
        zs, ver[:, :, v][..., lat_sel, :], method="rmse",
        axis=tuple(range(1, zs.ndim)),
    )


if __name__ == "__main__":
    main()

"""Forecast verification metrics (port of ``dlwp_tpu.forecast.verify``).

The JAX package's module is numpy only; this is the port's own copy, so
the port imports nothing of ``dlwp_tpu``. Forecast, persistence and
climatology errors (with the reference's lagged-valid alignment),
month-aware climatology, the anomaly correlation, and the builders of
verification arrays, all on host numpy arrays (the forecast step first),
which is what ``TimeSeriesEstimator.predict`` returns. The builders
return (f_hour, time, ...) arrays aligned by datetime lookup.
"""

from __future__ import annotations

import numpy as np


def _err(diff: np.ndarray, method: str, axis):
    if method == "mse":
        return np.nanmean(diff**2, axis=axis)
    if method == "mae":
        return np.nanmean(np.abs(diff), axis=axis)
    if method == "rmse":
        return np.sqrt(np.nanmean(diff**2, axis=axis))
    raise ValueError("'method' must be 'mse', 'rmse', or 'mae'")


def forecast_error(forecast, valid, method: str = "mse", axis=None):
    """Error of a forecast vs. verification (reference verify.py:17-51).

    If ``valid`` has the same rank as ``forecast`` it must carry the
    forecast-step first axis; otherwise ``valid`` is a continuous series and
    the lagged alignment valid[f:] vs forecast[f, :n-f] is applied.
    """
    forecast = np.asarray(forecast)
    valid = np.asarray(valid)
    if forecast.ndim == valid.ndim:
        if axis is None:
            axis = tuple(range(1, valid.ndim))
        return _err(valid - forecast, method, axis)
    n_f = forecast.shape[0]
    n_val = valid.shape[0]
    return np.array(
        [
            _err(valid[f:] - forecast[f, : n_val - f], method, axis)
            for f in range(n_f)
        ]
    )


def persistence_error(predictors, valid, n_fhour: int, method="mse", axis=None):
    """Persistence-forecast error (reference verify.py:54-77)."""
    predictors = np.asarray(predictors)
    valid = np.asarray(valid)
    n = valid.shape[0]
    return np.array(
        [
            _err(valid[f:] - predictors[: n - f], method, axis)
            for f in range(n_fhour)
        ]
    )


def climo_error(valid, n_fhour: int, method="mse", axis=None):
    """Constant-climatology error (reference verify.py:80-102)."""
    valid = np.asarray(valid)
    n = valid.shape[0]
    climo = np.nanmean(valid, axis=0)
    return np.array(
        [_err(valid[: n - f] - climo, method, axis) for f in range(n_fhour)]
    )


def monthly_climo_error(
    series,
    times,
    val_index,
    n_fhour: int | None = None,
    method: str = "mse",
    return_anomaly: bool = False,
):
    """Month-aware climatology error (reference verify.py:105-132).

    Args:
        series: (time, ...) array of the full state history.
        times: (time,) datetime64 coordinate of ``series``.
        val_index: indices (or boolean mask) of the validation subset.
        n_fhour: if given, tile the scalar error to this length.
    """
    series = np.asarray(series)
    times = np.asarray(times, dtype="datetime64[ns]")
    months = times.astype("datetime64[M]").astype(int) % 12
    climo = np.empty((12,) + series.shape[1:])
    for m in range(12):
        sel = months == m
        climo[m] = (
            np.nanmean(series[sel], axis=0) if sel.any() else np.nan
        )
    val_index = np.asarray(val_index)
    anomaly = series[val_index] - climo[months[val_index]]
    if method == "mse":
        me = float(np.nanmean(anomaly**2))
    elif method == "mae":
        me = float(np.nanmean(np.abs(anomaly)))
    elif method == "rmse":
        me = float(np.sqrt(np.nanmean(anomaly**2)))
    else:
        raise ValueError("'method' must be 'mse', 'rmse', or 'mae'")
    out = np.full(n_fhour, me) if n_fhour is not None else me
    return (out, anomaly) if return_anomaly else out


def anomaly_correlation(forecast, valid, climatology=None, axis=None):
    """Anomaly correlation coefficient per forecast step.

    ACC about ``climatology`` (defaults to the time mean of ``valid``):
    the verification-side companion of the training-time ACC loss
    (custom.py:994-1033), with forecast step as the first axis of both
    arrays.
    """
    forecast = np.asarray(forecast)
    valid = np.asarray(valid)
    climo = (
        np.nanmean(valid, axis=(0, 1), keepdims=True)
        if climatology is None
        else np.asarray(climatology)
    )
    fa = forecast - climo
    va = valid - climo
    if axis is None:
        axis = tuple(range(1, valid.ndim))
    num = np.nanmean(fa * va, axis=axis)
    den = np.sqrt(
        np.nanmean(fa**2, axis=axis) * np.nanmean(va**2, axis=axis)
    )
    return num / den


def predictors_to_time_series(
    predictors, time_steps: int, has_time_dim=True, use_first_step=False
):
    """Collapse a time_steps input/target block to a single-step series
    (reference verify.py:135-169)."""
    predictors = np.asarray(predictors)
    idx = 0 if use_first_step else -1
    if has_time_dim:
        return predictors[:, idx]
    sample_dim = predictors.shape[0]
    feature_shape = predictors.shape[1:]
    r = predictors.reshape(
        (sample_dim, time_steps, -1) + feature_shape[1:]
    )
    return r[:, idx]


def verification_from_series(
    data,
    forecast_steps: int = 1,
    dt_hours: int = 6,
    init_times=None,
    all_data=None,
    mask_discontinuous: bool = True,
):
    """Build the (f_hour, time, varlev, lat, lon) verification array
    (reference verify.py:238-273): entry [f, d] is the state at
    init_time[d] + (f+1)*dt, NaN where unavailable.

    Args:
        data: PredictorDataset (series format) holding the verification
            subset; its ``sample`` times define the forecast init times
            unless ``init_times`` is given.
        all_data: optional larger PredictorDataset to look up valid states
            beyond the subset (reference's all_ds).
        mask_discontinuous: all-NaN rows in the series mark continuity
            breaks (e.g. perturbed-restart segment boundaries in
            BarotropicArchiveSource archives). When True (default), a
            valid state separated from its init time by a marker row is
            masked NaN — otherwise forecasts initialized near a boundary
            are scored against the *restarted, unrelated* flow, and with
            K boundaries in the subset every lead-L error row absorbs
            ~K*(L - window) such pairs, each O(field variance).
            Continuous archives (no NaN rows) are unaffected.
    """
    if forecast_steps < 1:
        raise ValueError("'forecast_steps' must be an integer >= 1")
    src = all_data if all_data is not None else data
    series = np.asarray(src.predictors)
    times = np.asarray(src.sample, dtype="datetime64[ns]")
    lookup = {t: i for i, t in enumerate(times)}
    init = (
        np.asarray(init_times, dtype="datetime64[ns]")
        if init_times is not None
        else np.asarray(data.sample, dtype="datetime64[ns]")
    )
    dt = np.timedelta64(int(dt_hours), "h").astype("timedelta64[ns]")
    if mask_discontinuous:
        flat = series.reshape(series.shape[0], -1)
        marker = ~np.isfinite(flat).any(axis=1)
        # Segment id of each row = number of marker rows before it.
        seg = np.cumsum(marker) - marker.astype(int)
    out = np.full(
        (forecast_steps, len(init)) + series.shape[1:], np.nan, dtype=np.float32
    )
    for d, t0 in enumerate(init):
        i0 = lookup.get(t0) if mask_discontinuous else None
        for f in range(forecast_steps):
            i = lookup.get(t0 + (f + 1) * dt)
            if i is None:
                continue
            if (
                mask_discontinuous
                and i0 is not None
                and seg[i] != seg[i0]
            ):
                continue  # valid time lies past a continuity break
            out[f, d] = series[i]
    f_hour = np.arange(dt_hours, dt_hours * forecast_steps + 1, dt_hours)
    return out, f_hour


def verification_from_samples(data, forecast_steps=1, dt_hours=6, all_data=None):
    """Samples-format variant (reference verify.py:201-235): verification
    states come from targets' first time step, aligned to sample times."""
    src = all_data if all_data is not None else data
    targets = np.asarray(src.targets)[:, 0]
    # Target step 0 of sample at time t is valid at t + dt; index by that.
    times = np.asarray(src.sample, dtype="datetime64[ns]") + np.timedelta64(
        int(dt_hours), "h"
    ).astype("timedelta64[ns]")
    lookup = {t: i for i, t in enumerate(times)}
    init = np.asarray(data.sample, dtype="datetime64[ns]")
    dt = np.timedelta64(int(dt_hours), "h").astype("timedelta64[ns]")
    out = np.full(
        (forecast_steps, len(init)) + targets.shape[1:], np.nan, dtype=np.float32
    )
    for d, t0 in enumerate(init):
        for f in range(forecast_steps):
            i = lookup.get(t0 + (f + 1) * dt)
            if i is not None:
                out[f, d] = targets[i]
    f_hour = np.arange(dt_hours, dt_hours * forecast_steps + 1, dt_hours)
    return out, f_hour

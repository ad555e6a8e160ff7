"""The port's forecast verification vs dlwp_tpu, on the CPU.

``dlwp_torch.forecast.verify`` is the port's own copy of the JAX
package's numpy module: every function against it on the same arrays
(NaN rows, ``mask_discontinuous``, lagged and stepped forms), equal bit
for bit. Then the flow of ``examples/validate.py`` (validation split,
``TimeSeriesEstimator.predict``, ``verification_from_series``, forecast,
persistence, constant- and monthly-climatology RMSE rows) run the same
way on both packages with one flax tree, the port in float64: its rows
equal the JAX rows to 1e-10 relative.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlwp_tpu.data as jdata_mod
import dlwp_tpu.forecast as jforecast
import dlwp_tpu.models as jmodels
from dlwp_tpu.forecast import verify as jv

import dlwp_torch.data as tdata_mod
import dlwp_torch.forecast as tforecast
import dlwp_torch.models as tmodels
from dlwp_torch import flax_tree
from dlwp_torch.forecast import verify as tv

torch.set_num_threads(1)
TOL = 1e-10


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape)


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_module_has_every_function():
    names = {n for n in dir(jv) if not n.startswith("__")
             and callable(getattr(jv, n))} - {"annotations"}
    assert names <= set(dir(tv))


@pytest.mark.parametrize("method", ["mse", "mae", "rmse"])
def test_errors_match_jax(method):
    fc = rand(4, 10, 2, 3, 5)
    fc[1, 3] = np.nan
    series = rand(10, 2, 3, 5, seed=1)
    series[5, 0] = np.nan
    stepped = rand(4, 10, 2, 3, 5, seed=2)
    for axis in (None, (0, 2), (0, 1, 2, 3)):  # the lagged rows' lengths differ
        same(tv.forecast_error(fc, series, method, axis),
             jv.forecast_error(fc, series, method, axis))
        same(tv.persistence_error(series, series, 3, method, axis),
             jv.persistence_error(series, series, 3, method, axis))
        same(tv.climo_error(series, 4, method, axis),
             jv.climo_error(series, 4, method, axis))
    for axis in (None, (1, 2)):
        same(tv.forecast_error(fc, stepped, method, axis),
             jv.forecast_error(fc, stepped, method, axis))
    with pytest.raises(ValueError, match="method"):
        tv.forecast_error(fc, stepped, "bias")


@pytest.mark.parametrize("method", ["mse", "mae", "rmse"])
def test_monthly_climo_error_matches_jax(method):
    times = (np.datetime64("2007-01-01")
             + np.arange(50) * np.timedelta64(10, "D"))
    series = rand(50, 2, 3, 4, seed=3)
    series[7] = np.nan
    val = np.arange(30, 50)
    for kw in (dict(), dict(n_fhour=5), dict(return_anomaly=True)):
        got = tv.monthly_climo_error(series, times, val, method=method, **kw)
        want = jv.monthly_climo_error(series, times, val, method=method, **kw)
        if kw.get("return_anomaly"):
            same(got[0], want[0])
            same(got[1], want[1])
        else:
            same(got, want)
    with pytest.raises(ValueError, match="method"):
        tv.monthly_climo_error(series, times, val, method="bias")


def test_anomaly_correlation_and_time_series_match_jax():
    fc, valid = rand(3, 6, 2, 4, 5), rand(3, 6, 2, 4, 5, seed=1)
    valid[0, 2] = np.nan
    climo = rand(2, 4, 5, seed=2)
    for kw in (dict(), dict(climatology=climo), dict(axis=(1, 3, 4))):
        same(tv.anomaly_correlation(fc, valid, **kw),
             jv.anomaly_correlation(fc, valid, **kw))
    block = rand(7, 3, 2, 4, 5, seed=4)
    flat = block.reshape(7, 6, 4, 5)
    for first in (False, True):
        same(tv.predictors_to_time_series(block, 3, use_first_step=first),
             jv.predictors_to_time_series(block, 3, use_first_step=first))
        same(tv.predictors_to_time_series(flat, 3, has_time_dim=False,
                                          use_first_step=first),
             jv.predictors_to_time_series(flat, 3, has_time_dim=False,
                                          use_first_step=first))


def _series_data(n, markers=(), start="2007-01-01", step_h=6, seed=5):
    pred = rand(n, 2, 3, 4, seed=seed)
    pred[list(markers)] = np.nan
    return types.SimpleNamespace(
        predictors=pred,
        sample=np.datetime64(start) + np.arange(n) * np.timedelta64(step_h,
                                                                    "h"))


@pytest.mark.parametrize("mask", [True, False])
def test_verification_from_series_matches_jax(mask):
    """Marker rows split the series; init times off the grid and past its
    end; a larger all_data."""
    full = _series_data(40, markers=(9, 22))
    sub = types.SimpleNamespace(predictors=full.predictors[10:30],
                                sample=full.sample[10:30])
    init = np.concatenate([full.sample[[0, 5, 8, 20, 38]],
                           [np.datetime64("2006-12-31T03")]])
    for kw in (dict(data=full), dict(data=sub, all_data=full),
               dict(data=sub, init_times=init, all_data=full),
               dict(data=full, dt_hours=12)):
        got = tv.verification_from_series(forecast_steps=5,
                                          mask_discontinuous=mask, **kw)
        want = jv.verification_from_series(forecast_steps=5,
                                           mask_discontinuous=mask, **kw)
        same(got[0], want[0])
        same(got[1], want[1])
        assert got[0].dtype == want[0].dtype == np.float32
    with pytest.raises(ValueError, match="forecast_steps"):
        tv.verification_from_series(full, forecast_steps=0)


def test_verification_from_samples_matches_jax():
    n = 12
    data = types.SimpleNamespace(
        targets=rand(n, 2, 2, 3, 4, seed=6),
        sample=np.datetime64("2007-01-01") + np.arange(n)
        * np.timedelta64(6, "h"))
    sub = types.SimpleNamespace(targets=data.targets[4:], sample=data.sample[4:])
    for kw in (dict(data=data), dict(data=sub, all_data=data)):
        got = tv.verification_from_samples(forecast_steps=4, **kw)
        want = jv.verification_from_samples(forecast_steps=4, **kw)
        same(got[0], want[0])
        same(got[1], want[1])


# ------------------------------------------------- the validate.py flow
H, W = 8, 16
SPECS = [("CyclicConv2D", (8, 3), {"activation": "tanh"}),
         ("CyclicConv2D", (2, 3), {})]


def _validate_rows(pkg, data, dlwp, forecast_steps=4, lat_range=(-60, 60)):
    """examples/validate.py's scoring (lines 105-235) on the modules of
    ``pkg``: the last 10% held out, the model's forecast from every
    validation window (float64 batches), and the RMSE rows of the default
    variable."""
    verify, est_cls, sampler_cls = pkg
    n = data.predictors.shape[0]
    n_val = int(n * 0.1)
    val_data = data.isel_sample(np.arange(n - n_val, n))
    val_gen = sampler_cls(val_data, model=dlwp, input_time_steps=1,
                          output_time_steps=1, batch_size=64,
                          dtype=np.float64)
    estimator = est_cls(dlwp, val_gen)
    forecast = estimator.predict(forecast_steps // estimator._out_ts)
    dt_hours = estimator._dt_hours
    steps_out = forecast.values.shape[0]
    ver, f_hour = verify.verification_from_series(
        val_data, forecast_steps=steps_out, dt_hours=int(dt_hours),
        init_times=forecast.times, all_data=data)
    out_idx = val_data.varlev_index(forecast.varlev)
    ver = ver[:, :, out_idx]
    lo, hi = lat_range
    lat_sel = np.where((np.asarray(data.lat) >= lo)
                       & (np.asarray(data.lat) <= hi))[0]
    fc_v = forecast.values[:, :, 0][..., lat_sel, :]
    ver_v = ver[:, :, 0][..., lat_sel, :]
    axis = tuple(range(1, ver_v.ndim))
    rows = {"f_hour": f_hour, "forecast": verify.forecast_error(
        fc_v, ver_v, method="rmse", axis=axis)}
    init_idx = [int(np.where(np.asarray(val_data.sample) == t)[0][0])
                for t in forecast.times]
    init = np.asarray(val_data.predictors)[init_idx][:, out_idx][:, 0]
    rows["persistence"] = verify.forecast_error(
        np.repeat(init[..., lat_sel, :][None], steps_out, axis=0), ver_v,
        method="rmse", axis=axis)
    series = np.asarray(val_data.predictors)[:, out_idx][:, 0][..., lat_sel, :]
    rows["climatology"] = verify.forecast_error(
        np.broadcast_to(np.nanmean(series, axis=0),
                        (steps_out,) + ver_v.shape[1:]),
        ver_v, method="rmse", axis=axis)
    times = np.asarray(data.sample, dtype="datetime64[ns]")
    full = np.asarray(data.predictors)[:, out_idx][:, 0][..., lat_sel, :]
    months = times.astype("datetime64[M]").astype(int) % 12
    climo12 = np.stack([np.nanmean(full[months == m], axis=0)
                        for m in range(12)])
    lead = ((np.arange(steps_out) + 1)
            * int(round(dt_hours * 60))).astype("timedelta64[m]")
    ver_months = (np.asarray(forecast.times, dtype="datetime64[ns]")[None]
                  + lead[:, None]).astype("datetime64[M]").astype(int) % 12
    rows["monthly_climo"] = verify.forecast_error(
        climo12[ver_months], ver_v, method="rmse", axis=axis)
    return rows


def test_validate_flow_matches_jax():
    """A year of daily states (so the monthly row applies), a marker row
    inside the validation window, the model's flax tree on both sides."""
    n = 400
    pred = rand(n, 2, H, W, seed=7)
    pred[n - 20] = np.nan
    kw = dict(predictors=pred,
              sample=np.datetime64("2007-01-01")
              + np.arange(n) * np.timedelta64(24, "h"),
              varlev=["HGT/500", "THICK/300-700"],
              lat=np.linspace(80.0, -80.0, H), lon=np.arange(W) * 22.5)
    net = tmodels.DLWPNeuralNet(time_dim=1, scaler_type=None, device="cpu")
    net.build_model(SPECS)
    net.init(np.zeros((1, 2, H, W)), seed=0)
    tree = flax_tree(net.base_model)
    net.load_flax_params(tree, dtype=torch.float64)
    jnet = jmodels.DLWPNeuralNet(time_dim=1, scaler_type=None)
    jnet.build_model(SPECS)
    jnet.trainer.params = jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64), tree)
    got = _validate_rows((tv, tforecast.TimeSeriesEstimator,
                          tdata_mod.SeriesSampler),
                         tdata_mod.PredictorDataset(**kw), net)
    want = _validate_rows((jv, jforecast.TimeSeriesEstimator,
                           jdata_mod.SeriesSampler),
                          jdata_mod.PredictorDataset(**kw), jnet)
    assert got.keys() == want.keys()
    same(got["f_hour"], want["f_hour"])
    for k in ("forecast", "persistence", "climatology", "monthly_climo"):
        assert np.isfinite(got[k]).all() and got[k].shape == (4,)
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=0,
                                   err_msg=k)

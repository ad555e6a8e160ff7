"""The port's in-memory ``Preprocessor`` and ``BarotropicArchiveSource``
against the JAX package's on the CPU, and a tiny paper run (archive ->
``Preprocessor`` -> ``SeriesSampler`` -> ``fit`` -> forecast -> the RMSE
rows of ``examples/validate.py`` with the barotropic baseline) on both.

Limits:

- ``streaming_mean_std`` and the scaled series: 1e-12 relative (the same
  float64 numpy arithmetic in the same batch order; in practice equal).
- The archive: both packages integrate it in float32 (the JAX archive is
  float32 under x64 too), so the marker rows are bit-equal and the fields
  agree within 5e-5 x the anomaly scale over these few-day segments (the
  first runs gave at most 5.4e-6): fp32 sums in another order, grown by
  the dynamics. Long archives are chaotic and are compared on the card by
  their statistics, not here.
- The paper run from one series and one flax tree, the model in float64:
  the forecast, persistence and climatology rows to 1e-9 relative; the
  float32 barotropic baseline to 1e-4 relative.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_tpu.data import BarotropicArchiveSource as JArchive
from dlwp_tpu.data import Preprocessor as JPreprocessor
from dlwp_tpu.data import SeriesSampler as JSeriesSampler
from dlwp_tpu.data.preprocessing import _varlev_names as j_varlev_names
from dlwp_tpu.data.preprocessing import streaming_mean_std as j_stats
from dlwp_tpu.forecast import TimeSeriesEstimator as JEstimator
from dlwp_tpu.forecast import verify as jverify
from dlwp_tpu.models import DLWPNeuralNet as JNet
from dlwp_tpu.ops.losses import latitude_weighted_loss as j_lat_loss
from dlwp_tpu.ops.losses import mse as j_mse

from dlwp_torch import DLWPNeuralNet, SeriesSampler, TimeSeriesEstimator
from dlwp_torch import flax_tree
from dlwp_torch.data import BarotropicArchiveSource, Preprocessor
from dlwp_torch.data import streaming_mean_std
from dlwp_torch.data.preprocessing import _varlev_names
from dlwp_torch.forecast import verify as tverify
from dlwp_torch.ops.losses import latitude_weighted_loss, mse

from tests.torch_port_threads import one_blas_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  the port's barotropic baseline

torch.set_num_threads(2)
TOL_STATS = 1e-12
TOL_ARCHIVE = 5e-5
TOL_ROWS = 1e-9
TOL_BASELINE = 1e-4


class _Source:
    """An in-memory DataSource with NaN rows."""

    def __init__(self, n=23, nlat=5, nlon=8, seed=0):
        rs = np.random.RandomState(seed)
        self.times = (np.datetime64("2001-01-01")
                      + np.arange(n) * np.timedelta64(6, "h"))
        self.lat = np.linspace(60.0, -60.0, nlat)
        self.lon = np.arange(nlon) * 45.0
        self._f = {(v, lev): 50.0 * rs.randn(n, nlat, nlon) + 5000.0 * (i + 1)
                   for i, (v, lev) in enumerate(
                       [("HGT", 500), ("HGT", 700), ("VRT", 500),
                        ("VRT", 700), ("T2", None)])}
        self._f["HGT", 500][[4, 11]] = np.nan

    def field(self, variable, level):
        return self._f[variable, level]


def test_streaming_mean_std_matches_jax():
    x = _Source().field("HGT", 500)
    for batch in (1, 4, 7, 1000):
        got = streaming_mean_std(lambda a, b: x[a:b], len(x), batch)
        want = j_stats(lambda a, b: x[a:b], len(x), batch)
        np.testing.assert_allclose(got, want, rtol=TOL_STATS, atol=0)


def test_varlev_names_match_jax():
    for args in ((["HGT", "VRT"], [500, 700], False),
                 (["HGT", "VRT"], [500, 700], True),
                 (["T2"], [None], True), (["T2", "HGT"], [0, 500], True)):
        assert _varlev_names(*args) == j_varlev_names(*args)
    with pytest.raises(ValueError, match="pairwise"):
        _varlev_names(["HGT"], [500, 700], True)


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("pairwise", [True, False])
def test_data_to_series_and_samples_match_jax(pairwise, scale):
    src = _Source()
    variables, levels = (["HGT", "VRT"], [500, 700])
    kw = dict(pairwise=pairwise, scale_variables=scale, batch_samples=5)
    got = Preprocessor(src).data_to_series(variables, levels, **kw)
    want = JPreprocessor(src).data_to_series(variables, levels, **kw)
    assert got.varlev == want.varlev and got.attrs == want.attrs
    np.testing.assert_array_equal(got.sample, want.sample)
    np.testing.assert_allclose(got.mean, want.mean, rtol=TOL_STATS)
    np.testing.assert_allclose(got.std, want.std, rtol=TOL_STATS)
    np.testing.assert_allclose(got.predictors, np.asarray(want.predictors),
                               rtol=TOL_STATS, atol=0)
    assert got.predictors.dtype == np.float32
    got = Preprocessor(src).data_to_samples(variables, levels, time_steps=2,
                                            **kw)
    want = JPreprocessor(src).data_to_samples(variables, levels,
                                              time_steps=2, **kw)
    for name in ("predictors", "targets"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name)),
                                   rtol=TOL_STATS, atol=0)
    np.testing.assert_array_equal(got.sample, want.sample)
    assert got.attrs == want.attrs


def test_file_output_raises_naming_item_5(tmp_path):
    """The flow that raised before predictor files were ported now writes
    them: ``output_file=`` streams the series and the samples into HDF5
    files equal to the JAX package's (the same float64 arithmetic, then
    float32: bit-equal), and ``to_file`` writes the current data. Still
    refused: ``to_file`` before any data, and too many time steps."""
    import h5py

    pp, jpp = Preprocessor(_Source()), JPreprocessor(_Source())
    with pytest.raises(RuntimeError):
        pp.to_file(str(tmp_path / "x.h5"))
    kw = dict(batch_samples=5)
    for method, extra in (("data_to_series", {}),
                          ("data_to_samples", {"time_steps": 2})):
        got = getattr(pp, method)(["HGT"], [500], output_file=str(
            tmp_path / f"{method}.h5"), **extra, **kw)
        want = getattr(jpp, method)(["HGT"], [500], output_file=str(
            tmp_path / f"j_{method}.h5"), **extra, **kw)
        for name in ("predictors", "targets"):
            if getattr(want, name) is not None:
                np.testing.assert_array_equal(getattr(got, name)[:],
                                              getattr(want, name)[:])
        pp.to_file(str(tmp_path / f"{method}_again.h5"))
        jpp.to_file(str(tmp_path / f"j_{method}_again.h5"))
        got.close()
        want.close()
        for a, b in ((f"{method}_again.h5", f"j_{method}_again.h5"),
                     (f"{method}.h5", f"j_{method}.h5")):
            with h5py.File(tmp_path / a) as fa, h5py.File(tmp_path / b) as fb:
                assert sorted(fa) == sorted(fb)
                assert dict(fa.attrs) == dict(fb.attrs)
                for k in fa:
                    assert fa[k].dtype == fb[k].dtype, k
                    np.testing.assert_array_equal(fa[k][:], fb[k][:])
    with pytest.raises(ValueError, match="time_steps"):
        pp.data_to_samples(["HGT"], [500], time_steps=12)


# ------------------------------------------------------------ the archive
ARCHIVE = dict(n_samples=27, nlat=17, nlon=32, truncation=10, segment_days=3,
               spinup_days=0.5, damping_coefficient=2e-4, seed=3)
ARCHIVE_CASES = {
    "vrt": dict(form="vrt"),
    "psi": dict(form="psi"),
    "two_truth": dict(truth_truncation=14, truth_nlat=25, truth_nlon=48),
    "relax_drag": dict(zonal_relaxation_days=10.0, relax_n=6,
                       wave_drag_days=5.0, wave_drag_n_min=6),
}


@pytest.mark.parametrize("case", sorted(ARCHIVE_CASES))
def test_archive_matches_jax(case):
    kw = dict(ARCHIVE, **ARCHIVE_CASES[case])
    want_src = JArchive(**kw)
    got_src = BarotropicArchiveSource(device="cpu", **kw)
    assert got_src.n_segments == want_src.n_segments == 3
    np.testing.assert_array_equal(got_src.times, want_src.times)
    for var in ("HGT", "VRT"):
        got, want = got_src.field(var, 500), want_src.field(var, 500)
        assert got.shape == want.shape == (27, 17, 32)
        assert got.dtype == want.dtype == np.float32
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert nan.all(axis=(1, 2)).nonzero()[0].tolist() == [12, 25]
        anomaly = np.abs(want[~nan] - np.mean(want[~nan])).max()
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=0,
                                   atol=TOL_ARCHIVE * anomaly)
    with pytest.raises(KeyError, match="HGT/VRT"):
        got_src.field("T2", 2)


def test_archive_refusals():
    with pytest.raises(ValueError, match="step_impl='plain'"):
        BarotropicArchiveSource(device="cpu", step_impl="kernel",
                                wave_drag_days=5.0, **ARCHIVE).field("HGT", 500)
    with pytest.raises(ValueError, match="exceed"):
        BarotropicArchiveSource(device="cpu", truth_truncation=8, **ARCHIVE)
    with pytest.raises(ValueError, match="cannot support"):
        BarotropicArchiveSource(device="cpu", truth_truncation=20,
                                truth_nlat=19, **ARCHIVE)
    with pytest.raises(ValueError, match="form"):
        BarotropicArchiveSource(device="cpu", form="div")


# ------------------------------------------------------- the paper run
H, W, TD, C = 16, 32, 2, 2
PAPER_ARCHIVE = dict(n_samples=88, nlat=17, nlon=32, truncation=10,
                     truth_truncation=14, truth_nlat=25, truth_nlon=48,
                     segment_days=5, spinup_days=0.5,
                     damping_coefficient=2e-4, seed=1)


def paper_specs(lstm_features=4):
    """``examples/train_convlstm.py``'s ``convlstm_tower`` at narrow
    widths."""
    return [
        ("ConvLSTM2D", (lstm_features, 3),
         {"dilation": 2, "activation": "tanh", "return_sequences": True}),
        ("Reshape", ((TD * lstm_features, H, W),), None),
        ("CyclicConv2D", (6, 3), {"dilation": 2, "activation": "tanh"}),
        ("MaxPooling2D", (2,), None),
        ("CyclicConv2D", (8, 3), {"activation": "tanh"}),
        ("UpSampling2D", (2,), None),
        ("CyclicConv2D", (6, 3), {"dilation": 2, "activation": "tanh"}),
        ("CyclicConv2D", (TD * C, 5), {"activation": "linear"}),
        ("Reshape", ((TD, C, H, W),), None),
    ]


@pytest.fixture(scope="module")
def paper_series():
    """The JAX archive's series through both Preprocessors, pole-cropped
    as train_convlstm.py crops it."""
    src = JArchive(**PAPER_ARCHIVE)
    args = (["HGT", "VRT"], [500, 500])
    got = Preprocessor(src).data_to_series(*args, pairwise=True)
    want = JPreprocessor(src).data_to_series(*args, pairwise=True)
    np.testing.assert_allclose(got.predictors, np.asarray(want.predictors),
                               rtol=TOL_STATS, atol=0)
    for ds in (got, want):
        ds.predictors = np.asarray(ds.predictors)[..., 1:, :]
        ds.lat = ds.lat[1:]
    return got, want


def _paper_rows(pkg, data, net, device):
    """The flow of examples/validate.py on ``pkg`` (the last 25% held out,
    4 model steps, HGT/500 over 20-70N, the vrt-form baseline)."""
    verify, est_cls, sampler_cls = pkg
    n = data.predictors.shape[0]
    val_data = data.isel_sample(np.arange(n - int(n * 0.25), n))
    val_gen = sampler_cls(val_data, model=net, input_time_steps=TD,
                          output_time_steps=TD, batch_size=64,
                          add_insolation=True, dtype=np.float64)
    est = est_cls(net, val_gen)
    forecast = est.predict(4)
    steps_out = forecast.values.shape[0]
    ver, f_hour = verify.verification_from_series(
        val_data, forecast_steps=steps_out, dt_hours=int(est._dt_hours),
        init_times=forecast.times, all_data=data)
    out_idx = val_data.varlev_index(forecast.varlev)
    ver = ver[:, :, out_idx]
    lat = np.asarray(data.lat)
    lat_sel = np.where((lat >= 20.0) & (lat <= 70.0))[0]
    fc_v = forecast.values[:, :, 0][..., lat_sel, :]
    ver_v = ver[:, :, 0][..., lat_sel, :]
    axis = tuple(range(1, ver_v.ndim))
    rows = {"forecast": verify.forecast_error(fc_v, ver_v, "rmse", axis)}
    init_idx = [int(np.where(np.asarray(val_data.sample) == t)[0][0])
                for t in forecast.times]
    init = np.asarray(val_data.predictors)[init_idx][:, out_idx][:, 0]
    rows["persistence"] = verify.forecast_error(
        np.repeat(init[..., lat_sel, :][None], steps_out, axis=0), ver_v,
        "rmse", axis)
    series = np.asarray(val_data.predictors)[:, out_idx][:, 0][..., lat_sel, :]
    rows["climatology"] = verify.forecast_error(
        np.broadcast_to(np.nanmean(series, axis=0),
                        (steps_out,) + ver_v.shape[1:]), ver_v, "rmse", axis)
    baseline_args = (data, val_data, forecast, ver, 0, est._dt_hours,
                     steps_out, lat_sel)
    if device is None:
        rows["barotropic"] = _jax_baseline()(*baseline_args, form="vrt")
    else:
        rows["barotropic"] = chip_smoke.barotropic_baseline(
            *baseline_args, form="vrt", device=device)
    # Validation pairs that span a restart are masked: NaN verification.
    rows["masked_pairs"] = np.isnan(ver).all(axis=(2, 3, 4))
    return f_hour, rows


def _jax_baseline():
    path = os.path.join(ROOT, "examples", "validate.py")
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec = importlib.util.spec_from_file_location("_validate_example",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.dirname(path))
    return mod._barotropic_baseline


def test_tiny_paper_run_matches_jax(paper_series):
    """Two-truth archive -> series -> 2 epochs of sequence-2 training
    (latitude-weighted MSE, adam, insolation splice) from one flax tree on
    both packages -> the forecast and its RMSE rows with the baseline."""
    data, jdata = paper_series
    n = data.predictors.shape[0]
    train_idx = np.arange(n - int(n * 0.25))

    def splice_t(inp, pred, k):
        return torch.cat([pred, inp[:, :, C:]], dim=2)

    def splice_j(inp, pred, k):
        return jnp.concatenate([pred, inp[:, :, C:]], axis=2)

    net = DLWPNeuralNet(is_recurrent=True, time_dim=TD, scaler_type=None,
                        device="cpu")
    net.build_model(paper_specs(), loss=latitude_weighted_loss(mse, data.lat),
                    optimizer="adam", learning_rate=2e-3, sequence_steps=2,
                    splice_fn=splice_t, seed=0)
    train = SeriesSampler(data.isel_sample(train_idx), model=net,
                          input_time_steps=TD, output_time_steps=TD,
                          sequence=2, add_insolation=True, batch_size=8,
                          shuffle=True, seed=0, dtype=np.float64)
    net.init(train[0][0][:1], seed=0)
    tree = flax_tree(net.base_model)
    net.load_flax_params(tree, dtype=torch.float64)
    jnet = JNet(is_recurrent=True, time_dim=TD, scaler_type=None)
    jnet.build_model(paper_specs(), loss=j_lat_loss(j_mse, jdata.lat),
                     optimizer="adam", learning_rate=2e-3, sequence_steps=2,
                     splice_fn=splice_j, seed=0)
    jtrain = JSeriesSampler(jdata.isel_sample(train_idx), model=jnet,
                            input_time_steps=TD, output_time_steps=TD,
                            sequence=2, add_insolation=True, batch_size=8,
                            shuffle=True, seed=0, dtype=np.float64)
    jnet.trainer.params = jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64), tree)
    jnet.trainer.opt_state = jnet.trainer.tx.init(jnet.trainer.params)
    got_h = net.fit_generator(train, epochs=2, verbose=False)
    want_h = jnet.fit_generator(jtrain, epochs=2, verbose=False)
    np.testing.assert_allclose(got_h.history["loss"], want_h.history["loss"],
                               rtol=TOL_ROWS)
    f_hour, got = _paper_rows((tverify, TimeSeriesEstimator, SeriesSampler),
                              data, net, "cpu")
    jf_hour, want = _paper_rows((jverify, JEstimator, JSeriesSampler), jdata,
                                jnet, None)
    np.testing.assert_array_equal(f_hour, jf_hour)
    np.testing.assert_array_equal(got["masked_pairs"], want["masked_pairs"])
    assert got["masked_pairs"].any()  # the held-out tail spans a restart
    for k in ("forecast", "persistence", "climatology"):
        assert np.isfinite(got[k]).all() and got[k].shape == (8,)
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_ROWS, err_msg=k)
    np.testing.assert_allclose(got["barotropic"], want["barotropic"],
                               rtol=TOL_BASELINE)
    assert np.isfinite(got["barotropic"]).all()

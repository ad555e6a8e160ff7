"""Predictor files in the port (``dlwp_torch.data.dataset``,
``Preprocessor(output_file=...)``, the lazy samplers) against the JAX
package's, on the CPU.

Limits:

- Files: bit-equal both ways. A file is a copy of arrays, so what one
  package writes the other reads back exactly, in both load modes, and
  the two writers lay out the same datasets, dtypes, chunks and attrs.
- Streaming ``Preprocessor`` output: the statistics 1e-12 relative (the
  same float64 numpy arithmetic in the same batch order); the scaled
  arrays bit-equal (both round the same float64 values to float32).
- ``inverse_scale``: 1e-12 relative (float64 arithmetic).
- Samplers over a lazy file: bit-equal batches in the JAX sampler's order
  (a gather is a copy; the shuffle is the same ``RandomState``).
"""

import dataclasses
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

import dlwp_tpu.data.dataset as jdataset
from dlwp_tpu.data import PredictorDataset as JDataset
from dlwp_tpu.data import Preprocessor as JPreprocessor
from dlwp_tpu.data import SamplesSampler as JSamplesSampler
from dlwp_tpu.data import SeriesSampler as JSeriesSampler

import dlwp_torch.data.dataset as tdataset
from dlwp_torch.data import (
    PredictorDataset,
    Preprocessor,
    SamplesSampler,
    SeriesSampler,
)
from dlwp_torch.data import sampler as tsampler

from tests.torch_port_threads import one_blas_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_STATS = 1e-12


class _Source:
    """An in-memory DataSource: two levels of two variables and a level-less
    one, with NaN marker rows in HGT/500."""

    def __init__(self, n=23, nlat=5, nlon=8, seed=0, nan_rows=(4, 11)):
        rs = np.random.RandomState(seed)
        self.times = (np.datetime64("2001-01-01")
                      + np.arange(n) * np.timedelta64(6, "h"))
        self.lat = np.linspace(60.0, -60.0, nlat)
        self.lon = np.arange(nlon) * (360.0 / nlon)
        self._f = {(v, lev): 50.0 * rs.randn(n, nlat, nlon) + 5000.0 * (i + 1)
                   for i, (v, lev) in enumerate(
                       [("HGT", 500), ("HGT", 700), ("VRT", 500),
                        ("VRT", 700), ("T2", None)])}
        self._f["HGT", 500][list(nan_rows)] = np.nan

    def field(self, variable, level):
        return self._f[variable, level]


def _fields(fmt, seed=0):
    """The same dataset's fields for both packages: a series, or samples
    with targets and a time step axis."""
    rs = np.random.RandomState(seed)
    n, shape = 9, (3, 4, 6)
    if fmt == "samples":
        shape = (2,) + shape
    pred = rs.randn(n, *shape).astype(np.float32)
    return dict(
        predictors=pred,
        targets=rs.randn(*pred.shape).astype(np.float32)
        if fmt == "samples" else None,
        sample=(np.datetime64("2003-02-01T06")
                + np.arange(n) * np.timedelta64(6, "h")).astype(
                    "datetime64[ns]"),
        varlev=["HGT/500", "THICK/300-700", "T2"],
        lat=np.linspace(80.0, -80.0, 4), lon=np.arange(6) * 60.0,
        mean=rs.randn(3), std=rs.rand(3) + 0.5,
        attrs={"scaling": "True", "format": fmt})


def _assert_same(got, want):
    for name in ("predictors", "targets"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got.sample.dtype == want.sample.dtype == np.dtype("datetime64[ns]")
    np.testing.assert_array_equal(got.sample, want.sample)
    assert got.varlev == want.varlev
    for name in ("lat", "lon", "mean", "std"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.attrs == want.attrs


def _layout(path):
    with h5py.File(path, "r") as f:
        return ({k: (f[k].dtype, f[k].shape, f[k].chunks) for k in f},
                dict(f.attrs))


@pytest.mark.parametrize("fmt", ["series", "samples"])
@pytest.mark.parametrize("load", ["full", "lazy"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_round_trip_with_jax(tmp_path, writer, load, fmt):
    """What one package writes the other reads back bit for bit; a lazy
    read keeps h5py datasets and its file until ``close``."""
    fields = _fields(fmt)
    port, jax_ds = PredictorDataset(**fields), JDataset(**fields)
    path = str(tmp_path / "p.h5")
    (port if writer == "port" else jax_ds).to_file(path)
    reader = JDataset if writer == "port" else PredictorDataset
    got = reader.from_file(path, load=load)
    _assert_same(got, port)
    if load == "lazy":
        assert isinstance(got.predictors, h5py.Dataset)
        assert got._file is not None
        got.close()
        assert got._file is None
    else:
        assert isinstance(got.predictors, np.ndarray) and got._file is None
    # ... and back again through the writer's own reader.
    again = (PredictorDataset if writer == "port" else JDataset).from_file(
        path, load=load)
    _assert_same(again, port)
    again.close()


@pytest.mark.parametrize("fmt", ["series", "samples"])
def test_file_layout_equals_jax(tmp_path, fmt):
    fields = _fields(fmt)
    PredictorDataset(**fields).to_file(str(tmp_path / "port.h5"))
    JDataset(**fields).to_file(str(tmp_path / "jax.h5"))
    got, want = _layout(tmp_path / "port.h5"), _layout(tmp_path / "jax.h5")
    assert got == want
    assert got[0]["predictors"][2] == (1,) + fields["predictors"].shape[1:]
    assert got[0]["sample"][0] == np.int64 and got[0]["varlev"][0].kind == "S"


@pytest.mark.parametrize("fmt", ["series", "samples"])
def test_dims_inverse_scale_load_close_and_subsets(tmp_path, fmt):
    fields = _fields(fmt)
    port, jax_ds = PredictorDataset(**fields), JDataset(**fields)
    assert port.dims == jax_ds.dims
    x = np.random.RandomState(2).randn(5, 3, 4, 6)
    np.testing.assert_allclose(port.inverse_scale(x),
                               jax_ds.inverse_scale(x), rtol=TOL_STATS)
    unscaled = dataclasses.replace(port, mean=None, std=None)
    assert unscaled.inverse_scale(x) is x
    path = str(tmp_path / "p.h5")
    port.to_file(path)
    lazy = PredictorDataset.from_file(path, load="lazy")
    handle = lazy._file
    for sub in (lazy.isel_sample(np.arange(2, 6)),
                lazy.sel(["T2", "HGT/500"])):
        assert sub._file is None and isinstance(sub.predictors, np.ndarray)
    want_sub = jax_ds.sel(["T2", "HGT/500"])
    _assert_same(lazy.sel(["T2", "HGT/500"]), want_sub)
    _assert_same(lazy.isel_sample(np.arange(2, 6)),
                 jax_ds.isel_sample(np.arange(2, 6)))
    assert lazy.load() is lazy and isinstance(lazy.predictors, np.ndarray)
    _assert_same(lazy, port)
    lazy.close()
    assert lazy._file is None and not handle.id.valid
    lazy.close()  # closing twice is a no-op


@pytest.mark.parametrize("method", ["to_netcdf", "to_zarr"])
def test_netcdf_and_zarr_raise_as_jax(tmp_path, method):
    fields = _fields("series")
    outcomes = []
    for ds in (PredictorDataset(**fields), JDataset(**fields)):
        try:
            getattr(ds, method)(str(tmp_path / f"{type(ds).__module__}.out"))
            outcomes.append(None)
        except RuntimeError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_without_h5py_file_io_raises_as_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(tdataset, "h5py", None)
    monkeypatch.setattr(jdataset, "h5py", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    fields, path = _fields("series"), str(tmp_path / "p.h5")
    messages = []
    for call in (lambda: PredictorDataset(**fields).to_file(path),
                 lambda: JDataset(**fields).to_file(path),
                 lambda: PredictorDataset.from_file(path),
                 lambda: JDataset.from_file(path),
                 lambda: Preprocessor(_Source()).data_to_series(
                     ["HGT"], [500], output_file=path)):
        with pytest.raises(RuntimeError, match="h5py") as e:
            call()
        messages.append(str(e.value))
    assert len(set(messages)) == 1
    assert not os.path.exists(path)


@pytest.mark.parametrize("batch_samples", [4, 1000])
@pytest.mark.parametrize("scale", [True, False])
def test_streaming_preprocessor_matches_jax(tmp_path, scale, batch_samples):
    """``output_file=`` for both output modes: the port's files hold what
    the JAX package's hold, laid out alike, read back lazily; the port's
    streamed series equals its in-memory one; the samples mode keeps its
    ``.series`` intermediate."""
    kw = dict(pairwise=False, scale_variables=scale,
              batch_samples=batch_samples)
    variables, levels = ["HGT", "VRT"], [500, 700]
    for method, extra in (("data_to_series", {}),
                          ("data_to_samples", {"time_steps": 2})):
        out, jout = str(tmp_path / f"{method}.h5"), str(tmp_path / "j.h5")
        got = getattr(Preprocessor(_Source()), method)(
            variables, levels, output_file=out, **extra, **kw)
        want = getattr(JPreprocessor(_Source()), method)(
            variables, levels, output_file=jout, **extra, **kw)
        assert isinstance(got.predictors, h5py.Dataset)
        np.testing.assert_allclose(got.mean, want.mean, rtol=TOL_STATS)
        np.testing.assert_allclose(got.std, want.std, rtol=TOL_STATS)
        _assert_same(got, want)
        got.close()
        want.close()
        assert _layout(out) == _layout(jout)
        if method == "data_to_samples":
            assert _layout(out + ".series") == _layout(jout + ".series")
        memory = getattr(Preprocessor(_Source()), method)(
            variables, levels, **extra, **kw)
        from_file = PredictorDataset.from_file(out)
        _assert_same(from_file, memory)


def test_streaming_samples_too_short_removes_its_series(tmp_path):
    out = str(tmp_path / "s.h5")
    with pytest.raises(ValueError, match="time_steps"):
        Preprocessor(_Source()).data_to_samples(["HGT"], [500], time_steps=12,
                                                output_file=out)
    assert not os.path.exists(out + ".series") and not os.path.exists(out)


def _lazy_pair(tmp_path, source, variables, levels):
    """The same streamed series, read lazily by each package."""
    kw = dict(pairwise=True, batch_samples=1000)
    got = Preprocessor(source).data_to_series(
        variables, levels, output_file=str(tmp_path / "p.h5"), **kw)
    want = JPreprocessor(source).data_to_series(
        variables, levels, output_file=str(tmp_path / "j.h5"), **kw)
    return got, want


SAMPLER_CASES = {
    # kwargs, NaN rows of HGT/500
    "shuffled": (dict(input_time_steps=2, output_time_steps=2,
                      add_insolation=True, batch_size=64), (7, 4100)),
    "sequence_interval": (dict(input_time_steps=1, output_time_steps=2,
                               sequence=2, interval=3, batch_size=50),
                          (0, 4095, 4096)),
    # the NaN sits in a channel the windows do not select
    "unselected_nan": (dict(input_sel=["VRT/500"], output_sel=["VRT/500"],
                            input_time_steps=2, output_time_steps=1,
                            batch_size=100), (5, 4097)),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_lazy_series_sampler_matches_jax(tmp_path, case):
    """A series longer than one NaN-scan chunk (4500 rows on a 2x4 grid),
    read lazily: the port's shuffled sampler (seed 0) keeps the h5py
    dataset, drops the windows JAX's drops, and yields JAX's lazy
    sampler's batches in its order over two epochs; the lazy read is
    bit-equal to the in-memory sampler's batches."""
    kw, nan_rows = SAMPLER_CASES[case]
    source = _Source(n=4500, nlat=2, nlon=4, nan_rows=nan_rows)
    got, want = _lazy_pair(tmp_path, source, ["HGT", "VRT"], [500, 500])
    assert tsampler.NAN_SCAN_ROWS < got.predictors.shape[0]
    kw = dict(kw, shuffle=True, seed=0)
    port = SeriesSampler(got, **kw)
    jax_s = JSeriesSampler(want, **kw)
    memory = SeriesSampler(dataclasses.replace(got).load(), **kw)
    assert isinstance(port._series, h5py.Dataset)
    np.testing.assert_array_equal(port._valid, jax_s._valid)
    if case == "unselected_nan":
        assert port._valid is None
    else:
        assert port._valid is not None
        assert len(port._valid) < port._n_sample
    assert len(port) == len(jax_s) == len(memory)
    for _ in range(2):  # each list() runs an epoch to its reshuffle
        for (x, y), (jx, jy), (mx, my) in zip(list(port), list(jax_s),
                                              list(memory)):
            np.testing.assert_array_equal(x, np.asarray(jx))
            np.testing.assert_array_equal(y, np.asarray(jy))
            np.testing.assert_array_equal(x, mx)
            np.testing.assert_array_equal(y, my)
    got.close()
    want.close()


def test_lazy_gather_reads_sorted_unique_rows(tmp_path):
    """The lazy route asks h5py for sorted unique rows (it refuses any
    other index) and restores an unsorted batch with duplicates."""
    got, want = _lazy_pair(tmp_path, _Source(n=40, nan_rows=()), ["HGT"],
                           [500])
    reads = []

    class Spy:
        shape = got.predictors.shape

        def __getitem__(self, idx):
            reads.append(np.asarray(idx))
            return got.predictors[idx]

    sampler = SeriesSampler(got, input_time_steps=2, output_time_steps=1,
                            is_recurrent=True)
    sampler._series = Spy()
    samples = np.array([9, 3, 9, 0, 17])
    x, y = sampler.generate(samples)
    series = np.asarray(got.predictors)
    np.testing.assert_array_equal(x[:, 1], series[samples + 1])
    np.testing.assert_array_equal(y[:, 0], series[samples + 2])
    assert len(reads) == 3
    for idx in reads:
        assert (np.diff(idx) > 0).all()
    got.close()
    want.close()


def test_lazy_samples_sampler_matches_jax(tmp_path):
    kw = dict(batch_size=4, shuffle=True, seed=0)
    got = Preprocessor(_Source()).data_to_samples(
        ["HGT", "VRT"], [500, 700], time_steps=2,
        output_file=str(tmp_path / "p.h5"))
    want = JPreprocessor(_Source()).data_to_samples(
        ["HGT", "VRT"], [500, 700], time_steps=2,
        output_file=str(tmp_path / "j.h5"))
    assert isinstance(got.targets, h5py.Dataset)
    for recurrent in (False, True):
        port = SamplesSampler(got, is_recurrent=recurrent, **kw)
        jax_s = JSamplesSampler(want, is_recurrent=recurrent, **kw)
        assert len(port) == len(jax_s)
        for (x, y), (jx, jy) in zip(list(port), list(jax_s)):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    # A samples-format file in the series sampler takes its last input step.
    series = SeriesSampler(got, input_time_steps=2, output_time_steps=1)
    jseries = JSeriesSampler(want, input_time_steps=2, output_time_steps=1)
    for (x, y), (jx, jy) in zip(list(series), list(jseries)):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    got.close()
    want.close()


def test_import_without_optional_modules():
    """``import dlwp_torch`` and its data modules work without h5py,
    matplotlib, scipy, netCDF4, zarr, pygrib and cdsapi; file I/O then
    raises naming h5py, and only ``dlwp_torch.plot`` needs matplotlib."""
    code = """
import sys
for name in ("h5py", "matplotlib", "scipy", "netCDF4", "zarr", "pygrib",
             "cdsapi"):
    sys.modules[name] = None
import numpy as np
import dlwp_torch
import dlwp_torch.data.cfs, dlwp_torch.data.era5, dlwp_torch.data.native
import dlwp_torch.data.grib_params, dlwp_torch.serve
from dlwp_torch import PredictorDataset
ds = PredictorDataset(np.zeros((2, 1, 2, 2), np.float32),
                      np.array(["2000-01-01", "2000-01-02"], "datetime64[ns]"),
                      ["X"], np.zeros(2), np.zeros(2))
try:
    ds.to_file("unused.h5")
except RuntimeError as e:
    assert "h5py" in str(e), e
else:
    raise AssertionError("to_file ran without h5py")
try:
    import dlwp_torch.plot
except ImportError:
    pass
else:
    raise AssertionError("dlwp_torch.plot imported without matplotlib")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

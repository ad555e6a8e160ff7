"""Preprocessing: gridded data -> predictor datasets and files (port of
``dlwp_tpu.data.preprocessing``).

The reference's ``Preprocessor`` (``DLWP/model/preprocessing.py``) with its
two output modes:

- :meth:`Preprocessor.data_to_series`: one continuous ``predictors``
  series (sample, varlev, lat, lon), the format the series samplers take;
- :meth:`Preprocessor.data_to_samples`: explicit (predictors, targets)
  pairs with a ``time_step`` axis.

Both flatten (variable, level) pairs into ``varlev`` names, and de-mean and
scale each varlev by its streaming mean and std (NaN rows skipped), in the
JAX package's batch order, so the statistics agree with its to rounding.

In memory by default; with ``output_file=`` the scaled batches stream into
a chunked HDF5 predictor file (:mod:`dlwp_torch.data.dataset`'s schema,
needs h5py) and the dataset returned reads it lazily, so host memory stays
O(``batch_samples``) however long the series. :meth:`Preprocessor.to_file`
writes the current dataset. The input is any object with ``times`` /
``lat`` / ``lon`` and ``field(variable, level)`` (:class:`DataSource`),
such as :class:`~dlwp_torch.data.barotropic_archive.BarotropicArchiveSource`
or :class:`~dlwp_torch.data.cfs.CFSReanalysis`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Protocol, Sequence

import numpy as np

from dlwp_torch.data.dataset import NO_H5PY, PredictorDataset


def _h5py():
    """h5py, imported where a file is written (optional)."""
    try:
        import h5py
    except ImportError:
        raise RuntimeError(NO_H5PY) from None
    return h5py


def _write_coords(sink, times, varlev, lat, lon, mean, std, attrs):
    """The predictor file's datasets besides the arrays, and its attrs."""
    sink.create_dataset(
        "sample", data=times.astype("datetime64[ns]").astype(np.int64))
    sink.create_dataset("varlev", data=np.array([v.encode() for v in varlev]))
    sink.create_dataset("lat", data=np.asarray(lat))
    sink.create_dataset("lon", data=np.asarray(lon))
    sink.create_dataset("mean", data=np.asarray(mean))
    sink.create_dataset("std", data=np.asarray(std))
    for k, val in attrs.items():
        sink.attrs[k] = val


class DataSource(Protocol):
    @property
    def times(self) -> np.ndarray: ...  # (t,) datetime64

    @property
    def lat(self) -> np.ndarray: ...

    @property
    def lon(self) -> np.ndarray: ...

    def field(self, variable: str, level: int | str | None) -> np.ndarray:
        """The (time, lat, lon) array of one variable and level."""
        ...


def streaming_mean_std(get_batch, n_samples: int,
                       batch: int = 1000) -> tuple[float, float]:
    """Two-pass mean and std over sample batches ``get_batch(i, j)``,
    ignoring NaN (reference mean_by_batch / std_by_batch), in float64."""
    total, count = 0.0, 0
    for i in range(0, n_samples, batch):
        x = np.asarray(get_batch(i, min(i + batch, n_samples)),
                       dtype=np.float64)
        total += np.nansum(x)
        count += np.sum(~np.isnan(x))
    mean = total / max(count, 1)
    var = 0.0
    for i in range(0, n_samples, batch):
        x = np.asarray(get_batch(i, min(i + batch, n_samples)),
                       dtype=np.float64)
        var += np.nansum((x - mean) ** 2)
    return float(mean), float(np.sqrt(var / max(count, 1)))


def _varlev_names(variables: Sequence[str], levels: Sequence,
                  pairwise: bool) -> list[tuple[str, object, str]]:
    """The flattened (variable, level, 'VAR/level') list: ``pairwise`` zips
    variables with levels, else their product; a level of None / 0 / ''
    gives the bare variable name."""
    if pairwise:
        if len(variables) != len(levels):
            raise ValueError("pairwise requires equal-length variables/levels")
        pairs = zip(variables, levels)
    else:
        pairs = ((v, lev) for v in variables for lev in levels)
    return [(v, None, str(v)) if lev in (None, 0, "") else (v, lev, f"{v}/{lev}")
            for v, lev in pairs]


class Preprocessor:
    """Build predictor datasets and files from a data source."""

    def __init__(self, source: DataSource):
        self.source = source
        self.data: PredictorDataset | None = None

    def data_to_series(self, variables: Sequence[str], levels: Sequence,
                       pairwise: bool = False, scale_variables: bool = True,
                       batch_samples: int = 1000, dtype=np.float32,
                       output_file: str | None = None) -> PredictorDataset:
        """The continuous series (sample, varlev, lat, lon), each varlev
        scaled as (x - mean) / std when ``scale_variables`` (a zero std
        counts as 1), ``mean`` / ``std`` kept in the dataset.

        With ``output_file`` the scaled batches stream into that HDF5
        file, one chunk per (batch, varlev) write, and the dataset
        returned reads it lazily."""
        names = _varlev_names(variables, levels, pairwise)
        times = np.asarray(self.source.times)
        lat = np.asarray(self.source.lat)
        lon = np.asarray(self.source.lon)
        n, nv = len(times), len(names)
        shape = (n, nv, lat.shape[0], lon.shape[0])
        attrs = {"scaling": str(bool(scale_variables)), "format": "series"}
        if output_file is not None:
            sink = _h5py().File(output_file, "w")
            # Every chunk is written exactly once: no read-modify-write.
            pred = sink.create_dataset(
                "predictors", shape=shape, dtype=dtype,
                chunks=(min(batch_samples, n), 1) + shape[2:])
        else:
            sink = None
            pred = np.empty(shape, dtype=dtype)
        mean, std = np.empty(nv), np.empty(nv)
        varlev = [nm for _, _, nm in names]
        with sink if sink is not None else contextlib.nullcontext():
            for j, (v, lev, _) in enumerate(names):
                field = self.source.field(v, lev)
                m, s = streaming_mean_std(lambda a, b: field[a:b], n,
                                          batch_samples)
                mean[j], std[j] = m, (s if s > 0 else 1.0)
                for i in range(0, n, batch_samples):
                    chunk = np.asarray(field[i:i + batch_samples],
                                       dtype=np.float64)
                    if scale_variables:
                        chunk = (chunk - mean[j]) / std[j]
                    pred[i:i + batch_samples, j] = chunk.astype(dtype)
            if sink is not None:
                _write_coords(sink, times, varlev, lat, lon, mean, std, attrs)
        if sink is not None:
            self.data = PredictorDataset.from_file(output_file, load="lazy")
            return self.data
        self.data = PredictorDataset(
            predictors=pred, sample=times.astype("datetime64[ns]"),
            varlev=varlev, lat=lat, lon=lon, mean=mean, std=std, attrs=attrs)
        return self.data

    def data_to_samples(self, variables: Sequence[str], levels: Sequence,
                        time_steps: int = 1, pairwise: bool = False,
                        scale_variables: bool = True,
                        batch_samples: int = 1000, dtype=np.float32,
                        output_file: str | None = None) -> PredictorDataset:
        """(predictors, targets) of shape (sample, time_step, varlev, lat,
        lon): sample i holds inputs at times [i, i + T) and targets at
        [i + T, i + 2T), dated by its last input step.

        With ``output_file`` the series streams through
        ``output_file + '.series'`` and the samples into ``output_file``,
        batch by batch; the dataset returned reads the samples lazily."""
        series_file = None if output_file is None else output_file + ".series"
        series = self.data_to_series(variables, levels, pairwise,
                                     scale_variables, batch_samples, dtype,
                                     output_file=series_file)
        arr = series.predictors  # numpy, or lazy h5py when streaming
        T = int(time_steps)
        n = arr.shape[0] - 2 * T + 1
        if n <= 0:
            if series_file is not None:
                series.close()
                os.remove(series_file)
            raise ValueError("not enough samples for requested time_steps")
        shape = (n, T) + tuple(arr.shape[1:])
        if output_file is not None:
            sink = _h5py().File(output_file, "w")
            chunk = (min(batch_samples, n), 1) + tuple(arr.shape[1:])
            pred = sink.create_dataset("predictors", shape=shape, dtype=dtype,
                                       chunks=chunk)
            targ = sink.create_dataset("targets", shape=shape, dtype=dtype,
                                       chunks=chunk)
        else:
            sink = None
            pred, targ = (np.empty(shape, dtype=dtype),
                          np.empty(shape, dtype=dtype))
        sample_times = series.sample[T - 1:T - 1 + n]
        attrs = {"scaling": series.attrs["scaling"], "format": "samples"}
        with sink if sink is not None else contextlib.nullcontext():
            for i in range(0, n, batch_samples):
                b = min(i + batch_samples, n) - i
                for t in range(T):
                    pred[i:i + b, t] = arr[i + t:i + t + b]
                    targ[i:i + b, t] = arr[i + T + t:i + T + t + b]
            if sink is not None:
                _write_coords(sink, sample_times, series.varlev, series.lat,
                              series.lon, series.mean, series.std, attrs)
        if sink is not None:
            series.close()
            self.data = PredictorDataset.from_file(output_file, load="lazy")
            return self.data
        self.data = PredictorDataset(
            predictors=pred, targets=targ, sample=sample_times,
            varlev=series.varlev, lat=series.lat, lon=series.lon,
            mean=series.mean, std=series.std, attrs=attrs)
        return self.data

    def to_file(self, path: str) -> None:
        """Write the current dataset as a predictor file."""
        if self.data is None:
            raise RuntimeError("run data_to_series/data_to_samples first")
        self.data.to_file(path)

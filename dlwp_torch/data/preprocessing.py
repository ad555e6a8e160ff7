"""Preprocessing: gridded data -> predictor datasets, in memory (port of
``dlwp_tpu.data.preprocessing``).

The reference's ``Preprocessor`` (``DLWP/model/preprocessing.py``) with its
two output modes, built in host memory:

- :meth:`Preprocessor.data_to_series`: one continuous ``predictors``
  series (sample, varlev, lat, lon), the format the series samplers take;
- :meth:`Preprocessor.data_to_samples`: explicit (predictors, targets)
  pairs with a ``time_step`` axis.

Both flatten (variable, level) pairs into ``varlev`` names, and de-mean and
scale each varlev by its streaming mean and std (NaN rows skipped), in the
JAX package's batch order, so the statistics agree with its to rounding.

Writing predictor files (``output_file=``, :meth:`Preprocessor.to_file`)
waits for the host-data slice (ROADMAP.md section 1, item 5) and raises.
The input is any object with ``times`` / ``lat`` / ``lon`` and
``field(variable, level)`` (:class:`DataSource`), such as
:class:`~dlwp_torch.data.barotropic_archive.BarotropicArchiveSource`.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np

from dlwp_torch.data.dataset import PredictorDataset

FILE_OUTPUT = ("writing predictor files is not ported yet (ROADMAP.md "
               "section 1, item 5); pass output_file=None for an in-memory "
               "dataset")


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
    """Build predictor datasets from a data source."""

    def __init__(self, source: DataSource):
        self.source = source
        self.data: PredictorDataset | None = None

    def data_to_series(self, variables: Sequence[str], levels: Sequence,
                       pairwise: bool = False, scale_variables: bool = True,
                       batch_samples: int = 1000, dtype=np.float32,
                       output_file: str | None = None) -> PredictorDataset:
        """The continuous series (sample, varlev, lat, lon), each varlev
        scaled as (x - mean) / std when ``scale_variables`` (a zero std
        counts as 1), ``mean`` / ``std`` kept in the dataset."""
        if output_file is not None:
            raise NotImplementedError(FILE_OUTPUT)
        names = _varlev_names(variables, levels, pairwise)
        times = np.asarray(self.source.times)
        lat = np.asarray(self.source.lat)
        lon = np.asarray(self.source.lon)
        n, nv = len(times), len(names)
        pred = np.empty((n, nv, lat.shape[0], lon.shape[0]), dtype=dtype)
        mean, std = np.empty(nv), np.empty(nv)
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
        self.data = PredictorDataset(
            predictors=pred, sample=times.astype("datetime64[ns]"),
            varlev=[nm for _, _, nm in names], lat=lat, lon=lon, mean=mean,
            std=std, attrs={"scaling": str(bool(scale_variables)),
                            "format": "series"})
        return self.data

    def data_to_samples(self, variables: Sequence[str], levels: Sequence,
                        time_steps: int = 1, pairwise: bool = False,
                        scale_variables: bool = True,
                        batch_samples: int = 1000, dtype=np.float32,
                        output_file: str | None = None) -> PredictorDataset:
        """(predictors, targets) of shape (sample, time_step, varlev, lat,
        lon): sample i holds inputs at times [i, i + T) and targets at
        [i + T, i + 2T), dated by its last input step."""
        if output_file is not None:
            raise NotImplementedError(FILE_OUTPUT)
        series = self.data_to_series(variables, levels, pairwise,
                                     scale_variables, batch_samples, dtype)
        arr = series.predictors
        T = int(time_steps)
        n = arr.shape[0] - 2 * T + 1
        if n <= 0:
            raise ValueError("not enough samples for requested time_steps")
        shape = (n, T) + tuple(arr.shape[1:])
        pred, targ = np.empty(shape, dtype=dtype), np.empty(shape, dtype=dtype)
        for t in range(T):
            pred[:, t] = arr[t:t + n]
            targ[:, t] = arr[T + t:T + t + n]
        self.data = PredictorDataset(
            predictors=pred, targets=targ, sample=series.sample[T - 1:T - 1 + n],
            varlev=series.varlev, lat=series.lat, lon=series.lon,
            mean=series.mean, std=series.std,
            attrs={"scaling": series.attrs["scaling"], "format": "samples"})
        return self.data

    def to_file(self, path: str) -> None:
        if self.data is None:
            raise RuntimeError("run data_to_series/data_to_samples first")
        raise NotImplementedError(FILE_OUTPUT)

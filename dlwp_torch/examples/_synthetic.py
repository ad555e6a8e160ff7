"""Shared synthetic data source for the runnable workflows.

The workflows default to a physically plausible synthetic global dataset
(a drifting wave pattern over a zonal-mean basic state) unless a predictor
file is supplied; every workflow is the same from the predictor file on.
The fields equal those of the JAX package's examples bit for bit.
"""

from __future__ import annotations

import numpy as np

from dlwp_torch.data import Preprocessor


class SyntheticGlobalSource:
    """DataSource protocol: slowly drifting planetary-wave height fields."""

    def __init__(self, n_samples=600, nlat=37, nlon=72, dt_hours=6, seed=0):
        self.times = (
            np.datetime64("2005-01-01")
            + np.arange(n_samples) * np.timedelta64(dt_hours, "h")
        )
        self.lat = np.linspace(90.0, -90.0, nlat)
        self.lon = np.arange(nlon) * (360.0 / nlon)
        self._rng = np.random.RandomState(seed)
        self._n = n_samples
        self._dt = dt_hours

    def field(self, variable, level):
        lat = np.radians(self.lat)[:, None]
        lon = np.radians(self.lon)[None, :]
        t = np.arange(self._n)[:, None, None] * self._dt / 24.0  # days
        base = {"HGT": 5500.0, "THICK": 5400.0, "TMP": 260.0}.get(variable, 5000.0)
        amp = {"HGT": 120.0, "THICK": 90.0, "TMP": 15.0}.get(variable, 50.0)
        zonal = -300.0 * np.sin(lat) ** 2
        wave1 = amp * np.cos(lat) ** 3 * np.cos(3 * (lon - 0.12 * t))
        wave2 = 0.5 * amp * np.cos(lat) ** 2 * np.sin(2 * (lon + 0.07 * t) + 1.0)
        seasonal = 30.0 * np.sin(2 * np.pi * t / 365.0) * np.sin(lat)
        noise = 2.0 * self._rng.randn(self._n, 1, 1)
        return base + zonal + wave1 + wave2 + seasonal + noise


def synthetic_predictor_file(path=None, **kwargs):
    """Build (and optionally save) a scaled series predictor dataset."""
    pp = Preprocessor(SyntheticGlobalSource(**kwargs))
    ds = pp.data_to_series(
        ["HGT", "THICK"], [500, "300-700"], pairwise=True, scale_variables=True
    )
    if path:
        ds.to_file(path)
    return ds


def load_or_synthetic(predictor_file, note="using synthetic demo data"):
    """The predictor file's dataset, or (printing ``note`` when it is not
    None) the synthetic demo dataset."""
    from dlwp_torch.data import PredictorDataset

    if predictor_file:
        return PredictorDataset.from_file(predictor_file)
    if note is not None:
        print(note)
    return synthetic_predictor_file()

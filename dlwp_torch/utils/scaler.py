"""Feature scaling and imputation (own copy of ``dlwp_tpu.utils.scaler``).

Per-feature statistics over the sample axis, in numpy on the host.
"""

from __future__ import annotations

import numpy as np


class StandardScaler:
    """(x - mean) / std per feature (all non-sample axes), NaN-tolerant."""

    def __init__(self, with_mean: bool = True, with_std: bool = True):
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_: np.ndarray | None = None
        self.std_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x)
        self.mean_ = (
            np.nanmean(x, axis=0) if self.with_mean else np.zeros(x.shape[1:])
        )
        if self.with_std:
            std = np.nanstd(x, axis=0)
            std[std == 0] = 1.0
            self.std_ = std
        else:
            self.std_ = np.ones(x.shape[1:])
        return self

    def transform(self, x):
        return (np.asarray(x) - self.mean_) / self.std_

    def inverse_transform(self, x):
        return np.asarray(x) * self.std_ + self.mean_

    def fit_transform(self, x):
        return self.fit(x).transform(x)


class MinMaxScaler:
    """Scale each feature to [0, 1] over the sample axis."""

    def __init__(self):
        self.min_: np.ndarray | None = None
        self.scale_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "MinMaxScaler":
        x = np.asarray(x)
        self.min_ = np.nanmin(x, axis=0)
        rng = np.nanmax(x, axis=0) - self.min_
        rng[rng == 0] = 1.0
        self.scale_ = rng
        return self

    def transform(self, x):
        return (np.asarray(x) - self.min_) / self.scale_

    def inverse_transform(self, x):
        return np.asarray(x) * self.scale_ + self.min_

    def fit_transform(self, x):
        return self.fit(x).transform(x)


class MeanImputer:
    """Replace NaNs with the per-feature mean."""

    def __init__(self):
        self.mean_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "MeanImputer":
        self.mean_ = np.nanmean(np.asarray(x), axis=0)
        return self

    def transform(self, x):
        x = np.array(x, copy=True)
        mask = np.isnan(x)
        if mask.any():
            x[mask] = np.broadcast_to(self.mean_, x.shape)[mask]
        return x

    def fit_transform(self, x):
        return self.fit(x).transform(x)


SCALERS = {
    "standard": StandardScaler,
    "minmax": MinMaxScaler,
    None: None,
}

"""The predictor dataset (port of ``dlwp_tpu.data.dataset``, in memory).

``predictors`` is (sample, [time_step,] varlev, lat, lon), with per-varlev
``mean``/``std`` and coordinate vectors, as in the reference's predictor
files. Reading and writing files waits for the host-data slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np


@dataclasses.dataclass
class PredictorDataset:
    predictors: Any
    sample: np.ndarray
    varlev: list[str]
    lat: np.ndarray
    lon: np.ndarray
    mean: np.ndarray | None = None
    std: np.ndarray | None = None
    targets: Any | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def has_time_step(self) -> bool:
        return np.ndim(self.predictors) == 5

    def varlev_index(self, names: Sequence[str]) -> np.ndarray:
        """Indices of the given varlev names (order preserved)."""
        lookup = {v: i for i, v in enumerate(self.varlev)}
        try:
            return np.array([lookup[n] for n in names], dtype=np.int64)
        except KeyError as e:
            raise KeyError(
                f"varlev {e.args[0]!r} not in dataset (has {self.varlev})"
            ) from None

    def isel_sample(self, index) -> "PredictorDataset":
        """Subset along the sample axis (train/validation splits)."""
        return dataclasses.replace(
            self,
            predictors=np.asarray(self.predictors)[index],
            sample=self.sample[index],
            targets=None if self.targets is None
            else np.asarray(self.targets)[index],
        )

    def sel(self, varlev: Sequence[str] | None = None) -> "PredictorDataset":
        """Subset channels by varlev name (a copy)."""
        if varlev is None:
            return self
        idx = self.varlev_index(varlev)
        axis = 2 if self.has_time_step else 1
        return dataclasses.replace(
            self,
            predictors=np.take(np.asarray(self.predictors), idx, axis=axis),
            varlev=[self.varlev[i] for i in idx],
            mean=None if self.mean is None else self.mean[idx],
            std=None if self.std is None else self.std[idx],
            targets=None if self.targets is None
            else np.take(np.asarray(self.targets), idx, axis=axis),
        )

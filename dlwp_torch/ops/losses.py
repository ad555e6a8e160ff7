"""Training losses and skill metrics (port of ``dlwp_tpu.ops.losses``).

Latitude-weighted losses (cosine / midlatitude weighting) and the anomaly
correlation coefficient metric and loss with its regularization variants,
as the reference's custom losses define them. Each loss maps
``(y_true, y_pred)`` tensors to a 0-d tensor and is differentiable; the
factories return picklable callables.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean((y_pred - y_true) ** 2)


def mae(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(y_pred - y_true))


def latitude_weights(lats: np.ndarray, weighting: str = "cosine") -> np.ndarray:
    """'cosine' -> cos(lat); 'midlatitude' -> cos(lat) + 0.5 sin^2(2 lat),
    float64 on the host."""
    if weighting not in ("cosine", "midlatitude"):
        raise ValueError("weighting must be 'cosine' or 'midlatitude'")
    rad = np.radians(np.asarray(lats, dtype=np.float64))
    w = np.cos(rad)
    if weighting == "midlatitude":
        w = w + 0.5 * np.sin(2.0 * rad) ** 2
    return w


class LatitudeWeightedLoss:
    """Picklable latitude-weighted loss (see :func:`latitude_weighted_loss`).
    The weights' tensor is kept per device and dtype, so a train step does
    not copy them from the host."""

    def __init__(self, loss_function, lats, weighting="cosine", lat_axis=-2):
        self.loss_function = loss_function
        self.weights = latitude_weights(lats, weighting)
        self.lat_axis = lat_axis
        self.__name__ = "latitude_weighted_loss"
        self._cache: dict = {}

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_cache"] = {}
        return state

    def _weights(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype, like.ndim)
        wb = self._cache.get(key)
        if wb is None:
            shape = [1] * like.ndim
            shape[self.lat_axis] = self.weights.shape[0]
            wb = torch.as_tensor(self.weights).reshape(shape).to(
                device=like.device, dtype=like.dtype, non_blocking=True)
            self._cache[key] = wb
        return wb

    def __call__(self, y_true, y_pred):
        wb = self._weights(y_true)
        return self.loss_function(y_true * wb, y_pred * wb)


def latitude_weighted_loss(
    loss_function: Callable = mse,
    lats: np.ndarray | None = None,
    weighting: str = "cosine",
    lat_axis: int = -2,
) -> Callable:
    """A loss that scales y_true and y_pred by the latitude weight before
    ``loss_function`` (so MSE is weighted by w^2), the weights lying along
    ``lat_axis``. ``lats=None`` returns ``loss_function`` itself."""
    if lats is None:
        return loss_function
    return LatitudeWeightedLoss(loss_function, lats, weighting, lat_axis)


def anomaly_correlation(y_true, y_pred, mean=0.0):
    """Anomaly correlation about a climatological ``mean``:
    mean(y'_p y'_t) / sqrt(mean(y'_p^2) mean(y'_t^2))."""
    yp = y_pred - mean
    yt = y_true - mean
    return torch.mean(yp * yt) / torch.sqrt(
        torch.mean(yp ** 2) * torch.mean(yt ** 2))


class AnomalyCorrelationLoss:
    """Picklable ACC loss (see :func:`anomaly_correlation_loss`)."""

    def __init__(self, mean=None, regularize_mean="mse", reverse=True):
        if regularize_mean is not None:
            if regularize_mean not in ("global", "spatial", "mse", "mae"):
                raise ValueError(f"bad regularize_mean {regularize_mean!r}")
            reverse = True
        self.mean = None if mean is None else np.asarray(mean)
        self.regularize_mean = regularize_mean
        self.reverse = reverse
        self.__name__ = "anomaly_correlation_loss"

    def __call__(self, y_true, y_pred):
        mean = (0.0 if self.mean is None else torch.as_tensor(
            self.mean, dtype=y_true.dtype, device=y_true.device))
        a = anomaly_correlation(y_true, y_pred, mean)
        reg = self.regularize_mean
        if reg is None:
            return -a if self.reverse else a
        if reg == "global":
            m = torch.abs((torch.mean(y_true) - torch.mean(y_pred))
                          / torch.mean(y_true))
        elif reg == "spatial":
            mt = torch.mean(y_true, dim=(-2, -1))
            mp = torch.mean(y_pred, dim=(-2, -1))
            m = torch.mean(torch.abs((mt - mp) / mt))
        elif reg == "mse":
            m = mse(y_true, y_pred)
        else:  # mae
            m = mae(y_true, y_pred)
        return m - a if self.reverse else a - m


def anomaly_correlation_loss(
    mean: np.ndarray | None = None,
    regularize_mean: str | None = "mse",
    reverse: bool = True,
) -> Callable:
    """ACC loss. ``mean``: a climatological mean broadcastable to the
    predictions, or None for zero. ``regularize_mean`` (None, 'global',
    'spatial', 'mse', 'mae') adds a mean-error penalty m, giving
    ``m - acc``; ``reverse`` negates so that minimizing drives ACC to 1
    (forced on when regularized)."""
    return AnomalyCorrelationLoss(mean, regularize_mean, reverse)


__all__ = [
    "AnomalyCorrelationLoss",
    "LatitudeWeightedLoss",
    "anomaly_correlation",
    "anomaly_correlation_loss",
    "latitude_weighted_loss",
    "latitude_weights",
    "mae",
    "mse",
]

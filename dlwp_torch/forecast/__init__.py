"""Autoregressive forecasting and verification (port of
``dlwp_tpu.forecast``)."""

from dlwp_torch.forecast import verify
from dlwp_torch.forecast.rollout import (
    Forecast,
    TimeSeriesEstimator,
    graph_counts,
    reset_graph_counts,
)

__all__ = ["Forecast", "TimeSeriesEstimator", "graph_counts",
           "reset_graph_counts", "verify"]

"""Host utilities (port of ``dlwp_tpu.utils``)."""

from dlwp_torch.utils.scaler import SCALERS, MeanImputer, MinMaxScaler, StandardScaler

__all__ = ["SCALERS", "MeanImputer", "MinMaxScaler", "StandardScaler"]

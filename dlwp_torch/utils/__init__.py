"""Host utilities (port of ``dlwp_tpu.utils``)."""

from dlwp_torch.utils.scaler import SCALERS, MeanImputer, MinMaxScaler, StandardScaler
from dlwp_torch.utils.serialization import load_model, save_model
from dlwp_torch.utils.split import delete_nan_samples, train_test_split_ind

__all__ = [
    "SCALERS",
    "MeanImputer",
    "MinMaxScaler",
    "StandardScaler",
    "delete_nan_samples",
    "load_model",
    "save_model",
    "train_test_split_ind",
]

"""Host utilities (port of ``dlwp_tpu.utils``; its ``compile_safe``, a
workaround for a TPU compile fault, is not ported)."""

from dlwp_torch.utils.reflection import get_classes, get_from_module, get_methods
from dlwp_torch.utils.scaler import SCALERS, MeanImputer, MinMaxScaler, StandardScaler
from dlwp_torch.utils.serialization import load_model, save_model
from dlwp_torch.utils.split import delete_nan_samples, train_test_split_ind
from dlwp_torch.utils.tensorboard import TensorBoardWriter

__all__ = [
    "SCALERS",
    "MeanImputer",
    "MinMaxScaler",
    "StandardScaler",
    "TensorBoardWriter",
    "delete_nan_samples",
    "get_classes",
    "get_from_module",
    "get_methods",
    "load_model",
    "save_model",
    "train_test_split_ind",
]

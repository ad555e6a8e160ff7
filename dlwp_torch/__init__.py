"""dlwp_torch: the DLWP forecast stack in PyTorch and CUDA for NVIDIA Hopper.

The port of ``dlwp_tpu`` (JAX on TPU), module for module, with the same
NCHW / (B, T, C, H, W) layouts at public functions. Entry points run on
``cuda`` unless given ``device="cpu"``; see :mod:`dlwp_torch.device`.
Hand-written kernels live in ``csrc/`` with their wrappers and plain
PyTorch versions in :mod:`dlwp_torch.kernels`.
"""

from dlwp_torch.data import PredictorDataset, SeriesSampler
from dlwp_torch.device import resolve_device
from dlwp_torch.forecast import Forecast, TimeSeriesEstimator
from dlwp_torch.models import DLWPNeuralNet, build_sequential
from dlwp_torch.weights import load_flax_params, tree_from_leaves

__all__ = [
    "DLWPNeuralNet",
    "Forecast",
    "PredictorDataset",
    "SeriesSampler",
    "TimeSeriesEstimator",
    "build_sequential",
    "load_flax_params",
    "resolve_device",
    "tree_from_leaves",
]

"""dlwp_torch: the DLWP forecast stack in PyTorch and CUDA for NVIDIA Hopper.

The port of ``dlwp_tpu`` (JAX on TPU), module for module, with the same
NCHW / (B, T, C, H, W) layouts at public functions: the ConvLSTM forecast
stack, its lat-band spatial-parallel form (:mod:`dlwp_torch.parallel`)
and the spectral barotropic core. Entry points run on
``cuda`` unless given ``device="cpu"``; see :mod:`dlwp_torch.device`.
Hand-written kernels live in ``csrc/`` with their wrappers and plain
PyTorch versions in :mod:`dlwp_torch.kernels`.
"""

from dlwp_torch.barotropic import (
    BarotropicModel,
    BarotropicModelPsi,
    BarotropicState,
)
from dlwp_torch.data import PredictorDataset, SeriesSampler
from dlwp_torch.device import resolve_device
from dlwp_torch.forecast import Forecast, TimeSeriesEstimator
from dlwp_torch.grid import LatLonGrid
from dlwp_torch.models import DLWPNeuralNet, build_sequential
from dlwp_torch.spectral import SphericalHarmonics
from dlwp_torch.weights import (
    barotropic_state_from_numpy,
    load_flax_params,
    tree_from_leaves,
)

__all__ = [
    "BarotropicModel",
    "BarotropicModelPsi",
    "BarotropicState",
    "DLWPNeuralNet",
    "Forecast",
    "LatLonGrid",
    "PredictorDataset",
    "SeriesSampler",
    "SphericalHarmonics",
    "TimeSeriesEstimator",
    "barotropic_state_from_numpy",
    "build_sequential",
    "load_flax_params",
    "resolve_device",
    "tree_from_leaves",
]

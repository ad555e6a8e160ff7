"""dlwp_torch: the DLWP forecast stack in PyTorch and CUDA for NVIDIA Hopper.

The port of ``dlwp_tpu`` (JAX on TPU), module for module, with the same
NCHW / (B, T, C, H, W) layouts at public functions: the ConvLSTM forecast
stack, its training (:mod:`dlwp_torch.train`, with device-resident
batches) and verification (:mod:`dlwp_torch.forecast.verify`), its lat-band
and lat x lon spatial-parallel form (:mod:`dlwp_torch.parallel`, trained
through the same :class:`~dlwp_torch.train.Trainer`) and the spectral
barotropic core, and its deployment as ``torch.export`` servables
(:mod:`dlwp_torch.serve`). Entry points run on
``cuda`` unless given ``device="cpu"``; see :mod:`dlwp_torch.device`.
Hand-written kernels live in ``csrc/`` with their wrappers and plain
PyTorch versions in :mod:`dlwp_torch.kernels`.
"""

from dlwp_torch.barotropic import (
    BarotropicModel,
    BarotropicModelPsi,
    BarotropicState,
)
from dlwp_torch.data import (
    DeviceSeriesSampler,
    PredictorDataset,
    SamplesSampler,
    SeriesSampler,
    device_prefetch,
)
from dlwp_torch.device import resolve_device
from dlwp_torch.entry import dryrun_multichip
from dlwp_torch.forecast import Forecast, TimeSeriesEstimator
from dlwp_torch.grid import LatLonGrid
from dlwp_torch.models import (
    DLWPFunctional,
    DLWPNeuralNet,
    SkipTower,
    build_sequential,
)
from dlwp_torch.spectral import SphericalHarmonics
from dlwp_torch.train import TrainConfig, Trainer
from dlwp_torch.utils import load_model, save_model
from dlwp_torch.weights import (
    barotropic_state_from_numpy,
    flax_tree,
    load_flax_params,
    load_optax_adam_state,
    load_optax_state,
    tree_from_leaves,
)

__all__ = [
    "BarotropicModel",
    "BarotropicModelPsi",
    "BarotropicState",
    "DLWPFunctional",
    "DLWPNeuralNet",
    "DeviceSeriesSampler",
    "Forecast",
    "LatLonGrid",
    "PredictorDataset",
    "SamplesSampler",
    "SeriesSampler",
    "SkipTower",
    "SphericalHarmonics",
    "TimeSeriesEstimator",
    "TrainConfig",
    "Trainer",
    "barotropic_state_from_numpy",
    "build_sequential",
    "device_prefetch",
    "dryrun_multichip",
    "flax_tree",
    "load_flax_params",
    "load_model",
    "load_optax_adam_state",
    "load_optax_state",
    "resolve_device",
    "save_model",
    "tree_from_leaves",
]

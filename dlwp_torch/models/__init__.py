"""Model layers, ``build_sequential`` and API (port of ``dlwp_tpu.models``)."""

from dlwp_torch.models.api import DLWPFunctional, DLWPNeuralNet, shape_series
from dlwp_torch.models.cube import (
    CubeAveragePooling2D,
    CubeSphereConv2D,
    CubeSpherePadding2D,
    CubeUNet,
    CubeUpSampling2D,
)
from dlwp_torch.models.cnn import LAYER_REGISTRY, SequentialModel, build_sequential
from dlwp_torch.models.layers import (
    Activation,
    AvgPool2D,
    ConvLSTM2D,
    CyclicConv2D,
    FusedConvPool2D,
    Identity,
    MaxPool2D,
    Reshape,
    RowConv2D,
    SplitConvPool2D,
    UpConv2D,
    UpSampling2D,
    get_activation,
)
from dlwp_torch.models.spherical import (
    S2Convolution,
    SO3Convolution,
    s2_near_identity_grid,
)
from dlwp_torch.models.unet import SkipTower, SliceChannels

__all__ = [
    "Activation",
    "AvgPool2D",
    "ConvLSTM2D",
    "CubeAveragePooling2D",
    "CubeSphereConv2D",
    "CubeSpherePadding2D",
    "CubeUNet",
    "CubeUpSampling2D",
    "CyclicConv2D",
    "DLWPFunctional",
    "DLWPNeuralNet",
    "FusedConvPool2D",
    "Identity",
    "LAYER_REGISTRY",
    "MaxPool2D",
    "Reshape",
    "RowConv2D",
    "S2Convolution",
    "SO3Convolution",
    "SequentialModel",
    "SkipTower",
    "SliceChannels",
    "SplitConvPool2D",
    "UpConv2D",
    "UpSampling2D",
    "build_sequential",
    "get_activation",
    "s2_near_identity_grid",
    "shape_series",
]

"""Spherical stencil ops (port of ``dlwp_tpu.ops``)."""

from dlwp_torch.ops.conv import conv_after_upsample2, cyclic_conv2d
from dlwp_torch.ops.losses import (
    anomaly_correlation_loss,
    latitude_weighted_loss,
    mae,
    mse,
)
from dlwp_torch.ops.padding import pad_latlon
from dlwp_torch.ops.pooling import avg_pool2d, max_pool2d, upsample2d

__all__ = [
    "anomaly_correlation_loss",
    "avg_pool2d",
    "conv_after_upsample2",
    "cyclic_conv2d",
    "latitude_weighted_loss",
    "mae",
    "mse",
    "max_pool2d",
    "pad_latlon",
    "upsample2d",
]

"""Spherical stencil ops (port of ``dlwp_tpu.ops``)."""

from dlwp_torch.ops.conv import (
    conv_after_upsample2,
    conv_pool2_even_dilation,
    cyclic_conv2d,
    cyclic_conv2d_edgefix,
    row_conv2d,
)
from dlwp_torch.ops.losses import (
    anomaly_correlation,
    anomaly_correlation_loss,
    latitude_weighted_loss,
    mae,
    mse,
)
from dlwp_torch.ops.padding import (
    pad_constant,
    pad_fill,
    pad_latlon,
    pad_periodic,
    pad_reflect,
)
from dlwp_torch.ops.pooling import avg_pool2d, max_pool2d, upsample2d

__all__ = [
    "anomaly_correlation",
    "anomaly_correlation_loss",
    "avg_pool2d",
    "conv_after_upsample2",
    "conv_pool2_even_dilation",
    "cyclic_conv2d",
    "cyclic_conv2d_edgefix",
    "latitude_weighted_loss",
    "mae",
    "max_pool2d",
    "mse",
    "pad_constant",
    "pad_fill",
    "pad_latlon",
    "pad_periodic",
    "pad_reflect",
    "row_conv2d",
    "upsample2d",
]

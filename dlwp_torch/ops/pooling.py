"""Pooling and nearest upsampling on the trailing (lat, lon) axes.

Port of ``dlwp_tpu.ops.pooling``: VALID max and average pooling (Keras
defaults) and nearest-neighbour upsampling, for tensors of any rank >= 3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _over_last_two(fn, x: torch.Tensor, *args) -> torch.Tensor:
    lead = x.shape[:-2]
    y = fn(x.reshape((-1, 1) + x.shape[-2:]), *args)
    return y.reshape(lead + y.shape[-2:])


def max_pool2d(x: torch.Tensor, window=(2, 2), strides=None) -> torch.Tensor:
    return _over_last_two(F.max_pool2d, x, tuple(window),
                          tuple(strides or window))


def avg_pool2d(x: torch.Tensor, window=(2, 2), strides=None) -> torch.Tensor:
    return _over_last_two(F.avg_pool2d, x, tuple(window),
                          tuple(strides or window))


def upsample2d(x: torch.Tensor, factor=(2, 2)) -> torch.Tensor:
    """Nearest-neighbour upsampling (Keras ``UpSampling2D``)."""
    x = x.repeat_interleave(factor[0], dim=-2)
    return x.repeat_interleave(factor[1], dim=-1)

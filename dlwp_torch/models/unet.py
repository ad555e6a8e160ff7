"""Skip-connection (U-Net-style) models (port of ``dlwp_tpu.models.unet``).

The reference's ``skip_model`` (``examples/train_functional.py``) splits
each encoder conv's channels: part goes down through pooling, part comes
back as a skip that the upsampling path concatenates in.
:class:`SliceChannels` is the reference's ``slice_layer``;
:class:`SkipTower` is the whole model, with the JAX package's module names
(``CyclicConv2D_0..``, ``UpConv2D_0/1``, ``ConvLSTM2D_0``), so its flax
tree maps one to one onto the port's parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dlwp_torch.models.layers import (
    ConvLSTM2D,
    CyclicConv2D,
    SplitConvPool2D,
    UpConv2D,
)
from dlwp_torch.ops.pooling import max_pool2d, upsample2d


class SliceChannels(nn.Module):
    """``x[..., start:stop, ...]`` along ``axis`` (the reference's
    ``slice_layer``)."""

    def __init__(self, start, stop, axis=-3):
        super().__init__()
        self.start, self.stop, self.axis = start, stop, axis

    def forward(self, x):
        idx = [slice(None)] * x.dim()
        idx[self.axis] = slice(self.start, self.stop)
        return x[tuple(idx)]


class SkipTower(nn.Module):
    """The reference ``skip_model``: conv(w, d2) -> split w/2 | w/2 (skip1)
    -> pool -> conv(2w) -> split w | w (skip2) -> pool -> conv(4w) -> up ->
    conv(2w) -> concat skip2 -> up -> conv(w, d2) -> concat skip1 ->
    conv(c_out, 5x5), periodic in longitude, ``activation`` on every conv
    but the last.

    Unsharded, the first conv, its split and pool are a
    :class:`SplitConvPool2D` and each upsample + conv an :class:`UpConv2D`.
    With ``spatial`` (a ``SpatialSharding``, which ``build_sequential``
    may also attach) every conv is a plain :class:`CyclicConv2D` on the
    lat-band sharded path, forward only. ``time_steps`` > 0 puts the
    ConvLSTM front end (``lstm_features``, 3x3, dilation 2, every step
    returned, reshaped to a channel stack) in front, for (B, T, C, H, W)
    input; on the card its gate chain is the ``lstm_gates`` kernel."""

    def __init__(self, c_out, width=32, time_steps=0, lstm_features=8,
                 activation="tanh", spatial=None):
        super().__init__()
        self.c_out, self.width = c_out, width
        self.time_steps, self.lstm_features = time_steps, lstm_features
        self.activation = activation
        self.spatial = spatial

    @property
    def spatial(self):
        return self._spatial

    @spatial.setter
    def spatial(self, sp):
        """Setting the sharding builds the branch it takes (the JAX module
        chooses it at call time; here the modules hold the parameters)."""
        self._spatial = sp
        w, act = self.width, self.activation
        for name in list(self._modules):
            delattr(self, name)
        if self.time_steps:
            self.ConvLSTM2D_0 = ConvLSTM2D(self.lstm_features, 3, dilation=2,
                                           return_sequences=True, spatial=sp)
        if sp is None:
            self.CyclicConv2D_0 = SplitConvPool2D(w, w // 2, 3, dilation=2,
                                                  activation=act)
        else:
            self.CyclicConv2D_0 = CyclicConv2D(w, 3, dilation=2,
                                               activation=act, spatial=sp)
        self.CyclicConv2D_1 = CyclicConv2D(2 * w, 3, activation=act,
                                           spatial=sp)
        self.CyclicConv2D_2 = CyclicConv2D(4 * w, 3, activation=act,
                                           spatial=sp)
        if sp is None:
            self.UpConv2D_0 = UpConv2D(2 * w, 3, activation=act)
            self.UpConv2D_1 = UpConv2D(w, 3, dilation=2, activation=act)
            self.CyclicConv2D_3 = CyclicConv2D(self.c_out, 5)
        else:
            self.CyclicConv2D_3 = CyclicConv2D(2 * w, 3, activation=act,
                                               spatial=sp)
            self.CyclicConv2D_4 = CyclicConv2D(w, 3, dilation=2,
                                               activation=act, spatial=sp)
            self.CyclicConv2D_5 = CyclicConv2D(self.c_out, 5, spatial=sp)

    def forward(self, x):
        w = self.width
        if self.time_steps:
            B, T, _, H, W = x.shape
            x = self.ConvLSTM2D_0(x).reshape(B, T * self.lstm_features, H, W)
        if self.spatial is None:
            x, skip1 = self.CyclicConv2D_0(x)
        else:
            x = self.CyclicConv2D_0(x)
            x, skip1 = max_pool2d(x[:, :w // 2], (2, 2)), x[:, w // 2:]
        x = self.CyclicConv2D_1(x)
        x, skip2 = max_pool2d(x[:, :w], (2, 2)), x[:, w:]
        x = self.CyclicConv2D_2(x)
        if self.spatial is None:
            x = self.UpConv2D_0(x)
            x = self.UpConv2D_1(torch.cat([x, skip2], dim=-3))
            last = self.CyclicConv2D_3
        else:
            x = self.CyclicConv2D_3(upsample2d(x, (2, 2)))
            x = torch.cat([x, skip2], dim=-3)
            x = self.CyclicConv2D_4(upsample2d(x, (2, 2)))
            last = self.CyclicConv2D_5
        return last(torch.cat([x, skip1], dim=-3))


__all__ = ["SkipTower", "SliceChannels"]

"""The flagship model specs (own copy of ``__graft_entry__._flagship``).

The canonical DLWP CNN of the reference (examples/train.py:142-221): a
ConvLSTM2D front end over (B, T, C+1, H, W) input -- 4*(C+1) filters,
dilation 2, every step returned -- reshaped to a channel stack, then the
32-64-128-64-32 conv-pool-upsample tower ending in a 5x5 conv to
time_dim*C channels, reshaped to (B, T, C, H, W). The +1 channel is
insolation.
"""

from __future__ import annotations


def tower_specs(c_out: int) -> list:
    """The conv-pool-upsample tower."""
    return [
        ("CyclicConv2D", (32, 3), {"dilation": 2, "activation": "tanh"}),
        ("MaxPooling2D", (2,), None),
        ("CyclicConv2D", (64, 3), {"activation": "tanh"}),
        ("MaxPooling2D", (2,), None),
        ("CyclicConv2D", (128, 3), {"activation": "tanh"}),
        ("UpSampling2D", (2,), None),
        ("CyclicConv2D", (64, 3), {"activation": "tanh"}),
        ("UpSampling2D", (2,), None),
        ("CyclicConv2D", (32, 3), {"dilation": 2, "activation": "tanh"}),
        ("CyclicConv2D", (c_out, 5), {"activation": "linear"}),
    ]


def convlstm_specs(nlat: int = 36, nlon: int = 144, c: int = 2,
                   time_dim: int = 2) -> list:
    """ConvLSTM front end + tower, input (B, time_dim, c+1, nlat, nlon)."""
    lstm_features = 4 * (c + 1)
    return [
        ("ConvLSTM2D", (lstm_features, 3),
         {"dilation": 2, "return_sequences": True, "activation": "tanh"}),
        ("Reshape", ((time_dim * lstm_features, nlat, nlon),), None),
        *tower_specs(time_dim * c),
        ("Reshape", ((time_dim, c, nlat, nlon),), None),
    ]

"""Frozen counts of the cube models, from a configuration's shapes (never
from a kernel): the ``cube_pad`` launches of one U-Net step and their
bytes.

A pad reads its input once, (6, B, C, n, n), and writes the padded field
once, (6, B, C, n + 2p, n + 2p), in float32; the index table (a few KB,
cached) is not counted.
"""

from __future__ import annotations

from h100bench import specs

F32 = 4


def pad_launches(cfg: dict) -> list[tuple[int, int]]:
    """(channels, face size) of the input of each ``cube_pad`` launch of
    one model step: one before every 3 x 3 cube conv."""
    return [(s.in_shape[0], s.in_shape[-1]) for s in specs.walk(cfg)
            if s.kind.startswith("CubeSphereConv2D") and s.args[1] == 3]


def pad_bytes(channels: int, n: int, pad: int, batch: int) -> int:
    """Bytes of one ``cube_pad`` launch over ``batch`` samples: the faces
    read, the padded faces written."""
    m = n + 2 * pad
    return F32 * 6 * batch * channels * (n * n + m * m)

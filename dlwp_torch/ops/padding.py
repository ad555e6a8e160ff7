"""Spherical padding on the trailing (lat, lon) axes.

Port of ``dlwp_tpu.ops.padding.pad_latlon``: longitude wraps around,
latitude is padded in 'zero', 'edge', 'reflect' or 'symmetric' mode (the
numpy ``pad`` modes of the same names). Padding amounts are
``(top, bottom)`` and ``(left, right)``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

LAT_MODES = ("zero", "edge", "reflect", "symmetric")


def _lat_rows(H: int, top: int, bottom: int, mode: str) -> np.ndarray:
    """Source row of every padded row for the non-constant modes."""
    i = np.arange(-top, H + bottom)
    if mode == "edge":
        return np.clip(i, 0, H - 1)
    if mode == "reflect":
        i = np.where(i < 0, -i, i)
        return np.where(i >= H, 2 * (H - 1) - i, i)
    # symmetric: the edge row is repeated
    i = np.where(i < 0, -i - 1, i)
    return np.where(i >= H, 2 * H - 1 - i, i)


@lru_cache(maxsize=256)
def _gather_index(n: int, lo: int, hi: int, mode: str,
                  device: torch.device) -> torch.Tensor:
    """Source index of every padded position along one axis, cached per
    device: building it anew would copy host memory to the card, which
    synchronises the stream, on every call."""
    idx = (np.arange(-lo, n + hi) % n if mode == "wrap"
           else _lat_rows(n, lo, hi, mode))
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.from_numpy(idx).to(device)


def pad_latlon(x: torch.Tensor, lat_padding, lon_padding,
               lat_mode: str = "zero") -> torch.Tensor:
    """Periodic in longitude, ``lat_mode`` at the latitude boundaries."""
    top, bottom = lat_padding
    left, right = lon_padding
    if left or right:
        x = x.index_select(
            -1, _gather_index(x.shape[-1], left, right, "wrap", x.device))
    if (top, bottom) == (0, 0):
        return x
    if lat_mode == "zero":
        return F.pad(x, (0, 0, top, bottom))
    if lat_mode not in LAT_MODES:
        raise ValueError(f"unknown lat_mode {lat_mode!r}")
    return x.index_select(
        -2, _gather_index(x.shape[-2], top, bottom, lat_mode, x.device))

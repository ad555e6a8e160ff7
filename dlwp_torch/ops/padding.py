"""Spherical padding on the trailing (lat, lon) axes.

Port of ``dlwp_tpu.ops.padding``:

- :func:`pad_periodic` (wraparound, numpy ``wrap``), :func:`pad_fill`
  (edge replication, ``edge``), :func:`pad_constant` and
  :func:`pad_reflect` (``reflect``, or ``symmetric``, which repeats the
  edge row where ``reflect`` does not; ``torch.nn.functional.pad`` has no
  such mode) on the two trailing axes of a tensor of any rank. Amounts
  follow the Keras convention ``((top, bottom), (left, right))``, a pair
  ``(rows, cols)`` or one int for all four sides.
- :func:`pad_latlon`: periodic in longitude, latitude padded in 'zero',
  'edge', 'reflect' or 'symmetric' mode.
- :func:`pad_trailing`: any of these modes on any number of trailing axes
  (the padding layers of :mod:`dlwp_torch.models.cnn`).

The index-based modes gather through a per-device cached index of source
rows or columns, which follows numpy for any amount (a pad wider than the
axis wraps or reflects again).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dlwp_torch.device import tensor_cache

LAT_MODES = ("zero", "edge", "reflect", "symmetric")


def _source_index(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    """Source position of every padded position along an axis of ``n``
    for numpy's ``wrap``, ``edge``, ``reflect`` and ``symmetric`` modes."""
    i = np.arange(-lo, n + hi)
    if mode == "wrap":
        return i % n
    if mode == "edge":
        return np.clip(i, 0, n - 1)
    if mode == "reflect":
        if n == 1:
            return np.zeros_like(i)
        i = i % (2 * (n - 1))
        return np.where(i >= n, 2 * (n - 1) - i, i)
    if mode == "symmetric":
        i = i % (2 * n)
        return np.where(i >= n, 2 * n - 1 - i, i)
    raise ValueError(f"unknown padding mode {mode!r}")


@tensor_cache(maxsize=256)
def _gather_index(n: int, lo: int, hi: int, mode: str,
                  device: torch.device) -> torch.Tensor:
    """:func:`_source_index` as a tensor, cached per device, so a call
    copies nothing from the host; the one copy does not wait for the
    stream (a train step reads nothing back, its first included)."""
    idx = _source_index(n, lo, hi, mode)
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.from_numpy(idx).to(device, non_blocking=True)


def _norm_padding(padding) -> tuple[tuple[int, int], tuple[int, int]]:
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    a, b = padding
    if isinstance(a, int):
        return (a, a), (b, b)
    return tuple(a), tuple(b)


def pad_trailing(x: torch.Tensor, amounts, mode: str,
                 value: float = 0.0) -> torch.Tensor:
    """Pad the trailing ``len(amounts)`` axes by ``amounts``, one
    ``(before, after)`` each, in numpy's ``mode``: 'constant' (with
    ``value``), 'wrap', 'edge', 'reflect' or 'symmetric'."""
    amounts = [tuple(a) for a in amounts]
    if mode == "constant":
        return F.pad(x, [v for a in reversed(amounts) for v in a],
                     value=value)
    for axis, (lo, hi) in zip(range(-len(amounts), 0), amounts):
        if lo or hi:
            x = x.index_select(axis, _gather_index(x.shape[axis], lo, hi,
                                                   mode, x.device))
    return x


def _gather_pad(x: torch.Tensor, padding, mode: str) -> torch.Tensor:
    return pad_trailing(x, _norm_padding(padding), mode)


def pad_periodic(x: torch.Tensor, padding=(1, 1)) -> torch.Tensor:
    """Wraparound padding (``PeriodicPadding2D``)."""
    return _gather_pad(x, padding, "wrap")


def pad_fill(x: torch.Tensor, padding=(1, 1)) -> torch.Tensor:
    """Edge-replication padding (``FillPadding2D``)."""
    return _gather_pad(x, padding, "edge")


def pad_constant(x: torch.Tensor, padding=(1, 1),
                 value: float = 0.0) -> torch.Tensor:
    """Constant padding (``TFPadding2D`` CONSTANT, ``ZeroPadding2D``)."""
    return pad_trailing(x, _norm_padding(padding), "constant", value)


def pad_reflect(x: torch.Tensor, padding=(1, 1),
                symmetric: bool = False) -> torch.Tensor:
    """Reflect or symmetric padding (``TFPadding2D`` REFLECT /
    SYMMETRIC)."""
    return _gather_pad(x, padding, "symmetric" if symmetric else "reflect")


def pad_latlon(x: torch.Tensor, lat_padding, lon_padding,
               lat_mode: str = "zero") -> torch.Tensor:
    """Periodic in longitude, ``lat_mode`` at the latitude boundaries."""
    top, bottom = lat_padding
    x = pad_periodic(x, ((0, 0), tuple(lon_padding)))
    if (top, bottom) == (0, 0):
        return x
    if lat_mode == "zero":
        return F.pad(x, (0, 0, top, bottom))
    if lat_mode not in LAT_MODES:
        raise ValueError(f"unknown lat_mode {lat_mode!r}")
    return _gather_pad(x, ((top, bottom), (0, 0)), lat_mode)


__all__ = ["LAT_MODES", "pad_constant", "pad_fill", "pad_latlon",
           "pad_periodic", "pad_reflect", "pad_trailing"]

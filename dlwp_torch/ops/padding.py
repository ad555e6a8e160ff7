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
- :func:`cube_pad_plain`: the cubed sphere's halo (DLWP-CS's
  ``CubeSpherePadding2D``), the plain version of the ``cube_pad`` kernel,
  and :func:`cube_pad_vjp`, its vector-Jacobian product: each halo cell's
  gradient added back to its source cell, as a fixed-order sum of
  gathers (no atomics, so the same on every run and device).

The index-based modes gather through a per-device cached index of source
rows or columns, which follows numpy for any amount (a pad wider than the
axis wraps or reflects again).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dlwp_torch.device import tensor_cache
from dlwp_torch.grid import cubed_sphere

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


def cube_shape(eq: torch.Tensor, pol: torch.Tensor) -> tuple[int, int, int]:
    """(B, C, n) of a cube field held as its equatorial (4B, C, n, n) and
    polar (2B, C, n, n) faces; raises on anything else."""
    if (eq.dim() != 4 or pol.dim() != 4 or eq.shape[0] % 4
            or eq.shape[-1] != eq.shape[-2]
            or tuple(pol.shape) != (eq.shape[0] // 2,) + tuple(eq.shape[1:])):
        raise ValueError(f"cube faces: equatorial {tuple(eq.shape)}, polar "
                         f"{tuple(pol.shape)}")
    return eq.shape[0] // 4, eq.shape[1], eq.shape[-1]


@tensor_cache(maxsize=64)
def _cube_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """:func:`~dlwp_torch.grid.cubed_sphere.pad_table`, flat, int64."""
    idx = cubed_sphere.pad_table(n, pad).reshape(-1).astype(np.int64)
    with torch.inference_mode(False):
        return torch.from_numpy(idx).to(device, non_blocking=True)


@tensor_cache(maxsize=64)
def _cube_transpose(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """:func:`~dlwp_torch.grid.cubed_sphere.pad_transpose` on ``device``."""
    with torch.inference_mode(False):
        return torch.from_numpy(cubed_sphere.pad_transpose(n, pad)).to(
            device, non_blocking=True)


def cube_pad_plain(eq: torch.Tensor, pol: torch.Tensor,
                   pad: int = 1) -> torch.Tensor:
    """The cube's faces padded by ``pad`` from their neighbours: equatorial
    (4B, C, n, n) and polar (2B, C, n, n) faces (row ``f * B + b``, face
    by face; the north face in storage order, rows reversed) -> (6B, C,
    n + 2 pad, n + 2 pad), faces 0-5 in the same order. One gather through
    :func:`~dlwp_torch.grid.cubed_sphere.pad_table`."""
    B, C, n = cube_shape(eq, pol)
    m = n + 2 * pad
    x = torch.cat([eq.reshape(4, B * C, n * n), pol.reshape(2, B * C, n * n)])
    x = x.transpose(0, 1).reshape(B * C, 6 * n * n)
    out = x.index_select(1, _cube_index(n, pad, x.device))
    return out.reshape(B * C, 6, m * m).transpose(0, 1).reshape(6 * B, C, m, m)


def cube_pad_vjp(grad: torch.Tensor, pad: int = 1):
    """The vector-Jacobian product of :func:`cube_pad_plain` for the
    gradient ``grad`` (6B, C, m, m) of its output: the (equatorial, polar)
    faces' gradients, each source cell's sum over the padded cells that
    read it, its own first
    (:func:`~dlwp_torch.grid.cubed_sphere.pad_transpose`)."""
    six_b, C, m, _ = grad.shape
    B, n = six_b // 6, m - 2 * pad
    table = _cube_transpose(n, pad, grad.device)
    g = grad.reshape(6, B * C, m * m).transpose(0, 1).reshape(B * C, 6 * m * m)
    g = torch.cat([g, g.new_zeros(B * C, 1)], dim=1)
    acc = g.index_select(1, table[0])
    for k in range(1, table.shape[0]):
        acc = acc + g.index_select(1, table[k])
    acc = acc.reshape(B * C, 6, n * n).transpose(0, 1).reshape(6 * B, C, n, n)
    return acc[:4 * B], acc[4 * B:]


__all__ = ["LAT_MODES", "cube_pad_plain", "cube_pad_vjp", "cube_shape",
           "pad_constant",
           "pad_fill", "pad_latlon", "pad_periodic", "pad_reflect",
           "pad_trailing"]

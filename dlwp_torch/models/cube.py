"""The cubed-sphere U-Net of DLWP-CS (Weyn, Durran & Caruana 2020,
doi:10.1029/2020MS002109; github.com/jweyn/DLWP-CS).

Fields live on the six faces of a gnomonic cubed sphere
(:mod:`dlwp_torch.grid.cubed_sphere`). Outside the model a field is
``(B, C, 6 n, n)``, the faces stacked along the rows in face order, as
the samplers and the estimator carry it. Inside, it is a pair of faces
(:func:`to_faces`): the equatorial faces ``(4B, C, n, n)`` and the polar
faces ``(2B, C, n, n)``, face by face (row ``f * B + b``), the north face
in storage order (rows reversed, pole-aligned). Each group is then one
contiguous batch for its own conv kernel.

- :class:`CubeSpherePadding2D`: every face's halo from its neighbours,
  in one ``cube_pad`` kernel on the card (:mod:`dlwp_torch.kernels.cube_pad`);
  the padded field comes back as the pair of its two groups' views.
- :class:`CubeSphereConv2D`: DLWP-CS's defaults (``flip_north_pole=True``,
  ``independent_north_south=False``): one kernel and bias shared by the
  four equatorial faces, a second pair by the two polar faces. Storing the
  north face flipped is the polar flip: its conv is the flipped north
  face's conv, flipped back.
- :class:`CubeAveragePooling2D`, :class:`CubeUpSampling2D`: 2 x 2
  average pooling and nearest 2 x upsampling within each face.
- :class:`CubeUNet`: two 3 x 3 convs per level at ``filters`` (32, 64,
  128), pooling down, upsampling and skip concatenations up, a linear
  1 x 1 conv to ``c_out`` channels; leaky ReLU of slope
  :data:`LEAKY_SLOPE` after every other conv. Its convs are
  ``CubeSphereConv2D_0`` .. ``_10`` in the order of the forward pass.
  Each sub-layer's call is a span ``layer.<class name>``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dlwp_torch.grid.cubed_sphere import NORTH, SOUTH
from dlwp_torch.kernels.cube_pad import cube_pad
from dlwp_torch.models.layers import (ParamLayer, _glorot, _zeros,
                                      get_activation, pair)
from dlwp_torch.ops.pooling import avg_pool2d, upsample2d
from dlwp_torch.utils.profiling import span

# The leaky ReLU's negative slope in the cube models (an assumption: the
# paper names the activation, not its slope).
LEAKY_SLOPE = 0.1


def to_faces(x: torch.Tensor):
    """``(B, C, 6 n, n)`` (faces stacked along the rows) -> the pair
    (equatorial ``(4B, C, n, n)``, polar ``(2B, C, n, n)``), the north
    face's rows reversed."""
    B, C, rows, n = x.shape
    if rows != 6 * n:
        raise ValueError(f"a cube field has 6 n x n rows x columns, got "
                         f"{rows} x {n}")
    x = x.reshape(B, C, 6, n, n)
    eq = x[:, :, :4].permute(2, 0, 1, 3, 4).reshape(4 * B, C, n, n)
    pol = torch.stack([x[:, :, NORTH].flip(-2), x[:, :, SOUTH]])
    return eq, pol.reshape(2 * B, C, n, n)


def from_faces(faces) -> torch.Tensor:
    """The inverse of :func:`to_faces`."""
    eq, pol = faces
    B, C, n = eq.shape[0] // 4, eq.shape[1], eq.shape[-1]
    p = pol.reshape(2, B, C, n, n)
    x = torch.cat([eq.reshape(4, B, C, n, n), p[:1].flip(-2), p[1:]])
    return x.permute(1, 2, 0, 3, 4).reshape(B, C, 6 * n, n)


class CubeSpherePadding2D(nn.Module):
    """Pads each face by ``padding`` cells from its neighbours: a pair of
    faces -> the pair of the padded field's two groups (views of one
    ``(6B, C, n + 2p, n + 2p)`` tensor)."""

    def __init__(self, padding=1):
        super().__init__()
        self.padding = int(padding)

    def forward(self, faces):
        eq, pol = faces
        x = cube_pad(eq.contiguous(), pol.contiguous(), self.padding)
        return x[:eq.shape[0]], x[eq.shape[0]:]


class CubeSphereConv2D(ParamLayer):
    """A VALID conv of each face group with its own kernel and bias
    (``equatorial_kernel`` / ``_bias``, ``polar_kernel`` / ``_bias``; OIHW),
    then the activation (``leaky_relu``: slope :data:`LEAKY_SLOPE`). Pad
    the faces first for a 'same' conv (:class:`CubeSpherePadding2D`)."""

    def __init__(self, features, kernel_size=3, activation="linear"):
        super().__init__()
        self.features = features
        self.kernel_size = pair(kernel_size)
        self.activation = activation
        for name in self.param_names():
            self.register_parameter(name, None)

    def param_shapes(self, c_in):
        shapes = {}
        for group in ("equatorial", "polar"):
            shapes[f"{group}_kernel"] = (self.features, c_in) + self.kernel_size
            shapes[f"{group}_bias"] = (self.features,)
        return shapes

    def flax_dims(self, shapes):
        return shapes["equatorial_kernel"][1]

    def _initializer(self, name):
        return _zeros if name.endswith("bias") else _glorot

    def _act(self, y):
        if self.activation == "leaky_relu":
            return F.leaky_relu(y, LEAKY_SLOPE, inplace=True)
        return get_activation(self.activation)(y)

    def forward(self, faces):
        eq, pol = faces
        self._require_built(eq)
        out = []
        for group, x in (("equatorial", eq), ("polar", pol)):
            y = F.conv2d(x, getattr(self, f"{group}_kernel"),
                         getattr(self, f"{group}_bias"))
            out.append(self._act(y))
        return tuple(out)


class CubeAveragePooling2D(nn.Module):
    """2 x 2 (``window``) average pooling inside each face."""

    def __init__(self, window=2):
        super().__init__()
        self.window = pair(window)

    def forward(self, faces):
        return tuple(avg_pool2d(x, self.window) for x in faces)


class CubeUpSampling2D(nn.Module):
    """Nearest 2 x (``factor``) upsampling inside each face."""

    def __init__(self, factor=2):
        super().__init__()
        self.factor = pair(factor)

    def forward(self, faces):
        return tuple(upsample2d(x, self.factor) for x in faces)


def _call(layer, *args):
    with span(f"layer.{type(layer).__name__}"):
        return layer(*args)


class CubeUNet(nn.Module):
    """DLWP-CS's U-Net on the cube: ``(B, C_in, 6 n, n) -> (B, c_out, 6 n,
    n)``, ``n`` divisible by 4::

        e1 = C(f0, C(f0, x))            C: pad 1, 3 x 3 cube conv, act
        e2 = C(f1, C(f1, pool(e1)))
        b  = C(f1, C(f2, pool(e2)))     the f2 -> f1 bottleneck
        d2 = C(f0, C(f1, cat(up(b), e2)))
        d1 = C(f0, C(f0, cat(up(d2), e1)))
        y  = 1 x 1 cube conv to c_out, linear
    """

    def __init__(self, c_out, filters=(32, 64, 128)):
        super().__init__()
        self.c_out = c_out
        self.filters = tuple(filters)
        f0, f1, f2 = self.filters
        widths = (f0, f0, f1, f1, f2, f1, f1, f0, f0, f0)
        for k, w in enumerate(widths):
            setattr(self, f"CubeSphereConv2D_{k}",
                    CubeSphereConv2D(w, 3, "leaky_relu"))
        self.CubeSphereConv2D_10 = CubeSphereConv2D(c_out, 1)
        self.pad = CubeSpherePadding2D(1)
        self.pool = CubeAveragePooling2D(2)
        self.up = CubeUpSampling2D(2)

    def _conv(self, k, faces):
        return _call(getattr(self, f"CubeSphereConv2D_{k}"),
                     _call(self.pad, faces))

    @staticmethod
    def _cat(a, b):
        return tuple(torch.cat([x, y], dim=1) for x, y in zip(a, b))

    def forward(self, x):
        h = to_faces(x)
        e1 = self._conv(1, self._conv(0, h))
        e2 = self._conv(3, self._conv(2, _call(self.pool, e1)))
        b = self._conv(5, self._conv(4, _call(self.pool, e2)))
        d2 = self._conv(7, self._conv(6, self._cat(_call(self.up, b), e2)))
        d1 = self._conv(9, self._conv(8, self._cat(_call(self.up, d2), e1)))
        return from_faces(_call(self.CubeSphereConv2D_10, d1))


__all__ = [
    "CubeAveragePooling2D",
    "CubeSphereConv2D",
    "CubeSpherePadding2D",
    "CubeUNet",
    "CubeUpSampling2D",
    "LEAKY_SLOPE",
    "from_faces",
    "to_faces",
]

r"""Spherical (S2 / SO(3)) convolution layers, spectral-native (port of
``dlwp_tpu.models.spherical``).

The reference's spherical CNN (``examples/train_torch.py:100-114``) stacks
s2cnn ``S2Convolution(nfeature_in, nfeature_out, b_in, b_out, grid)``
layers with ``mean_gamma=True``: the SO(3) cross-correlation averaged over
the third Euler angle, so features stay on the sphere. For that average
only the filter's zonal coefficients survive,

    \widehat{avg_gamma(f \star h)}^l_m = \hat f^l_m \cdot \overline{\hat h^l_0},

so a bank of C_in x C_out filters is a real weight ``W[l, c_in, c_out]``
applied per spectral degree: harmonic analysis on the input grid, a
per-degree channel mix, harmonic synthesis onto the output bandwidth's
(2 b_out, 2 b_out) grid (or the input grid with ``keep_shape=True``).
Rotation equivariance holds by construction.

As in the JAX package the layer computes in float32 whatever its input's
dtype: the engines are float32 (``fourier="matmul"``, built once per grid,
truncation and device and cached), ``spectral_kernel`` and ``bias`` are
float32 parameters, and the output is cast back to the input's dtype. The
complex-by-real channel mix is two real products over the stacked real and
imaginary parts, in full fp32 (TF32 is off on the card,
:mod:`dlwp_torch.device`).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from dlwp_torch.device import tensor_cache
from dlwp_torch.grid.latlon import LatLonGrid
from dlwp_torch.models.layers import ParamLayer, _zeros, get_activation
from dlwp_torch.spectral.transforms import SphericalHarmonics


@tensor_cache(maxsize=16)
def _engine(nlat: int, nlon: int, truncation: int,
            device: torch.device) -> SphericalHarmonics:
    """The float32 ``fourier='matmul'`` engine of the pole-inclusive
    equiangular grid, one per (grid, truncation, device): the float64 host
    build (its ``pinv`` above all) is the costly part, so layers share
    engines, no forward builds one twice, and a card's engine is the CPU
    engine's tables moved there."""
    if device.type != "cpu":
        return _engine(nlat, nlon, truncation, torch.device("cpu")).to(device)
    return SphericalHarmonics.build(LatLonGrid.regular(nlat, nlon),
                                    truncation=truncation, fourier="matmul",
                                    dtype=torch.float32, device=device)


def _max_truncation(nlat: int, nlon: int) -> int:
    return min(nlat - 1, nlon // 2)


def _normal(std):
    def init(shape, gen, dtype, device):
        t = torch.randn(shape, generator=gen, dtype=torch.float64) * std
        return t.to(dtype=dtype, device=device)

    return init


class S2Convolution(ParamLayer):
    """Spherical convolution, gamma-averaged s2cnn semantics.

    Positional ``(nfeature_in, nfeature_out, b_in, b_out, grid)`` as in the
    reference spec tuples. ``b_in``: analysis keeps degrees l < b_in,
    clamped (with a warning) to what the input grid supports; ``b_out``:
    the output carries degrees l < min(b_in, b_out) on a (2 b_out, 2 b_out)
    grid, or the input grid with ``keep_shape``. ``grid`` (s2cnn's kernel
    sampling grid) is accepted and ignored: the filters are spectral.
    ``mean_gamma=False`` (SO(3)-resident features) is refused, as in JAX.

    Parameters: ``spectral_kernel`` (n_deg, C_in, C_out), initialised
    normal with std 1/sqrt(C_in), and ``bias`` (C_out,), float32. The
    degree count depends on the input grid, so :meth:`in_channels` is
    (C, nlat, nlon).
    """

    param_dtype = torch.float32

    def __init__(self, nfeature_in, nfeature_out, b_in, b_out, grid=None,
                 mean_gamma=True, activation=None, use_bias=True,
                 keep_shape=False):
        super().__init__()
        self.nfeature_in = int(nfeature_in)
        self.nfeature_out = int(nfeature_out)
        self.b_in, self.b_out = int(b_in), int(b_out)
        self.grid = grid
        self.mean_gamma = mean_gamma
        self.activation = activation
        self.use_bias = use_bias
        self.keep_shape = keep_shape
        self.register_parameter("spectral_kernel", None)
        self.register_parameter("bias", None)

    # ------------------------------------------------------------ shapes
    def _degrees(self, nlat: int, nlon: int, warn: bool = False):
        """(t_in, n_deg, out grid, t_out) for an input grid."""
        t_in = min(self.b_in - 1, _max_truncation(nlat, nlon))
        if warn and t_in < self.b_in - 1:
            warnings.warn(
                f"S2Convolution: requested b_in={self.b_in} exceeds what the "
                f"{nlat}x{nlon} input grid supports; clamping to "
                f"truncation {t_in} (degrees l <= {t_in}). Model capacity "
                f"is reduced accordingly.", stacklevel=3)
        n_deg = min(t_in, self.b_out - 1) + 1
        out = (nlat, nlon) if self.keep_shape else (2 * self.b_out,) * 2
        t_out = min(n_deg - 1, _max_truncation(*out))
        return t_in, n_deg, out, t_out

    def param_names(self):
        return ("spectral_kernel", "bias") if self.use_bias else (
            "spectral_kernel",)

    def in_channels(self, x):
        return tuple(x.shape[-3:])

    def flax_dims(self, shapes):
        """(C_in, n_deg) of a flax ``spectral_kernel``: the grid is not in
        the leaves, its degree count is."""
        k = shapes.get("spectral_kernel")
        return (k[1], k[0]) if k is not None and len(k) == 3 else (-1, -1)

    def param_shapes(self, dims):
        """``dims``: (C, nlat, nlon) of an input, or (C, n_deg) from
        :meth:`flax_dims`."""
        c_in = dims[0]
        n_deg = dims[1] if len(dims) == 2 else self._degrees(*dims[1:])[1]
        shapes = {"spectral_kernel": (n_deg, c_in, self.nfeature_out)}
        if self.use_bias:
            shapes["bias"] = (self.nfeature_out,)
        return shapes

    def _initializer(self, name):
        if name == "bias":
            return _zeros
        return _normal(1.0 / math.sqrt(self.nfeature_in))

    # ----------------------------------------------------------- forward
    def forward(self, x):
        if not self.mean_gamma:
            raise NotImplementedError(
                "S2Convolution supports mean_gamma=True only (features "
                "resident on S^2, the reference configuration -- "
                "train_torch.py:104); SO(3)-resident features are out of "
                "scope, as in the JAX package")
        if x.shape[-3] != self.nfeature_in:
            raise ValueError(
                f"S2Convolution: input has {x.shape[-3]} channels, spec says "
                f"nfeature_in={self.nfeature_in}")
        nlat, nlon = x.shape[-2], x.shape[-1]
        t_in, n_deg, out, t_out = self._degrees(nlat, nlon, warn=True)
        self._require_built(x)
        if self.spectral_kernel.shape[0] != n_deg:
            raise ValueError(
                f"S2Convolution: spectral_kernel holds "
                f"{self.spectral_kernel.shape[0]} degrees, the {nlat}x{nlon} "
                f"input needs {n_deg}")
        ana = _engine(nlat, nlon, t_in, x.device)
        syn = _engine(out[0], out[1], t_out, x.device)
        spec = ana.analyze(x)[..., :t_out + 1, :t_out + 1]  # (..., i, m, n)
        wk = self.spectral_kernel[:t_out + 1].to(torch.float32)
        # Per-degree channel mix (degree n is the last spectral axis) as
        # one real product over the stacked (Re, Im) parts.
        ri = torch.einsum("z...imn,nio->z...omn",
                          torch.stack([spec.real, spec.imag]), wk)
        y = syn.synthesize(torch.complex(ri[0], ri[1])).to(x.dtype)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)[:, None, None]
        return get_activation(self.activation)(y)


class SO3Convolution(S2Convolution):
    """SO(3) correlation layer, gamma-averaged: with features resident on
    S^2 its surviving part is the same per-degree channel mix as
    :class:`S2Convolution` (as in the JAX package)."""


def s2_near_identity_grid(max_beta: float = np.pi / 16, n_alpha: int = 8,
                          n_beta: int = 3) -> tuple:
    """s2cnn's kernel-sampling grid constructor, for specs that pass one
    (the layers ignore it): the (beta, alpha) tuple pairs."""
    beta = np.arange(1, n_beta + 1) * max_beta / n_beta
    alpha = np.linspace(0, 2 * np.pi, n_alpha, endpoint=False)
    b, a = np.meshgrid(beta, alpha, indexing="ij")
    return tuple(zip(b.flatten().tolist(), a.flatten().tolist()))

"""Convolutions with spherical boundaries.

Port of ``dlwp_tpu.ops.conv``:

- :func:`cyclic_conv2d`: ``F.conv2d`` (VALID) on the input wrap-padded in
  longitude and padded in latitude per ``lat_mode``. NCHW data, OIHW
  weights, any number of leading batch dims.
- :func:`conv_after_upsample2`: ``cyclic_conv2d(upsample2d(a), kernel)``
  without building the upsampled grid. Dilation 2 is an exact upsample of
  a dilation-1 conv on the small grid; dilation 1 folds the kernel into
  four parity kernels run as one 4*O-channel small-grid conv and
  interleaved (the JAX package's 'parity4' form; its 'lhsdil' form is the
  same algebra).

On the card these run through cuDNN with TF32 off (set by
:func:`dlwp_torch.device.resolve_device`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from dlwp_torch.ops.padding import pad_latlon
from dlwp_torch.ops.pooling import upsample2d


def cyclic_conv2d(x: torch.Tensor, kernel: torch.Tensor, strides=(1, 1),
                  lat_mode: str = "zero", dilation=(1, 1)) -> torch.Tensor:
    """2-D convolution, periodic in longitude; output (..., O, H', W)."""
    kh, kw = kernel.shape[-2:]
    eh = (kh - 1) * dilation[0]
    ew = (kw - 1) * dilation[1]
    x = pad_latlon(x, (eh // 2, eh - eh // 2), (ew // 2, ew - ew // 2),
                   lat_mode=lat_mode)
    lead = x.shape[:-3]
    y = F.conv2d(x.reshape((-1,) + x.shape[-3:]), kernel,
                 stride=tuple(strides), dilation=tuple(dilation))
    return y.reshape(lead + y.shape[1:])


@lru_cache(maxsize=32)
def _fold_matrix(k: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(2, 3, k) 0/1 map [parity, small-grid tap, tap], cached per device."""
    c = (k - 1) // 2
    fold = np.zeros((2, 3, k))
    for p in (0, 1):
        for a in range(-c, c + 1):
            fold[p, (p + a) // 2 + 1, a + c] = 1.0
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.as_tensor(fold, dtype=dtype).to(device)


def _parity_kernels(kernel: torch.Tensor) -> torch.Tensor:
    """(O, C, k, k), odd k <= 5 -> (4*O, C, 3, 3): tap a (centred) of output
    parity p lands on small-grid tap floor((p + a) / 2)."""
    O, C, k, _ = kernel.shape
    fold = _fold_matrix(k, kernel.dtype, kernel.device)
    ks = torch.einsum("pja,qkb,ocab->pqocjk", fold, fold, kernel)
    return ks.reshape(4 * O, C, 3, 3)


def conv_after_upsample2(a: torch.Tensor, kernel: torch.Tensor,
                         dilation=(1, 1)) -> torch.Tensor:
    """``cyclic_conv2d(upsample2d(a, 2), kernel, dilation)``, zero latitude
    boundary, stride 1, computed on the small grid where exact."""
    O, C, kh, kw = kernel.shape
    dil = tuple(dilation)
    if dil == (2, 2):
        return upsample2d(cyclic_conv2d(a, kernel), (2, 2))
    if dil != (1, 1) or kh != kw or kh % 2 == 0 or kh > 5:
        return cyclic_conv2d(upsample2d(a, (2, 2)), kernel, dilation=dil)
    out = cyclic_conv2d(a, _parity_kernels(kernel))
    H, W = a.shape[-2:]
    lead = out.shape[:-3]
    n = len(lead)
    # (..., pr, pc, o, r, u) -> (..., o, r, pr, u, pc)
    v = out.reshape(lead + (2, 2, O, H, W))
    v = v.permute(*range(n), n + 2, n + 3, n, n + 4, n + 1)
    return v.reshape(lead + (O, 2 * H, 2 * W))

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
- :func:`cyclic_conv2d_edgefix`: ``cyclic_conv2d`` (zero latitude, stride
  1) as a zero-padded conv whose wrap-affected edge columns are
  recomputed from slim wrapped slices and written in.
- :func:`conv_pool2_even_dilation`: ``max_pool2d(cyclic_conv2d(x, k,
  d), 2)`` for even dilations on the four quarter-grid parity planes,
  stacked on channels: one grouped conv, or one dense conv with a
  block-diagonal kernel.
- :func:`row_conv2d`: a latitude-dependent convolution, a filter bank per
  output row, as one einsum over shifted patches.

On the card these run through cuDNN with TF32 off (set by
:func:`dlwp_torch.device.resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dlwp_torch.device import tensor_cache
from dlwp_torch.ops.padding import pad_constant, pad_latlon
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


@tensor_cache(maxsize=32)
def _fold_matrix(k: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(2, 3, k) 0/1 map [parity, small-grid tap, tap], cached per device."""
    c = (k - 1) // 2
    fold = np.zeros((2, 3, k))
    for p in (0, 1):
        for a in range(-c, c + 1):
            fold[p, (p + a) // 2 + 1, a + c] = 1.0
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.as_tensor(fold, dtype=dtype).to(device, non_blocking=True)


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


def cyclic_conv2d_edgefix(x: torch.Tensor, kernel: torch.Tensor,
                          dilation=(1, 1)) -> torch.Tensor:
    """``cyclic_conv2d(x, kernel, dilation=dilation)`` with a zero latitude
    boundary at stride 1, without the wrap-padded copy of ``x``: the conv
    runs on the zero-padded input and the ``ew / 2`` columns at each edge,
    which the wrap reaches, are recomputed from wrapped slices of a few
    columns and put in their place."""
    kh, kw = kernel.shape[-2:]
    dil = tuple(dilation)
    eh, ew = (kh - 1) * dil[0], (kw - 1) * dil[1]
    pt, pb = eh // 2, eh - eh // 2
    pl, pr = ew // 2, ew - ew // 2
    lead = x.shape[:-3]
    x4 = x.reshape((-1,) + x.shape[-3:])
    W = x4.shape[-1]

    def conv(v, lon):
        return F.conv2d(F.pad(v, lon + (pt, pb)), kernel, dilation=dil)

    y = conv(x4, (pl, pr))
    if ew:
        parts = [y[..., pl:W - pr]]
        if pl:
            parts.insert(0, conv(torch.cat(
                [x4[..., W - pl:], x4[..., :pl + pr]], -1), (0, 0)))
        if pr:
            parts.append(conv(torch.cat(
                [x4[..., W - pr - pl:], x4[..., :pr]], -1), (0, 0)))
        y = torch.cat(parts, -1)
    return y.reshape(lead + y.shape[1:])


def conv_pool2_even_dilation(x: torch.Tensor, kernel: torch.Tensor,
                             dilation=(2, 2),
                             form: str = "group") -> torch.Tensor:
    """``max_pool2d(cyclic_conv2d(x, kernel, dilation), 2)`` for even
    dilations: the output at (2r + a, 2u + b) reads only inputs of parity
    (a, b), so the pool is a max over four quarter-grid convs at half the
    dilation. The planes are stacked on channels in (a, b) order and run
    as one conv: ``form='group'`` (4 groups, the kernel tiled) or
    ``'dense'`` (4C -> 4O, a block-diagonal kernel). The max is over the
    raw conv outputs, so a bias and a nondecreasing activation applied
    after it give ``pool(act(conv + bias))`` exactly.

    x: (..., C, H, W) with even H and W; kernel (O, C, kh, kw).
    Returns (..., O, H/2, W/2)."""
    O, C, kh, kw = kernel.shape
    half = (dilation[0] // 2, dilation[1] // 2)
    lead = x.shape[:-3]
    n = len(lead)
    H, W = x.shape[-2:]
    v = x.reshape(lead + (C, H // 2, 2, W // 2, 2))
    # (..., C, h, a, w, b) -> (..., a, b, C, h, w)
    v = v.permute(*range(n), n + 2, n + 4, n, n + 1, n + 3)
    xs = v.reshape(lead + (4 * C, H // 2, W // 2))
    eh, ew = (kh - 1) * half[0], (kw - 1) * half[1]
    xp = pad_latlon(xs, (eh // 2, eh - eh // 2), (ew // 2, ew - ew // 2))
    x4 = xp.reshape((-1,) + xp.shape[-3:])
    if form == "dense":
        kb = kernel.new_zeros((4 * O, 4 * C, kh, kw))
        for p in range(4):
            kb[p * O:(p + 1) * O, p * C:(p + 1) * C] = kernel
        o = F.conv2d(x4, kb, dilation=half)
    elif form == "group":
        o = F.conv2d(x4, kernel.repeat(4, 1, 1, 1), dilation=half, groups=4)
    else:
        raise ValueError(f"form must be 'group' or 'dense', got {form!r}")
    o = o.reshape(lead + (4, O) + o.shape[-2:])
    return o.amax(dim=n)


def row_conv2d(x: torch.Tensor, weights: torch.Tensor,
               bias: torch.Tensor | None = None, lat_mode: str = "zero",
               lon_periodic: bool = True) -> torch.Tensor:
    """Latitude-dependent convolution (``RowConnected2D``): output row h
    has its own filters ``weights[h]`` (bank (H, C_out, C_in, kh, kw)),
    shared along longitude; stride 1, same size. ``bias``: (H, C_out), one
    per output row. Longitude wraps unless ``lon_periodic`` is off (then
    every side is zero-padded).

    x: (..., C_in, H, W) -> (..., C_out, H, W): the kh*kw shifted views
    of the padded input stacked and contracted with the bank in one
    einsum ``hoki,...kihw->...ohw``."""
    H, C_out, C_in, kh, kw = weights.shape
    if x.shape[-2] != H or x.shape[-3] != C_in:
        raise ValueError(f"row_conv2d: input {tuple(x.shape)} for a bank "
                         f"{tuple(weights.shape)}")
    pt, pb = (kh - 1) // 2, (kh - 1) - (kh - 1) // 2
    pl, pr = (kw - 1) // 2, (kw - 1) - (kw - 1) // 2
    if lon_periodic:
        xp = pad_latlon(x, (pt, pb), (pl, pr), lat_mode=lat_mode)
    else:
        xp = pad_constant(x, ((pt, pb), (pl, pr)))
    W = x.shape[-1]
    p = torch.stack([xp[..., i:i + H, j:j + W]
                     for i in range(kh) for j in range(kw)], dim=-4)
    wflat = weights.permute(0, 1, 3, 4, 2).reshape(H, C_out, kh * kw, C_in)
    out = torch.einsum("hoki,...kihw->...ohw", wflat, p)
    if bias is not None:
        out = out + bias.T[:, :, None]
    return out

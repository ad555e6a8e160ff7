"""Latitude-band halo exchange and domain-decomposed stencils (port of
``dlwp_tpu.parallel.halo``).

The global (lat, lon) grid is split into latitude bands over the ``lat``
mesh axis; a convolution needs ``halo`` rows from each neighbouring band.
Longitude stays whole within a shard, so its periodic wrap is a local pad.
North of the first band and south of the last the rows are zero, the
reference's ZeroPadding latitude treatment.

This is the portable path (``impl='ppermute'`` in
:class:`~dlwp_torch.parallel.spatial.SpatialSharding`): plain PyTorch, the
neighbour rows copied with ``Tensor.to``, as the JAX one is plain XLA
collectives. It is also the conv oracle of the kernel paths' tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlwp_torch.kernels.halo_exchange import halo_rows_plain
from dlwp_torch.ops.padding import pad_latlon
from dlwp_torch.parallel.mesh import Mesh, join_shards, split_shards

_LON_TODO = ("longitude sharding is not ported yet (ROADMAP.md section 1, "
             "item 6: halo_exchange_lon / lon_axis)")


def halo_exchange_lat(shards: list[torch.Tensor],
                      halo: tuple[int, int]) -> list[torch.Tensor]:
    """The lat-ordered blocks (..., H, W) of one data row, each extended by
    ``halo = (top, bottom)`` rows: interior halos come from the
    neighbouring blocks, the outer ones are zero. The same function as the
    halo kernel's plain version."""
    return halo_rows_plain(shards, halo)


def halo_exchange_lon(*args, **kwargs):
    raise NotImplementedError(_LON_TODO)


def _valid_conv(x: torch.Tensor, kernel: torch.Tensor,
                dilation=(1, 1)) -> torch.Tensor:
    lead = x.shape[:-3]
    out = F.conv2d(x.reshape((-1,) + x.shape[-3:]), kernel,
                   dilation=tuple(dilation))
    return out.reshape(lead + out.shape[1:])


def _local_cyclic_conv(shards: list[torch.Tensor], kernel: torch.Tensor,
                       halo: tuple[int, int],
                       dilation=(1, 1)) -> list[torch.Tensor]:
    """Per-shard stencil of one data row: lat halo exchange, longitude
    wrap, VALID conv."""
    ew = (kernel.shape[-1] - 1) * dilation[1]
    return [
        _valid_conv(pad_latlon(x, (0, 0), (ew // 2, ew - ew // 2)),
                    kernel.to(x.device), dilation)
        for x in halo_exchange_lat(shards, halo)
    ]


def sharded_cyclic_conv2d(x: torch.Tensor, kernel: torch.Tensor, mesh: Mesh,
                          dilation=(1, 1), data_axis: str | None = "data",
                          lat_axis_name: str = "lat",
                          lon_axis_name: str | None = None) -> torch.Tensor:
    """``cyclic_conv2d(x, kernel, dilation=dilation)`` with zero latitude
    boundaries, computed on the lat-band shards of ``mesh``; ``x`` is the
    global (B, ..., C, H, W) tensor and so is the result."""
    if lon_axis_name is not None:
        raise NotImplementedError(_LON_TODO)
    eh = (kernel.shape[-2] - 1) * dilation[0]
    halo = (eh // 2, eh - eh // 2)
    shards = split_shards(x, mesh, data_axis, lat_axis_name)
    return join_shards(
        [_local_cyclic_conv(row, kernel, halo, dilation) for row in shards],
        x.device)

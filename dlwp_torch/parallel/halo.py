"""Latitude-band halo exchange and domain-decomposed stencils (port of
``dlwp_tpu.parallel.halo``).

The global (lat, lon) grid is split into latitude bands over the ``lat``
mesh axis; a convolution needs ``halo`` rows from each neighbouring band.
North of the first band and south of the last the rows are zero, the
reference's ZeroPadding latitude treatment. Longitude stays whole within a
shard, so its periodic wrap is a local pad, unless a ``lon`` mesh axis cuts
it into tiles: then the wrap is a cyclic ring (:func:`halo_exchange_lon`),
the last tile being the western neighbour of the first.

This is the portable path (``impl='ppermute'`` in
:class:`~dlwp_torch.parallel.spatial.SpatialSharding`): plain PyTorch, the
neighbour rows and columns copied with ``Tensor.to``, as the JAX one is
plain XLA collectives. It is also the conv oracle of the kernel paths'
tests, and the backward of the kernel paths recomputes through it.

On a mesh whose lat axis spans processes a band's neighbour may belong
to another process (a :class:`~dlwp_torch.parallel.mesh.Remote` entry):
its edge rows then come with ``torch.distributed`` point-to-point
messages (:func:`~dlwp_torch.parallel.distributed.exchange_edges`), the
port of JAX's cross-host ``ppermute``. That path computes forward only:
its gradient would need the exchange's transpose, which is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlwp_torch.kernels.halo_exchange import halo_rows_plain
from dlwp_torch.ops.padding import pad_latlon
from dlwp_torch.parallel.distributed import exchange_edges
from dlwp_torch.parallel.mesh import (
    Mesh,
    Remote,
    join_shards,
    join_tiles,
    split_shards,
    split_tiles,
)


def halo_exchange_lat(shards: list[torch.Tensor],
                      halo: tuple[int, int]) -> list[torch.Tensor]:
    """The lat-ordered blocks (..., H, W) of one data row, each extended by
    ``halo = (top, bottom)`` rows: interior halos come from the
    neighbouring blocks, the outer ones are zero. The same function as the
    halo kernel's plain version; :class:`~dlwp_torch.parallel.mesh.Remote`
    blocks (another process's) stay as they are, and a neighbour there
    sends its rows."""
    remote = [isinstance(s, Remote) for s in shards]
    if not any(remote):
        return halo_rows_plain(shards, halo)
    if all(remote):
        return list(shards)
    top, bot = halo
    edges = exchange_edges(shards, halo)
    like = shards[remote.index(False)]

    def stub(j):
        # Remote band j as its neighbours here read it: its first ``bot``
        # rows (band j - 1's south halo) over its last ``top`` rows (band
        # j + 1's north halo), zeros where no band here reads them.
        zeros = like.new_zeros(like.shape[:-2] + (top + bot, like.shape[-1]))
        return torch.cat([edges.get((j - 1, "south"), zeros[..., :bot, :]),
                          edges.get((j + 1, "north"), zeros[..., bot:, :])],
                         dim=-2)

    padded = halo_rows_plain(
        [stub(j) if r else s for j, (s, r) in enumerate(zip(shards, remote))],
        halo)
    return [s if r else p for s, p, r in zip(shards, padded, remote)]


def halo_exchange_lon(tiles: list[torch.Tensor],
                      halo: tuple[int, int]) -> list[torch.Tensor]:
    """The lon-ordered tiles (..., H, W) of one lat band, each extended by
    ``halo = (left, right)`` columns from its neighbours on a cyclic ring:
    tile ``o`` takes the last ``left`` columns of tile ``o - 1`` and the
    first ``right`` of tile ``o + 1``, modulo the tile count, so one tile
    wraps onto itself (the local periodic pad)."""
    remote = [isinstance(t, Remote) for t in tiles]
    if all(remote):
        return list(tiles)
    if any(remote):
        raise NotImplementedError(
            "halo_exchange_lon: a lon axis across processes is not ported; "
            "keep lon on each process's own devices")
    left, right = halo
    n = len(tiles)
    out = []
    for o, x in enumerate(tiles):
        parts = []
        if left > 0:
            west = tiles[(o - 1) % n]
            parts.append(west[..., west.shape[-1] - left:].to(x.device))
        parts.append(x)
        if right > 0:
            parts.append(tiles[(o + 1) % n][..., :right].to(x.device))
        out.append(torch.cat(parts, dim=-1))
    return out


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
        x if isinstance(x, Remote) else
        _valid_conv(pad_latlon(x, (0, 0), (ew // 2, ew - ew // 2)),
                    kernel.to(x.device), dilation)
        for x in halo_exchange_lat(shards, halo)
    ]


def _local_tile_conv(tiles: list[list[torch.Tensor]], kernel: torch.Tensor,
                     halo: tuple[int, int],
                     dilation=(1, 1)) -> list[list[torch.Tensor]]:
    """Per-tile stencil of one data row, ``tiles[l][o]``: the lat exchange
    of each lon column, then the lon ring of each row-extended band (so
    the corner cells come along), then a VALID conv."""
    ew = (kernel.shape[-1] - 1) * dilation[1]
    cols = [halo_exchange_lat([band[o] for band in tiles], halo)
            for o in range(len(tiles[0]))]
    return [
        [t if isinstance(t, Remote) else
         _valid_conv(t, kernel.to(t.device), dilation)
         for t in halo_exchange_lon([col[l] for col in cols],
                                    (ew // 2, ew - ew // 2))]
        for l in range(len(tiles))
    ]


def sharded_cyclic_conv2d(x: torch.Tensor, kernel: torch.Tensor, mesh: Mesh,
                          dilation=(1, 1), data_axis: str | None = "data",
                          lat_axis_name: str = "lat",
                          lon_axis_name: str | None = None) -> torch.Tensor:
    """``cyclic_conv2d(x, kernel, dilation=dilation)`` with zero latitude
    boundaries, computed on the lat-band shards of ``mesh``, or on its lat
    x lon tiles when ``lon_axis_name`` names a mesh axis; ``x`` is the
    global (B, ..., C, H, W) tensor and so is the result. On a mesh over
    several processes each computes its own blocks and gets the whole
    result; where the lat axis spans processes, forward only."""
    if (mesh.spans_processes(lat_axis_name) and torch.is_grad_enabled()
            and (x.requires_grad or kernel.requires_grad)):
        raise NotImplementedError(
            "sharded_cyclic_conv2d: the gradient of a conv whose lat axis "
            "spans processes is not ported; train with the data axis "
            "across processes and lat within each")
    eh = (kernel.shape[-2] - 1) * dilation[0]
    halo = (eh // 2, eh - eh // 2)
    if lon_axis_name is not None:
        tiles = split_tiles(x, mesh, data_axis, lat_axis_name, lon_axis_name)
        return join_tiles(
            [_local_tile_conv(row, kernel, halo, dilation) for row in tiles],
            x.device)
    shards = split_shards(x, mesh, data_axis, lat_axis_name)
    return join_shards(
        [_local_cyclic_conv(row, kernel, halo, dilation) for row in shards],
        x.device)

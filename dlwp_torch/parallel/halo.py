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

On a mesh over several processes a block's neighbour may belong to
another process (a :class:`~dlwp_torch.parallel.mesh.Remote` entry), along
the lat axis or around the lon ring: its edge rows or columns then come
with ``torch.distributed`` point-to-point messages
(:func:`~dlwp_torch.parallel.distributed.exchange_edges`), the port of
JAX's cross-host ``ppermute``. Such a conv differentiates as one autograd
node (:class:`_CrossConv`) whose backward runs the transposes in turn:
the join's is this process's part of the output gradient, the exchanges'
send each received edge's gradient back to its sender
(:func:`~dlwp_torch.parallel.distributed.return_edges`), the conv
kernel's gradient is summed over the processes' blocks, and the split's
gathers the input gradient, so that every process holds the gradient of
the one-process conv. One node a conv, whatever the process holds, keeps
every process's graph the same, so their backward passes meet in each
collective in the same order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlwp_torch.parallel.distributed import (
    all_reduce_sum,
    exchange_edges,
    process_group,
    return_edges,
)
from dlwp_torch.parallel.mesh import (
    Mesh,
    Remote,
    join_tiles,
    split_tiles,
)


def _neighbours(i: int, n: int, cyclic: bool) -> tuple:
    """The previous and next block of block ``i`` of a line of ``n``
    (None past the ends of a line that is not cyclic)."""
    prev = i - 1 if i > 0 else (n - 1 if cyclic else None)
    nxt = i + 1 if i < n - 1 else (0 if cyclic else None)
    return prev, nxt


def _pad_line(blocks: list, halo: tuple[int, int], dim: int, cyclic: bool,
              tag: int) -> list:
    """Each block here of a line extended along ``dim`` by ``halo =
    (before, after)``: the previous block's last ``before`` and the next
    block's first ``after`` (zeros past the ends of a line that is not
    cyclic); a ``Remote`` block stays, and a neighbour there sends its
    edge (messages under tags from ``tag``)."""
    remote = [isinstance(b, Remote) for b in blocks]
    if all(remote):
        return list(blocks)
    top, bot = halo
    edges = (exchange_edges(blocks, halo, dim=dim, cyclic=cyclic, tag=tag)
             if any(remote) else {})
    n, out = len(blocks), []
    for i, x in enumerate(blocks):
        if remote[i]:
            out.append(x)
            continue
        prev, nxt = _neighbours(i, n, cyclic)
        parts = []

        def part(j, rows, key, first):
            if j is None:
                shape = list(x.shape)
                shape[dim] = rows
                return x.new_zeros(shape)
            if remote[j]:
                return edges[(i, key)]
            b = blocks[j]
            at = 0 if first else b.shape[dim] - rows
            return b.narrow(dim, at, rows).to(x.device)

        if top > 0:
            parts.append(part(prev, top, "north", False))
        parts.append(x)
        if bot > 0:
            parts.append(part(nxt, bot, "south", True))
        out.append(torch.cat(parts, dim=dim))
    return out


def _pad_line_transpose(blocks: list, halo: tuple[int, int], grads: list,
                        dim: int, cyclic: bool, tag: int) -> list:
    """The transpose of :func:`_pad_line`: from the gradients of the
    padded blocks here (``grads``, None where ``Remote``), the gradients
    of the blocks here. Each halo's gradient goes to the block it came
    from: added in place here, sent back to another process
    (:func:`~dlwp_torch.parallel.distributed.return_edges`), or dropped
    where the halo was zeros."""
    remote = [isinstance(b, Remote) for b in blocks]
    top, bot = halo
    n = len(blocks)
    out = [None if r else g.narrow(dim, top, b.shape[dim]).clone()
           for b, g, r in zip(blocks, grads, remote)]
    back = {}
    for i, g in enumerate(grads):
        if remote[i]:
            continue
        prev, nxt = _neighbours(i, n, cyclic)
        size = blocks[i].shape[dim]
        if top > 0 and prev is not None:
            gt = g.narrow(dim, 0, top)
            if remote[prev]:
                back[(i, "north")] = gt
            else:
                at = blocks[prev].shape[dim] - top
                out[prev].narrow(dim, at, top).add_(gt.to(out[prev].device))
        if bot > 0 and nxt is not None:
            gb = g.narrow(dim, top + size, bot)
            if remote[nxt]:
                back[(i, "south")] = gb
            else:
                out[nxt].narrow(dim, 0, bot).add_(gb.to(out[nxt].device))
    if any(remote) and not all(remote):
        got = return_edges(blocks, halo, back, dim=dim, cyclic=cyclic,
                           tag=tag)
        for (i, side), g in got.items():
            size = blocks[i].shape[dim]
            at = size - top if side == "last" else 0
            out[i].narrow(dim, at, g.shape[dim]).add_(g)
    return out


def halo_exchange_lat(shards: list[torch.Tensor], halo: tuple[int, int],
                      tag: int = 0) -> list[torch.Tensor]:
    """The lat-ordered blocks (..., H, W) of one data row, each extended by
    ``halo = (top, bottom)`` rows: interior halos come from the
    neighbouring blocks, the outer ones are zero. The same function as the
    halo kernel's plain version; :class:`~dlwp_torch.parallel.mesh.Remote`
    blocks (another process's) stay as they are, and a neighbour there
    sends its rows (messages under tags from ``tag``)."""
    return _pad_line(shards, halo, -2, False, tag)


def halo_exchange_lon(tiles: list[torch.Tensor], halo: tuple[int, int],
                      tag: int = 0) -> list[torch.Tensor]:
    """The lon-ordered tiles (..., H, W) of one lat band, each extended by
    ``halo = (left, right)`` columns from its neighbours on a cyclic ring:
    tile ``o`` takes the last ``left`` columns of tile ``o - 1`` and the
    first ``right`` of tile ``o + 1``, modulo the tile count, so one tile
    wraps onto itself (the local periodic pad). A tile on another process
    sends its columns (messages under tags from ``tag``)."""
    return _pad_line(tiles, halo, -1, True, tag)


def _valid_conv(x: torch.Tensor, kernel: torch.Tensor,
                dilation=(1, 1)) -> torch.Tensor:
    lead = x.shape[:-3]
    out = F.conv2d(x.reshape((-1,) + x.shape[-3:]), kernel,
                   dilation=tuple(dilation))
    return out.reshape(lead + out.shape[1:])


def _halos(kernel: torch.Tensor, dilation) -> tuple[tuple, tuple]:
    """The (top, bottom) rows and (left, right) columns a conv needs."""
    eh = (kernel.shape[-2] - 1) * dilation[0]
    ew = (kernel.shape[-1] - 1) * dilation[1]
    return (eh // 2, eh - eh // 2), (ew // 2, ew - ew // 2)


def _line_tags(tiles) -> tuple:
    """Tag bases of the lat lines (per data row and lon column) and the lon
    rings (per data row and lat band), two tags a boundary, all distinct."""
    n_data, n_lat, n_lon = len(tiles), len(tiles[0]), len(tiles[0][0])
    lat_span = 2 * n_lat
    lon_base = lat_span * n_data * n_lon

    def lat(d, o):
        return lat_span * (d * n_lon + o)

    def lon(d, l):
        return lon_base + 2 * n_lon * (d * n_lat + l)

    return lat, lon


def _pad_tiles(tiles, halo_lat, halo_lon) -> tuple[list, list]:
    """``tiles[d][l][o]`` padded: the lat exchange of each lon column
    (rows), then the lon ring of each row-extended band (so the corner
    cells come along). Returns the row-extended and the padded tiles."""
    lat_tag, lon_tag = _line_tags(tiles)
    n_lat, n_lon = len(tiles[0]), len(tiles[0][0])
    rows, padded = [], []
    for d, row in enumerate(tiles):
        cols = [_pad_line([row[l][o] for l in range(n_lat)], halo_lat, -2,
                          False, lat_tag(d, o)) for o in range(n_lon)]
        ext = [[cols[o][l] for o in range(n_lon)] for l in range(n_lat)]
        rows.append(ext)
        padded.append([_pad_line(ext[l], halo_lon, -1, True, lon_tag(d, l))
                       for l in range(n_lat)])
    return rows, padded


def _tile_convs(padded, kernel, dilation):
    return [[[t if isinstance(t, Remote) else
              _valid_conv(t, kernel.to(t.device), dilation) for t in band]
             for band in row] for row in padded]


class _CrossConv(torch.autograd.Function):
    """The sharded conv on a mesh over several processes, one autograd
    node (see the module notes). The forward splits the global input into
    the process's tiles, pads them (messages for the edges on other
    processes), convolves and joins; the backward takes this process's
    tiles of the output gradient, convolves back to the padded tiles and
    the kernel, returns the halos' gradients through the lon ring and then
    the lat lines (:func:`_pad_line_transpose`), sums the kernel's
    gradient over the mesh's processes and gathers the input's."""

    @staticmethod
    def forward(ctx, x, kernel, mesh, dilation, data_axis, lat_axis,
                lon_axis):
        halo_lat, halo_lon = _halos(kernel, dilation)
        tiles = split_tiles(x, mesh, data_axis, lat_axis, lon_axis)
        rows, padded = _pad_tiles(tiles, halo_lat, halo_lon)
        ctx.args = (mesh, dilation, data_axis, lat_axis, lon_axis)
        ctx.layout = (tiles, rows, padded, halo_lat, halo_lon)
        ctx.save_for_backward(kernel)
        ctx.device = x.device
        return join_tiles(_tile_convs(padded, kernel, dilation), x.device)

    @staticmethod
    def backward(ctx, grad_out):
        (kernel,) = ctx.saved_tensors
        mesh, dilation, data_axis, lat_axis, lon_axis = ctx.args
        tiles, rows, padded, halo_lat, halo_lon = ctx.layout
        need_x, need_k = ctx.needs_input_grad[:2]
        g_out = split_tiles(grad_out, mesh, data_axis, lat_axis, lon_axis)
        g_pad = [[[None] * len(band) for band in row] for row in padded]
        g_k = []
        for d, row in enumerate(padded):
            for l, band in enumerate(row):
                for o, p in enumerate(band):
                    if isinstance(p, Remote):
                        continue
                    with torch.enable_grad():
                        p_ = p.detach().requires_grad_(need_x)
                        k_ = kernel.detach().to(p.device).requires_grad_(
                            need_k)
                        y = _valid_conv(p_, k_, dilation)
                        got = torch.autograd.grad(
                            y, [t for t, n in ((p_, need_x), (k_, need_k))
                                if n], g_out[d][l][o].to(y.dtype))
                    if need_x:
                        g_pad[d][l][o] = got[0]
                    if need_k:
                        g_k.append(got[-1].to(kernel.device))
        grad_k = None
        if need_k:
            grad_k = torch.stack(g_k).sum(0) if g_k else torch.zeros_like(
                kernel)
            owners = {int(r) for r in mesh.ranks.flat}
            (grad_k,) = all_reduce_sum([grad_k], process_group(owners))
        grad_x = None
        if need_x:
            lat_tag, lon_tag = _line_tags(tiles)
            n_lat, n_lon = len(tiles[0]), len(tiles[0][0])
            g_tiles = []
            for d in range(len(tiles)):
                g_rows = [_pad_line_transpose(rows[d][l], halo_lon,
                                              g_pad[d][l], -1, True,
                                              lon_tag(d, l))
                          for l in range(n_lat)]
                cols = [_pad_line_transpose(
                    [tiles[d][l][o] for l in range(n_lat)], halo_lat,
                    [g_rows[l][o] for l in range(n_lat)], -2, False,
                    lat_tag(d, o)) for o in range(n_lon)]
                g_tiles.append([[tiles[d][l][o] if isinstance(
                    tiles[d][l][o], Remote) else cols[o][l]
                    for o in range(n_lon)] for l in range(n_lat)])
            grad_x = join_tiles(g_tiles, ctx.device)
        return grad_x, grad_k, None, None, None, None, None


def sharded_cyclic_conv2d(x: torch.Tensor, kernel: torch.Tensor, mesh: Mesh,
                          dilation=(1, 1), data_axis: str | None = "data",
                          lat_axis_name: str = "lat",
                          lon_axis_name: str | None = None) -> torch.Tensor:
    """``cyclic_conv2d(x, kernel, dilation=dilation)`` with zero latitude
    boundaries, computed on the lat-band shards of ``mesh``, or on its lat
    x lon tiles when ``lon_axis_name`` names a mesh axis; ``x`` is the
    global (B, ..., C, H, W) tensor and so is the result. On a mesh over
    several processes each computes its own blocks and gets the whole
    result, and the gradient of every input is the one-process conv's on
    every process (:class:`_CrossConv`)."""
    dilation = tuple(dilation)
    if mesh.ranks is not None:
        return _CrossConv.apply(x, kernel, mesh, dilation, data_axis,
                                lat_axis_name, lon_axis_name)
    halo_lat, halo_lon = _halos(kernel, dilation)
    tiles = split_tiles(x, mesh, data_axis, lat_axis_name, lon_axis_name)
    return join_tiles(
        _tile_convs(_pad_tiles(tiles, halo_lat, halo_lon)[1], kernel,
                    dilation), x.device)

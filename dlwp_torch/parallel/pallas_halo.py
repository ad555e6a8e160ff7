"""Lat-band halo exchange through the ``halo_exchange`` kernel (port of
``dlwp_tpu.parallel.pallas_halo``).

The public functions take the global (B, ..., H, W) activation, as the JAX
ones do under ``shard_map``, cut it into the mesh's shards, run the kernel
(its plain version on the CPU) and return the global result. The kernel
returns the padded blocks with zero outer halos directly; the JAX wrapper's
one-row over-exchange and crop for a 0-sided halo is a Mosaic workaround
and has no counterpart.

On a mesh over several processes each computes the data rows it holds
and the join gathers the rest; a lat axis across processes is refused
(:func:`local_rows`).
"""

from __future__ import annotations

import torch

from dlwp_torch.kernels.halo_exchange import halo_exchange
from dlwp_torch.ops.padding import pad_latlon
from dlwp_torch.parallel.halo import _valid_conv
from dlwp_torch.parallel.mesh import Mesh, Remote, join_shards, split_shards


def local_rows(shards, mesh: Mesh, lat_axis_name: str, fn, name: str):
    """``fn`` (a kernel over ``shards[d][l]``) on the data rows this
    process holds; the other rows stay :class:`Remote` for the join.
    Raises where the lat axis spans processes: a kernel cannot read
    another process's bands yet (CUDA IPC, ROADMAP.md section 1, item
    6f)."""
    if mesh.spans_processes(lat_axis_name):
        raise NotImplementedError(
            f"{name}: the lat axis spans processes, and a kernel cannot "
            "read another process's bands yet (CUDA IPC, ROADMAP.md "
            "section 1, item 6f); use impl 'ppermute' or keep lat within "
            "each process")
    mine = [not isinstance(row[0], Remote) for row in shards]
    done = iter(fn([r for r, m in zip(shards, mine) if m]) if any(mine)
                else ())
    return [next(done) if m else row for row, m in zip(shards, mine)]


def pallas_halo_exchange_lat(x: torch.Tensor, halo: tuple[int, int],
                             mesh: Mesh, data_axis: str | None = None,
                             lat_axis_name: str = "lat") -> torch.Tensor:
    """Every lat band of ``x`` extended by ``halo = (top, bottom)`` rows
    (neighbour rows inside, zeros outside), the padded bands joined along
    latitude: (B, ..., n_lat * (top + H / n_lat + bottom), W), as the JAX
    function's global output under ``shard_map``."""
    shards = split_shards(x, mesh, data_axis, lat_axis_name)
    return join_shards(
        local_rows(shards, mesh, lat_axis_name,
                   lambda s: halo_exchange(s, halo), "pallas_halo"),
        x.device)


def pallas_sharded_cyclic_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                                 mesh: Mesh, data_axis: str | None = "data",
                                 lat_axis_name: str = "lat",
                                 dilation=(1, 1)) -> torch.Tensor:
    """``cyclic_conv2d(x, kernel, dilation=dilation)`` with zero latitude
    boundaries: per shard the halo kernel, the longitude wrap, and a VALID
    ``F.conv2d`` (cuDNN on the card, TF32 off), as the JAX package leaves
    the local conv to ``lax.conv``."""
    eh = (kernel.shape[-2] - 1) * dilation[0]
    ew = (kernel.shape[-1] - 1) * dilation[1]
    shards = split_shards(x, mesh, data_axis, lat_axis_name)

    def conv(rows):
        return [[_valid_conv(pad_latlon(p, (0, 0), (ew // 2, ew - ew // 2)),
                             kernel.to(p.device), dilation) for p in row]
                for row in halo_exchange(rows, (eh // 2, eh - eh // 2))]

    return join_shards(
        local_rows(shards, mesh, lat_axis_name, conv, "pallas"), x.device)

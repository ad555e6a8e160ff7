"""Device meshes and lat-band shards (port of ``dlwp_tpu.parallel.mesh``).

A :class:`Mesh` is an ndarray of ``torch.device`` with axis names, the
standard layout being 2-D ``(data, lat)``: batch parallelism over ``data``
and latitude-band spatial decomposition over ``lat``; a ``lon`` axis makes
it 3-D ``(data, lat, lon)``, lat x lon tiles. One program drives the whole
mesh, as one JAX program drives a ``jax.sharding.Mesh``: the sharded
functions take the global activation, cut it into one block per mesh entry
with :func:`split_shards` (lat bands, ``shards[d][l]``, the kernels'
layout) or :func:`split_tiles` (tiles, ``tiles[d][l][o]``), work on the
blocks and join the results with :func:`join_shards` / :func:`join_tiles`.

Entries may repeat one device: ``build_mesh(MeshConfig(data=1, lat=2),
devices=[cuda0] * 2)`` gives two lat bands on one card, each in its own
allocation. This is the counterpart of the virtual CPU devices
(``--xla_force_host_platform_device_count``) the JAX package tests its
meshes on; ``devices=[torch.device("cpu")] * n`` is the same on the CPU.

The JAX module's ``*_sharding`` helpers have no counterpart: where the JAX
package passes a ``PartitionSpec``, the port passes a plain tuple of axis
names such as ``("data", None, "lat", None)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dlwp_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh description; an axis size of -1 means "use all
    remaining devices"."""

    data: int = -1
    lat: int = 1
    lon: int = 1

    def resolve(self, n_devices: int | None = None) -> tuple[int, int, int]:
        n = n_devices or torch.cuda.device_count()
        sizes = [self.data, self.lat, self.lon]
        if sizes.count(-1) > 1:
            raise ValueError("only one axis may be -1")
        if -1 in sizes:
            known = 1
            for v in sizes:
                if v != -1:
                    known *= v
            sizes[sizes.index(-1)] = n // known
        d, l, lo = sizes
        if d * l * lo != n:
            raise ValueError(f"mesh {d}x{l}x{lo} does not match {n} devices")
        return d, l, lo


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An ndarray of ``torch.device`` whose axes carry names."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device_at(self, **index: int) -> torch.device:
        """The device at the named axis indices (0 on the others)."""
        return self.devices[tuple(index.get(a, 0) for a in self.axis_names)]


def build_mesh(config: MeshConfig | None = None, devices=None,
               axis_names: tuple[str, ...] | None = None) -> Mesh:
    """A (data, lat) mesh -- or (data, lat, lon) when ``config.lon`` is set
    -- over ``devices`` (default: every CUDA device; raises without a
    card). Devices may repeat."""
    config = config or MeshConfig()
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    d, l, lo = config.resolve(len(devices))
    if axis_names is None:
        axis_names = ("data", "lat", "lon") if lo > 1 else ("data", "lat")
    if len(axis_names) == 2 and lo > 1:
        raise ValueError("config.lon > 1 requires 3 axis names")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape((d, l, lo) if len(axis_names) == 3 else (d, l)),
                tuple(axis_names))


def axis_size(mesh: Mesh, axis: str | None) -> int:
    return 1 if axis is None else mesh.shape[axis]


def split_tiles(x: torch.Tensor, mesh: Mesh, data_axis: str | None,
                lat_axis: str,
                lon_axis: str | None = None) -> list[list[list[torch.Tensor]]]:
    """Cut a global (B, ..., H, W) activation into ``tiles[d][l][o]``:
    batch block ``d`` of the ``data_axis`` (the whole batch when it is
    None), latitude band ``l`` of ``lat_axis`` and longitude tile ``o`` of
    ``lon_axis`` (the whole width when it is None), each a contiguous
    tensor on its mesh device."""
    n_data, n_lat = axis_size(mesh, data_axis), mesh.shape[lat_axis]
    n_lon = axis_size(mesh, lon_axis)
    B, H, W = x.shape[0], x.shape[-2], x.shape[-1]
    if B % n_data or H % n_lat or W % n_lon:
        raise ValueError(f"shape {tuple(x.shape)} does not divide over "
                         f"{n_data} data x {n_lat} lat x {n_lon} lon shards")
    b, h, w = B // n_data, H // n_lat, W // n_lon

    def tile(d, l, o):
        idx = {lat_axis: l}
        if data_axis is not None:
            idx[data_axis] = d
        if lon_axis is not None:
            idx[lon_axis] = o
        block = x[d * b:(d + 1) * b, ..., l * h:(l + 1) * h, o * w:(o + 1) * w]
        return block.to(mesh.device_at(**idx)).contiguous()

    return [[[tile(d, l, o) for o in range(n_lon)] for l in range(n_lat)]
            for d in range(n_data)]


def split_shards(x: torch.Tensor, mesh: Mesh, data_axis: str | None,
                 lat_axis: str) -> list[list[torch.Tensor]]:
    """Cut a global (B, ..., H, W) activation into ``shards[d][l]``: the
    lat-band form of :func:`split_tiles` (longitude whole), the layout the
    kernel wrappers take."""
    return [[lon[0] for lon in row]
            for row in split_tiles(x, mesh, data_axis, lat_axis)]


def join_shards(shards: list[list[torch.Tensor]],
                device: torch.device) -> torch.Tensor:
    """The global tensor on ``device`` from ``shards[d][l]``."""
    return torch.cat([torch.cat([s.to(device) for s in row], dim=-2)
                      for row in shards], dim=0)


def join_tiles(tiles: list[list[list[torch.Tensor]]],
               device: torch.device) -> torch.Tensor:
    """The global tensor on ``device`` from ``tiles[d][l][o]``."""
    return join_shards([[torch.cat([t.to(device) for t in lon], dim=-1)
                         for lon in row] for row in tiles], device)

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

Where the JAX package passes a ``PartitionSpec``, the port passes a plain
tuple of axis names such as ``("data", None, "lat", None)``; the JAX
module's ``*_sharding`` helpers return the ``(Mesh, axis names)`` pair
that :class:`~dlwp_torch.data.device_sampler.DeviceSeriesSampler` takes
as ``sharding=`` (:func:`batch_sharding`, :func:`space_sharding`,
:func:`batch_space_sharding`).

A mesh may span processes (:func:`dlwp_torch.parallel.distributed.
multihost_mesh`): ``Mesh.ranks`` then names the process that owns each
entry. Every process runs the same program on the same global input, as
the JAX worker builds its arrays with ``make_array_from_callback``:
:func:`split_tiles` builds only the process's own blocks and puts a
:class:`Remote` marker in place of the others, and :func:`join_tiles` /
:func:`join_shards` gather the remote blocks from their owners, as
``process_allgather`` does, so every process ends with the global result.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

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


class Remote(NamedTuple):
    """The place of a block that process ``rank`` holds."""
    rank: int


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An ndarray of ``torch.device`` whose axes carry names; for a mesh
    over several processes, ``ranks`` (the devices' shape) names the
    process that owns each entry and ``process_index`` is this process
    (``ranks`` None: every entry is this process's)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    ranks: np.ndarray | None = None
    process_index: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def index(self, **index: int) -> tuple[int, ...]:
        """The entry at the named axis indices (0 on the others)."""
        return tuple(index.get(a, 0) for a in self.axis_names)

    def device_at(self, **index: int) -> torch.device:
        """The device at the named axis indices (0 on the others)."""
        return self.devices[self.index(**index)]

    def owner(self, **index: int) -> int:
        """The process that owns the entry at the named axis indices."""
        return (self.process_index if self.ranks is None
                else int(self.ranks[self.index(**index)]))

    def local_devices(self) -> list[torch.device]:
        """This process's entries' devices, in mesh order."""
        flat = list(self.devices.flat)
        if self.ranks is None:
            return flat
        return [d for d, r in zip(flat, self.ranks.flat)
                if r == self.process_index]

    def spans_processes(self, axis: str | None) -> bool:
        """Whether entries along ``axis`` belong to different processes."""
        if self.ranks is None or axis is None:
            return False
        k = self.axis_names.index(axis)
        return bool((self.ranks != self.ranks.take([0], axis=k)).any())

    def line(self, axis: str) -> list[int]:
        """The processes along ``axis`` through this process's first
        entry (the ranks that share its place on the other axes)."""
        k = self.axis_names.index(axis)
        at = list(np.argwhere(self.ranks == self.process_index)[0])
        at[k] = slice(None)
        return [int(r) for r in self.ranks[tuple(at)]]

    def plane(self, axis: str | None) -> list[int]:
        """The processes that share this process's index along ``axis``
        (every process of the mesh for None), sorted."""
        if axis is None:
            return sorted({int(r) for r in self.ranks.flat})
        k = self.axis_names.index(axis)
        i = int(np.argwhere(self.ranks == self.process_index)[0][k])
        return sorted({int(r) for r in self.ranks.take([i], axis=k).flat})

    def process_rows(self, axis: str) -> tuple[int, int]:
        """``(start, stop)``: the contiguous indices along ``axis`` at
        which this process owns entries."""
        k = self.axis_names.index(axis)
        mine = self.ranks == self.process_index
        rows = [i for i in range(self.devices.shape[k])
                if mine.take([i], axis=k).any()]
        if not rows or rows != list(range(rows[0], rows[-1] + 1)):
            raise ValueError(f"process {self.process_index} owns no "
                             f"contiguous run of {axis!r} indices: {rows}")
        return rows[0], rows[-1] + 1

    def process_local(self, axis: str) -> "Mesh":
        """The sub-mesh of the ``axis`` indices this process owns entries
        at (the mesh itself where ``axis`` does not span processes):
        where the batch is sharded across processes, each process holds
        its own block of it and cuts that over this sub-mesh."""
        if not self.spans_processes(axis):
            return self
        start, stop = self.process_rows(axis)
        k = self.axis_names.index(axis)
        take = np.arange(start, stop)
        ranks = self.ranks.take(take, axis=k)
        return Mesh(self.devices.take(take, axis=k), self.axis_names,
                    None if (ranks == self.process_index).all() else ranks,
                    self.process_index)


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


def batch_sharding(mesh: Mesh, extra_dims: int = 3) -> tuple[Mesh, tuple]:
    """A (batch, ...) array's layout: batch over 'data', the rest whole."""
    return mesh, ("data",) + (None,) * extra_dims


def space_sharding(mesh: Mesh, ndim: int,
                   lat_axis: int) -> tuple[Mesh, tuple]:
    """The latitude axis of a rank-``ndim`` array over 'lat' (the others
    whole)."""
    spec = [None] * ndim
    spec[lat_axis] = "lat"
    return mesh, tuple(spec)


def batch_space_sharding(mesh: Mesh, ndim: int,
                         lat_axis: int) -> tuple[Mesh, tuple]:
    """Batch over 'data' and latitude over 'lat' (the dp x sp layout)."""
    spec = [None] * ndim
    spec[0] = "data"
    spec[lat_axis] = "lat"
    return mesh, tuple(spec)


def axis_size(mesh: Mesh, axis: str | None) -> int:
    return 1 if axis is None else mesh.shape[axis]


def split_tiles(x: torch.Tensor, mesh: Mesh, data_axis: str | None,
                lat_axis: str,
                lon_axis: str | None = None) -> list[list[list[torch.Tensor]]]:
    """Cut a global (B, ..., H, W) activation into ``tiles[d][l][o]``:
    batch block ``d`` of the ``data_axis`` (the whole batch when it is
    None), latitude band ``l`` of ``lat_axis`` and longitude tile ``o`` of
    ``lon_axis`` (the whole width when it is None), each a contiguous
    tensor on its mesh device; on a mesh over several processes, a
    :class:`Remote` where another process owns the entry."""
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
        if mesh.ranks is not None and mesh.owner(**idx) != mesh.process_index:
            return Remote(mesh.owner(**idx))
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


def _gather_remote(grid: list) -> list:
    """``grid`` (nested lists of blocks) with every :class:`Remote` entry
    replaced by its owner's block; ``grid`` itself where no entry is
    remote. Every process calls it with the same layout (collective)."""
    flat = []

    def walk(node):
        if isinstance(node, list):
            return [walk(n) for n in node]
        flat.append(node)
        return len(flat) - 1

    layout = walk(grid)
    if not any(isinstance(b, Remote) for b in flat):
        return grid
    # Imported here: the distributed module builds meshes with this one.
    from dlwp_torch.parallel.distributed import (
        broadcast_block,
        process_group,
    )

    like = next((b for b in flat if not isinstance(b, Remote)), None)
    if like is None:
        raise ValueError("this process holds no block of the mesh")
    group = process_group({b.rank for b in flat if isinstance(b, Remote)}
                          | {torch.distributed.get_rank()})
    flat = [broadcast_block(b, like, group) for b in flat]

    def build(node):
        return ([build(n) for n in node] if isinstance(node, list)
                else flat[node])

    return build(layout)


def join_shards(shards: list[list[torch.Tensor]],
                device: torch.device) -> torch.Tensor:
    """The global tensor on ``device`` from ``shards[d][l]``; remote
    shards come from their owners (every process gets the whole)."""
    return torch.cat([torch.cat([s.to(device) for s in row], dim=-2)
                      for row in _gather_remote(shards)], dim=0)


def join_tiles(tiles: list[list[list[torch.Tensor]]],
               device: torch.device) -> torch.Tensor:
    """The global tensor on ``device`` from ``tiles[d][l][o]``; remote
    tiles come from their owners (every process gets the whole)."""
    return join_shards([[torch.cat([t.to(device) for t in lon], dim=-1)
                         for lon in row] for row in _gather_remote(tiles)],
                       device)

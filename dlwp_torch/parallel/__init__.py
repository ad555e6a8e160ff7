"""Parallelism: device meshes, lat-band halo exchange, sharded convs and
the sharded spectral and barotropic core (port of ``dlwp_tpu.parallel``).

One program drives a mesh of devices, which may repeat one card (see
:mod:`dlwp_torch.parallel.mesh`):

- ``data`` mesh axis: batch sharding;
- ``lat`` mesh axis: latitude-band domain decomposition, with neighbour
  halo exchange for stencils: plain PyTorch (``halo``), or hand-written
  CUDA kernels (``pallas_halo``, ``pallas_overlap``; the names follow the
  JAX modules they port); and latitude-band grids with zonal-wavenumber
  band spectra for the spectral core (``spectral``, ``barotropic``);
- ``lon`` mesh axis: lat x lon tiles, the periodic longitude boundary a
  cyclic ring of tiles (``halo``, plain PyTorch only);
- several processes: ``torch.distributed`` ranks, a mesh over them from
  ``distributed.multihost_mesh`` (data across processes, lat within each,
  or lat and lon across them: the kernels read another process's edge
  rows over CUDA IPC, the plain path and the gradients move them with
  ``torch.distributed`` messages, the spectral transposes are
  ``all_to_all``), data parallelism in the trainer.
"""

from dlwp_torch.parallel.barotropic import ShardedBarotropicModel
from dlwp_torch.parallel.halo import (
    halo_exchange_lat,
    halo_exchange_lon,
    sharded_cyclic_conv2d,
)
from dlwp_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    batch_sharding,
    build_mesh,
)
from dlwp_torch.parallel.pallas_halo import pallas_sharded_cyclic_conv2d
from dlwp_torch.parallel.pallas_overlap import overlapped_cyclic_conv2d
from dlwp_torch.parallel.spatial import SpatialSharding
from dlwp_torch.parallel.spectral import ShardedSphericalHarmonics

__all__ = [
    "Mesh",
    "MeshConfig",
    "ShardedBarotropicModel",
    "ShardedSphericalHarmonics",
    "SpatialSharding",
    "batch_sharding",
    "build_mesh",
    "halo_exchange_lat",
    "halo_exchange_lon",
    "overlapped_cyclic_conv2d",
    "pallas_sharded_cyclic_conv2d",
    "sharded_cyclic_conv2d",
]

"""Parallelism: device meshes, lat-band halo exchange, sharded convs (port
of ``dlwp_tpu.parallel``, without its spectral and barotropic parts).

One program drives a mesh of devices, which may repeat one card (see
:mod:`dlwp_torch.parallel.mesh`):

- ``data`` mesh axis: batch sharding;
- ``lat`` mesh axis: latitude-band domain decomposition, with neighbour
  halo exchange for stencils: plain PyTorch (``halo``), or hand-written
  CUDA kernels (``pallas_halo``, ``pallas_overlap``; the names follow the
  JAX modules they port).
"""

from dlwp_torch.parallel.halo import halo_exchange_lat, sharded_cyclic_conv2d
from dlwp_torch.parallel.mesh import Mesh, MeshConfig, build_mesh
from dlwp_torch.parallel.pallas_halo import pallas_sharded_cyclic_conv2d
from dlwp_torch.parallel.pallas_overlap import overlapped_cyclic_conv2d
from dlwp_torch.parallel.spatial import SpatialSharding

__all__ = [
    "Mesh",
    "MeshConfig",
    "SpatialSharding",
    "build_mesh",
    "halo_exchange_lat",
    "overlapped_cyclic_conv2d",
    "pallas_sharded_cyclic_conv2d",
    "sharded_cyclic_conv2d",
]

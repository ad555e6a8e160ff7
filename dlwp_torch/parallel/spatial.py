"""Latitude-band spatial sharding of model layers (port of
``dlwp_tpu.parallel.spatial``).

A :class:`SpatialSharding` attaches to :class:`~dlwp_torch.models.layers.
CyclicConv2D` and :class:`~dlwp_torch.models.layers.ConvLSTM2D` (through
``build_sequential(spatial=...)`` or ``DLWPNeuralNet.build_model(mesh=...,
batch_spec=...)``) and sends each of their convs down the sharded path when
the shapes admit it, else to the plain ``cyclic_conv2d``. Activations stay
global tensors between layers; each sharded conv cuts its input into the
mesh's shards and joins its output.

``impl``: 'ppermute' (plain PyTorch halo exchange, the portable path),
'pallas' (the ``halo_exchange`` kernel + a VALID conv; any kernel size and
dilation) or 'overlap' (the ``overlap_conv`` kernels for 3x3 undilated 4-D
convs, others as 'pallas'). The kernel paths are forward only: their
backward comes with the sharded backward (ROADMAP.md section 1, item 6).
"""

from __future__ import annotations

import dataclasses

import torch

from dlwp_torch.ops.conv import cyclic_conv2d
from dlwp_torch.parallel.halo import _LON_TODO, sharded_cyclic_conv2d
from dlwp_torch.parallel.mesh import Mesh, axis_size
from dlwp_torch.parallel.pallas_halo import pallas_sharded_cyclic_conv2d
from dlwp_torch.parallel.pallas_overlap import overlapped_cyclic_conv2d

IMPLS = ("ppermute", "pallas", "overlap")


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """Latitude-band decomposition config for spherical convs.

    Attributes:
        mesh: the device mesh; holds ``lat_axis`` (and ``data_axis``).
        data_axis: mesh axis the batch is sharded over, or None.
        lat_axis: mesh axis the latitude dimension is sharded over.
        lon_axis: must be None: longitude sharding is not ported yet.
        impl: 'ppermute', 'pallas' or 'overlap' (see the module notes).
    """

    mesh: Mesh
    data_axis: str | None = "data"
    lat_axis: str = "lat"
    lon_axis: str | None = None
    impl: str = "ppermute"

    def __post_init__(self):
        if self.lon_axis is not None:
            raise NotImplementedError(_LON_TODO)
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")

    @property
    def lat_shards(self) -> int:
        return self.mesh.shape[self.lat_axis]

    @property
    def data_shards(self) -> int:
        return axis_size(self.mesh, self.data_axis)

    def activation_spec(self, ndim: int) -> tuple:
        """Axis names of an (..., C, H, W) activation of rank ``ndim``."""
        return (self.data_axis,) + (None,) * (ndim - 3) + (self.lat_axis,
                                                           None)

    def shardable(self, x_shape, kernel_shape, strides, dilation,
                  lat_mode) -> bool:
        """Whether the sharded path applies to this conv: more than one lat
        shard, unit strides, a zero latitude boundary, H and the batch
        dividing over the lat and data shards, and each halo within one
        neighbour block."""
        if self.lat_shards <= 1:
            return False
        if tuple(strides) != (1, 1) or lat_mode != "zero":
            return False
        H = x_shape[-2]
        B = x_shape[0] if len(x_shape) >= 4 else 1
        if H % self.lat_shards or (self.data_axis and B % self.data_shards):
            return False
        eh = (kernel_shape[-2] - 1) * dilation[0]
        return max(eh // 2, eh - eh // 2) <= H // self.lat_shards

    def conv(self, x: torch.Tensor, kernel: torch.Tensor, strides=(1, 1),
             dilation=(1, 1), lat_mode: str = "zero") -> torch.Tensor:
        """Cyclic conv via the sharded path when admissible, else local."""
        dilation = tuple(dilation)
        if not self.shardable(x.shape, kernel.shape, strides, dilation,
                              lat_mode):
            return cyclic_conv2d(x, kernel, strides=strides,
                                 lat_mode=lat_mode, dilation=dilation)
        if self.impl in ("pallas", "overlap"):
            if torch.is_grad_enabled() and (x.requires_grad
                                            or kernel.requires_grad):
                raise NotImplementedError(
                    "the sharded kernel paths are forward only; their "
                    "backward comes with the sharded backward of the "
                    "training slice (ROADMAP.md section 1, item 6): use "
                    "impl='ppermute' to differentiate")
            return _fast_conv_impl(x, kernel, self, dilation)
        return _ppermute_conv(x, kernel, self, dilation)


def _ppermute_conv(x, kernel, cfg: SpatialSharding, dilation):
    """Sharded conv through the plain PyTorch halo exchange."""
    return sharded_cyclic_conv2d(x, kernel, cfg.mesh, dilation=dilation,
                                 data_axis=cfg.data_axis,
                                 lat_axis_name=cfg.lat_axis)


def _fast_conv_impl(x, kernel, cfg: SpatialSharding, dilation):
    """Sharded conv through the kernels: 3x3 undilated 4-D convs of
    impl='overlap' on bands of at least 2 rows take the overlap kernels,
    the rest the halo kernel. (The JAX package sends 1-row bands to the
    overlap kernel too, which asserts on them.)"""
    if (cfg.impl == "overlap" and tuple(kernel.shape[-2:]) == (3, 3)
            and dilation == (1, 1) and x.dim() == 4
            and x.shape[-2] // cfg.lat_shards >= 2):
        return overlapped_cyclic_conv2d(x, kernel, cfg.mesh,
                                        data_axis=cfg.data_axis,
                                        lat_axis_name=cfg.lat_axis)
    return pallas_sharded_cyclic_conv2d(x, kernel, cfg.mesh,
                                        data_axis=cfg.data_axis,
                                        lat_axis_name=cfg.lat_axis,
                                        dilation=dilation)


def attach_spatial(layer, spatial: SpatialSharding | None):
    """Set ``layer.spatial`` where the layer has the field and it is unset
    (in place: port layers are mutable modules); returns the layer."""
    if spatial is not None and getattr(layer, "spatial", "missing") is None:
        layer.spatial = spatial
    return layer

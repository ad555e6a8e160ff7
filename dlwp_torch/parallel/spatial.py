"""Spatial sharding of model layers (port of ``dlwp_tpu.parallel.spatial``).

A :class:`SpatialSharding` attaches to :class:`~dlwp_torch.models.layers.
CyclicConv2D` and :class:`~dlwp_torch.models.layers.ConvLSTM2D` (through
``build_sequential(spatial=...)`` or ``DLWPNeuralNet.build_model(mesh=...,
batch_spec=...)``) and sends each of their convs down the sharded path when
the shapes admit it, else to the plain ``cyclic_conv2d``. Activations stay
global tensors between layers; each sharded conv cuts its input into the
mesh's lat bands (or lat x lon tiles) and joins its output.

``impl``: 'ppermute' (plain PyTorch halo exchange, the portable path),
'pallas' (the ``halo_exchange`` kernel + a VALID conv; any kernel size and
dilation) or 'overlap' (the ``overlap_conv`` kernels for 3x3 undilated 4-D
convs, others as 'pallas'). The kernels are lat-band only and float32: a
conv on lon tiles, or of another dtype (a float64 model), takes the
'ppermute' path whatever ``impl`` says. The kernel paths differentiate as
the JAX package's ``_fast_conv`` ``custom_vjp`` does: the forward runs the
kernels, the backward recomputes the conv through the 'ppermute' path at
the saved inputs and returns its gradient (:class:`_FastConv`).

On a mesh over several processes: where the data axis spans them, a
layer's activations are the process's own block of the batch (the
trainer keeps it) and each conv cuts that block over the process's own
entries (``Mesh.process_local``); lat neighbours on other cards of the
process take the kernels through peer access. Where the lat axis spans
processes, the kernels read a neighbour band's edge rows from its
process's edge mailbox over CUDA IPC, and the backward recomputes through
the 'ppermute' path, whose messages and their transposes give every
process the one-process gradient (:mod:`dlwp_torch.parallel.halo`); a
lon axis across processes is a ring of such messages.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from dlwp_torch.ops.conv import cyclic_conv2d
from dlwp_torch.parallel.halo import sharded_cyclic_conv2d
from dlwp_torch.parallel.mesh import Mesh, axis_size
from dlwp_torch.parallel.pallas_halo import pallas_sharded_cyclic_conv2d
from dlwp_torch.parallel.pallas_overlap import overlapped_cyclic_conv2d

IMPLS = ("ppermute", "pallas", "overlap")


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """Latitude-band (or lat x lon tile) decomposition config for
    spherical convs.

    Attributes:
        mesh: the device mesh; holds ``lat_axis`` (and ``data_axis``,
            ``lon_axis``).
        data_axis: mesh axis the batch is sharded over, or None.
        lat_axis: mesh axis the latitude dimension is sharded over.
        lon_axis: optional mesh axis the longitude dimension is sharded
            over; its periodic boundary is then a cyclic ring of tiles,
            always on the 'ppermute' path.
        impl: 'ppermute', 'pallas' or 'overlap' (see the module notes).
    """

    mesh: Mesh
    data_axis: str | None = "data"
    lat_axis: str = "lat"
    lon_axis: str | None = None
    impl: str = "ppermute"

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")

    @functools.cached_property
    def local(self) -> "SpatialSharding":
        """The config the convs run: on the process's own part of a data
        axis that spans processes (this config elsewhere)."""
        mesh = self.mesh.process_local(self.data_axis)
        return self if mesh is self.mesh else dataclasses.replace(
            self, mesh=mesh)

    @property
    def lat_shards(self) -> int:
        return self.mesh.shape[self.lat_axis]

    @property
    def lon_shards(self) -> int:
        return axis_size(self.mesh, self.lon_axis)

    @property
    def data_shards(self) -> int:
        return axis_size(self.mesh, self.data_axis)

    def activation_spec(self, ndim: int) -> tuple:
        """Axis names of an (..., C, H, W) activation of rank ``ndim``."""
        return ((self.data_axis,) + (None,) * (ndim - 3)
                + (self.lat_axis, self.lon_axis))

    def shardable(self, x_shape, kernel_shape, strides, dilation,
                  lat_mode) -> bool:
        """Whether the sharded path applies to this conv: more than one
        spatial shard, unit strides, a zero latitude boundary, H / W and
        the batch dividing over the lat / lon and data shards, and each
        halo within one neighbour block."""
        if self.lat_shards <= 1 and self.lon_shards <= 1:
            return False
        if tuple(strides) != (1, 1) or lat_mode != "zero":
            return False
        H, W = x_shape[-2], x_shape[-1]
        B = x_shape[0] if len(x_shape) >= 4 else 1
        if H % self.lat_shards or (self.data_axis and B % self.data_shards):
            return False
        eh = (kernel_shape[-2] - 1) * dilation[0]
        if max(eh // 2, eh - eh // 2) > H // self.lat_shards:
            return False
        if self.lon_shards > 1:
            if W % self.lon_shards:
                return False
            ew = (kernel_shape[-1] - 1) * dilation[1]
            if max(ew // 2, ew - ew // 2) > W // self.lon_shards:
                return False
        return True

    def conv(self, x: torch.Tensor, kernel: torch.Tensor, strides=(1, 1),
             dilation=(1, 1), lat_mode: str = "zero") -> torch.Tensor:
        """Cyclic conv via the sharded path when admissible, else local.
        ``x`` is the process's own block of the batch where the data axis
        spans processes (see the module notes)."""
        cfg = self.local
        dilation = tuple(dilation)
        if not cfg.shardable(x.shape, kernel.shape, strides, dilation,
                             lat_mode):
            return cyclic_conv2d(x, kernel, strides=strides,
                                 lat_mode=lat_mode, dilation=dilation)
        if (cfg.impl in ("pallas", "overlap") and cfg.lon_shards <= 1
                and x.dtype == kernel.dtype == torch.float32):
            if torch.is_grad_enabled() and (x.requires_grad
                                            or kernel.requires_grad):
                return _FastConv.apply(x, kernel, cfg, dilation)
            return _fast_conv_impl(x, kernel, cfg, dilation)
        return _ppermute_conv(x, kernel, cfg, dilation)


def _ppermute_conv(x, kernel, cfg: SpatialSharding, dilation):
    """Sharded conv through the plain PyTorch halo exchange."""
    return sharded_cyclic_conv2d(
        x, kernel, cfg.mesh, dilation=dilation, data_axis=cfg.data_axis,
        lat_axis_name=cfg.lat_axis,
        lon_axis_name=cfg.lon_axis if cfg.lon_shards > 1 else None)


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


class _FastConv(torch.autograd.Function):
    """The kernel paths under autograd (the JAX ``_fast_conv`` custom VJP):
    the forward runs :func:`_fast_conv_impl` and saves its inputs, never
    its output; the backward recomputes :func:`_ppermute_conv` at those
    inputs and returns its gradient. The kernels therefore launch in the
    forward only, and the gradient is the plain conv's."""

    @staticmethod
    def forward(ctx, x, kernel, cfg, dilation):
        ctx.cfg, ctx.dilation = cfg, dilation
        ctx.save_for_backward(x, kernel)
        return _fast_conv_impl(x, kernel, cfg, dilation)

    @staticmethod
    def backward(ctx, grad_out):
        x, kernel = ctx.saved_tensors
        needs = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            inputs = (x.detach().requires_grad_(needs[0]),
                      kernel.detach().requires_grad_(needs[1]))
            out = _ppermute_conv(*inputs, ctx.cfg, ctx.dilation)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(inputs, needs) if n],
                grad_out.to(out.dtype)))
        return tuple(next(grads) if n else None for n in needs) + (None, None)


def attach_spatial(layer, spatial: SpatialSharding | None):
    """Set ``layer.spatial`` where the layer has the field and it is unset
    (in place: port layers are mutable modules); returns the layer."""
    if spatial is not None and getattr(layer, "spatial", "missing") is None:
        layer.spatial = spatial
    return layer

"""Declarative sequential models (port of ``dlwp_tpu.models.cnn``).

Specs are ``(name, args, kwargs)`` tuples resolved by name, as in the
reference's layer-tuple config language, or module instances (such as
:class:`~dlwp_torch.models.unet.SkipTower`). :data:`LAYER_REGISTRY` has
every name of the JAX package's registry: the fused spherical layers, the
reference's Keras and ``DLWP.custom`` names (padding layers, ``Conv2D``,
``Dense``, pooling, ``slice_layer``) and its torch names (``Linear``,
``TorchReshape``); ``S2Convolution`` and ``SO3Convolution`` are the
spectral layers of :mod:`dlwp_torch.models.spherical`, and the ``Cube*``
names DLWP-CS's cubed-sphere layers and U-Net (:mod:`dlwp_torch.models.cube`).
:func:`build_sequential` applies the same parameter-preserving peephole
fusions as the JAX ``build_sequential``,
with :class:`Identity` fillers, so layer ``i`` of the port holds the
weights of the flax ``layers_{i}`` slot.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dlwp_torch.device import resolve_device
from dlwp_torch.ops.padding import pad_trailing
from dlwp_torch.parallel.spatial import attach_spatial
from dlwp_torch.utils.profiling import span
from dlwp_torch.models.cube import (
    CubeAveragePooling2D,
    CubeSphereConv2D,
    CubeSpherePadding2D,
    CubeUNet,
    CubeUpSampling2D,
)
from dlwp_torch.models.layers import (
    MONOTONE_ACTIVATIONS,
    Activation,
    AvgPool2D,
    ConvLSTM2D,
    CyclicConv2D,
    FusedConvPool2D,
    Identity,
    MaxPool2D,
    ParamLayer,
    Reshape,
    RowConv2D,
    UpConv2D,
    UpSampling2D,
    _ConvBase,
    _lecun_normal,
    get_activation,
    initializing,
    pair,
)


class _Pad(nn.Module):
    """Padding over the trailing axes (``PeriodicPadding2D`` and the
    others): ``padding`` an int (the two trailing axes, also for the 3-D
    names) or one amount, an int or ``(before, after)``, per trailing
    axis; ``mode`` a numpy mode of :func:`~dlwp_torch.ops.padding.
    pad_trailing`."""

    mode = "wrap"

    def __init__(self, padding=1):
        super().__init__()
        self.padding = padding

    def amounts(self, n_int: int = 2):
        pad = self.padding
        if isinstance(pad, int):
            return [(pad, pad)] * n_int
        return [(p, p) if isinstance(p, int) else tuple(p) for p in pad]

    def forward(self, x):
        return pad_trailing(x, self.amounts(), self.mode)


class PeriodicPadding2D(_Pad):
    mode = "wrap"


class ZeroPadding2D(_Pad):
    mode = "constant"


class FillPadding2D(_Pad):
    mode = "edge"


# The 3-D names are the same op over the trailing axes they are given.
PeriodicPadding3D = PeriodicPadding2D
ZeroPadding3D = ZeroPadding2D
FillPadding3D = FillPadding2D


class TFPadding2D(_Pad):
    """``tf.pad`` modes (the reference's ``TFPadding2D``): CONSTANT with
    ``constant_values``, SYMMETRIC or REFLECT, over the two trailing axes
    (an int pads ``n_axes`` of them)."""

    n_axes = 2
    MODES = {"CONSTANT": "constant", "SYMMETRIC": "symmetric",
             "REFLECT": "reflect"}

    def __init__(self, padding=None, mode="CONSTANT", constant_values=0.0):
        super().__init__((1,) * self.n_axes if padding is None else padding)
        try:
            self.mode = self.MODES[mode.upper()]
        except KeyError:
            raise ValueError(f"unknown tf.pad mode {mode!r}") from None
        self.constant_values = constant_values

    def forward(self, x):
        return pad_trailing(x, self.amounts(self.n_axes), self.mode,
                            self.constant_values)


class TFPadding3D(TFPadding2D):
    n_axes = 3


class Conv2D(_ConvBase):
    """Keras ``Conv2D`` (channels-first), VALID or SAME padding, with
    strides and dilation. SAME pads as XLA does, also at strides > 1
    (which ``F.conv2d(padding='same')`` refuses): per axis, out =
    ceil(in / s), total = max((out - 1) s + (k - 1) d + 1 - in, 0), the
    smaller half before."""

    def __init__(self, features, kernel_size=3, strides=(1, 1),
                 padding="valid", dilation_rate=1, activation="linear",
                 use_bias=True):
        super().__init__(features, kernel_size, dilation_rate, activation,
                         use_bias)
        if padding.upper() not in ("VALID", "SAME"):
            raise ValueError(f"padding must be 'valid' or 'same', got "
                             f"{padding!r}")
        self.strides = pair(strides)
        self.padding = padding.upper()

    def forward(self, x):
        self._require_built(x)
        lead = x.shape[:-3]
        x4 = x.reshape((-1,) + x.shape[-3:])
        if self.padding == "SAME":
            pads = []
            for n, k, s, d in zip(x4.shape[-2:], self.kernel_size,
                                  self.strides, self.dilation):
                out = -(-n // s)
                total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
                pads.append((total // 2, total - total // 2))
            x4 = F.pad(x4, pads[1] + pads[0])
        y = F.conv2d(x4, self.kernel, stride=self.strides,
                     dilation=self.dilation)
        return self._finish(y.reshape(lead + y.shape[1:]))


class _DenseKernel(ParamLayer):
    """flax ``nn.Dense``: ``kernel`` (in, out), lecun-normal, and
    ``bias``; contracts the last axis."""

    def __init__(self, features):
        super().__init__()
        self.features = features
        self.register_parameter("kernel", None)
        self.register_parameter("bias", None)

    def in_channels(self, x):
        return x.shape[-1]

    def flax_dims(self, shapes):
        return shapes["kernel"][0] if "kernel" in shapes else -1

    def param_shapes(self, c_in):
        return {"kernel": (c_in, self.features), "bias": (self.features,)}

    def _initializer(self, name):
        return _lecun_normal if name == "kernel" else super()._initializer(name)

    def forward(self, x):
        self._require_built(x)
        return x @ self.kernel + self.bias


class Dense(nn.Module):
    """Keras ``Dense``: the flax layer nests its weights as
    ``{"dense": {"kernel", "bias"}}``, and so does this one."""

    def __init__(self, features, activation="linear"):
        super().__init__()
        self.activation = activation
        self.dense = _DenseKernel(features)

    def forward(self, x):
        return get_activation(self.activation)(self.dense(x))


def _size_arg(args, kw, key):
    size = args[0] if args else kw.pop(key, 2)
    if isinstance(size, tuple) and len(size) == 1:
        size = size[0]
    return size


def _conv_layer(cls):
    def build(*args, **kw):
        for k in ("data_format", "input_shape", "kernel_regularizer",
                  "return_sequences"):
            kw.pop(k, None)
        if cls is Conv2D:
            kw.setdefault("dilation_rate", kw.pop("dilation", 1))
        else:
            kw.pop("padding", None)  # the boundary handling is built in
            if "dilation_rate" in kw:
                kw["dilation"] = kw.pop("dilation_rate")
        if len(args) >= 2:
            return cls(args[0], args[1], **kw)
        return cls(*args, **kw)

    return build


def _convlstm(*args, **kw):
    for k in ("data_format", "input_shape", "kernel_regularizer", "padding"):
        kw.pop(k, None)
    kw["dilation"] = kw.pop("dilation_rate", kw.pop("dilation", 1))
    return ConvLSTM2D(*args[:2], **kw)


def _pad_layer(cls):
    def build(*args, **kw):
        return cls(args[0] if args else kw.get("padding", 1))

    return build


def _tf_pad_layer(cls):
    def build(*args, **kw):
        return cls(args[0] if args else kw.get("padding"),
                   mode=kw.get("mode", "CONSTANT"),
                   constant_values=kw.get("constant_values", 0.0))

    return build


def _slice_layer(*args, **kw):
    """The reference's ``slice_layer(start, stop, axis)``; Keras axis 1,
    the channel axis of channels-first data, is -3 here."""
    from dlwp_torch.models.unet import SliceChannels

    if args:
        start, stop = args[0], args[1]
        axis = args[2] if len(args) > 2 else kw.get("axis", -3)
    else:
        start, stop, axis = kw["start"], kw["stop"], kw.get("axis", -3)
    return SliceChannels(start, stop, -3 if axis == 1 else axis)


def _spherical(name):
    """The reference spec tuples (train_torch.py:103-110): positional
    (nfeature_in, nfeature_out, b_in, b_out, grid), kwargs mean_gamma /
    activation."""
    def build(*args, **kw):
        from dlwp_torch.models import spherical

        return getattr(spherical, name)(*args, **kw)

    return build


def _torch_linear(*args, **kw):
    """torch ``nn.Linear(in_features, out_features)``; the input sets
    in_features."""
    if len(args) >= 2:
        return Dense(args[1], **kw)
    return Dense(kw.pop("out_features", args[0] if args
                        else kw.pop("features")), **kw)


def _torch_reshape(*args, **kw):
    """The reference's ``TorchReshape``: the full shape with the batch's -1
    first (Keras ``Reshape`` takes the trailing dims only)."""
    shape = tuple(args[0] if args else kw["shape"])
    if shape and shape[0] != -1:
        raise ValueError(
            f"TorchReshape shape {shape} must lead with -1 (the batch "
            f"dimension, as in the reference's torch view specs); got "
            f"{shape[0]!r}")
    return Reshape(shape[1:])


LAYER_REGISTRY = {
    "CyclicConv2D": _conv_layer(CyclicConv2D),
    "RowConv2D": _conv_layer(RowConv2D),
    "RowConnected2D": _conv_layer(RowConv2D),
    "slice_layer": _slice_layer,
    "ConvLSTM2D": _convlstm,
    "Conv2D": _conv_layer(Conv2D),
    "Dense": _conv_layer(Dense),
    "MaxPooling2D": lambda *a, **k: MaxPool2D(_size_arg(a, k, "pool_size")),
    "AveragePooling2D": lambda *a, **k: AvgPool2D(
        _size_arg(a, k, "pool_size")),
    "UpSampling2D": lambda *a, **k: UpSampling2D(_size_arg(a, k, "size")),
    "Reshape": lambda *a, **k: Reshape(a[0] if a else k["target_shape"]),
    "Activation": lambda *a, **k: Activation(
        a[0] if a else k.get("activation", "linear")
    ),
    "PeriodicPadding2D": _pad_layer(PeriodicPadding2D),
    "PeriodicPadding3D": _pad_layer(PeriodicPadding3D),
    "ZeroPadding2D": _pad_layer(ZeroPadding2D),
    "ZeroPadding3D": _pad_layer(ZeroPadding3D),
    "FillPadding2D": _pad_layer(FillPadding2D),
    "FillPadding3D": _pad_layer(FillPadding3D),
    "TFPadding2D": _tf_pad_layer(TFPadding2D),
    "TFPadding3D": _tf_pad_layer(TFPadding3D),
    "S2Convolution": _spherical("S2Convolution"),
    "SO3Convolution": _spherical("SO3Convolution"),
    "Linear": _torch_linear,
    "TorchReshape": _torch_reshape,
    "FusedConvPool2D": _conv_layer(FusedConvPool2D),
    "UpConv2D": _conv_layer(UpConv2D),
    "CubeUNet": CubeUNet,
    "CubeSpherePadding2D": CubeSpherePadding2D,
    "CubeSphereConv2D": CubeSphereConv2D,
    "CubeAveragePooling2D": CubeAveragePooling2D,
    "CubeUpSampling2D": CubeUpSampling2D,
}


def resolve_layer(spec) -> nn.Module:
    """One layer spec: an ``nn.Module``, or ``(name, args, kwargs)``."""
    if isinstance(spec, nn.Module):
        return spec
    name, args, kwargs = spec
    try:
        make = LAYER_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown layer {name!r}; registered: {sorted(LAYER_REGISTRY)}"
        ) from None
    return make(*(args or ()), **dict(kwargs or {}))


def _peephole_fuse(layers: list) -> list:
    """conv3x3+pool -> FusedConvPool2D; upsample+conv -> UpConv2D; a
    dilation-2 UpConv2D followed by a conv keeps its output on the small
    grid (``cnn.py:387``). Fused layers take the conv's slot, an Identity
    the other. A conv that carries a ``spatial`` sharding stays as it is
    (the fused forms are single-device)."""
    out = list(layers)
    for i in range(len(out) - 1):
        a, b = out[i], out[i + 1]
        if (
            isinstance(a, CyclicConv2D)
            and a.spatial is None
            and isinstance(b, MaxPool2D)
            and b.window == (2, 2)
            and a.kernel_size == (3, 3)
            and a.strides == (1, 1)
            and a.lat_mode == "zero"
            and a.activation in MONOTONE_ACTIVATIONS
        ):
            out[i] = FusedConvPool2D(a.features, a.kernel_size, a.dilation,
                                     a.activation, a.use_bias)
            out[i + 1] = Identity()
        elif (
            isinstance(a, UpSampling2D)
            and a.factor == (2, 2)
            and isinstance(b, CyclicConv2D)
            and b.spatial is None
            and b.strides == (1, 1)
            and b.lat_mode == "zero"
            and b.kernel_size[0] == b.kernel_size[1]
        ):
            out[i] = Identity()
            out[i + 1] = UpConv2D(b.features, b.kernel_size, b.dilation,
                                  b.activation, b.use_bias)
    for i in range(len(out) - 1):
        a, b = out[i], out[i + 1]
        if (
            isinstance(a, UpConv2D)
            and not a.emit_small
            and a.dilation == (2, 2)
            and isinstance(b, CyclicConv2D)
            and b.spatial is None
            and b.strides == (1, 1)
            and b.lat_mode == "zero"
            and b.kernel_size[0] == b.kernel_size[1] <= 5
            and b.dilation in ((1, 1), (2, 2))
        ):
            out[i] = UpConv2D(a.features, a.kernel_size, a.dilation,
                              a.activation, a.use_bias, emit_small=True)
            out[i + 1] = UpConv2D(b.features, b.kernel_size, b.dilation,
                                  b.activation, b.use_bias, input_small=True)
    return out


class SequentialModel(nn.Module):
    """Apply a fixed sequence of layers; ``layers[i]`` is flax
    ``layers_{i}``. Lives on ``device`` (default ``cuda``; raises without
    a card unless ``device='cpu'``). Each layer's call is a span
    ``layer.<class name>`` (:func:`~dlwp_torch.utils.profiling.span`)."""

    def __init__(self, layers: Sequence[nn.Module], device=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.device = resolve_device(device)

    def forward(self, x):
        for layer in self.layers:
            with span(f"layer.{type(layer).__name__}"):
                x = layer(x)
        return x

    @property
    def built(self) -> bool:
        """Whether every parameter layer, nested ones too, holds its
        parameters."""
        return all(m.built for m in self.modules()
                   if isinstance(m, ParamLayer))

    @torch.no_grad()
    def init(self, x: torch.Tensor, seed: int = 0) -> "SequentialModel":
        """Create random parameters for input ``x`` (the flax ``init`` shape
        pass): one forward under :func:`~dlwp_torch.models.layers.
        initializing`, each layer drawing from a ``torch.Generator``
        seeded with ``seed`` in the order the forward reaches it. Layers
        that already hold parameters keep them; a model whose layers all
        hold them runs nothing."""
        if self.built:
            return self
        with initializing(torch.Generator().manual_seed(seed)):
            self(x.to(self.device))
        return self

    def share_params_from(self, other: "SequentialModel") -> None:
        """Point every parameter at ``other``'s tensor of the same slot
        (same architecture, no copy)."""
        for mine, theirs in zip(self.modules(), other.modules(), strict=True):
            for name, p in theirs.named_parameters(recurse=False):
                setattr(mine, name, p)


def build_sequential(specs: Sequence, spatial=None, fuse: bool = True,
                     device=None) -> SequentialModel:
    """Build a :class:`SequentialModel` from specs on ``device`` (default
    ``cuda``; raises without a card unless ``device='cpu'``).

    ``spatial``: an optional
    :class:`~dlwp_torch.parallel.spatial.SpatialSharding`, attached to every
    layer that takes one before fusing, so its convs run the lat-band
    sharded path."""
    dev = resolve_device(device)
    layers = [attach_spatial(resolve_layer(s), spatial) for s in specs]
    if fuse:
        layers = _peephole_fuse(layers)
    return SequentialModel(layers, device=dev)


__all__ = [
    "Conv2D",
    "Dense",
    "FillPadding2D",
    "FillPadding3D",
    "LAYER_REGISTRY",
    "PeriodicPadding2D",
    "PeriodicPadding3D",
    "SequentialModel",
    "TFPadding2D",
    "TFPadding3D",
    "ZeroPadding2D",
    "ZeroPadding3D",
    "build_sequential",
    "resolve_layer",
]

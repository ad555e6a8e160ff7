"""Declarative sequential models (port of ``dlwp_tpu.models.cnn``).

Specs are ``(name, args, kwargs)`` tuples resolved by name, as in the
reference's layer-tuple config language. This slice registers the layers
the ConvLSTM flagship uses plus the fused ``FusedConvPool2D`` /
``UpConv2D`` forms. :func:`build_sequential` applies the same
parameter-preserving peephole fusions as the JAX ``build_sequential``, with
:class:`Identity` fillers, so layer ``i`` of the port holds the weights of
the flax ``layers_{i}`` slot.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from dlwp_torch.device import resolve_device
from dlwp_torch.parallel.spatial import attach_spatial
from dlwp_torch.models.layers import (
    MONOTONE_ACTIVATIONS,
    Activation,
    ConvLSTM2D,
    CyclicConv2D,
    FusedConvPool2D,
    Identity,
    MaxPool2D,
    ParamLayer,
    Reshape,
    UpConv2D,
    UpSampling2D,
)


def _size_arg(args, kw, key):
    size = args[0] if args else kw.pop(key, 2)
    if isinstance(size, tuple) and len(size) == 1:
        size = size[0]
    return size


def _conv_layer(cls):
    def build(*args, **kw):
        for k in ("data_format", "input_shape", "kernel_regularizer",
                  "return_sequences", "padding"):
            kw.pop(k, None)
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


LAYER_REGISTRY = {
    "CyclicConv2D": _conv_layer(CyclicConv2D),
    "ConvLSTM2D": _convlstm,
    "MaxPooling2D": lambda *a, **k: MaxPool2D(_size_arg(a, k, "pool_size")),
    "UpSampling2D": lambda *a, **k: UpSampling2D(_size_arg(a, k, "size")),
    "Reshape": lambda *a, **k: Reshape(a[0] if a else k["target_shape"]),
    "Activation": lambda *a, **k: Activation(
        a[0] if a else k.get("activation", "linear")
    ),
    "FusedConvPool2D": _conv_layer(FusedConvPool2D),
    "UpConv2D": _conv_layer(UpConv2D),
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
    a card unless ``device='cpu'``)."""

    def __init__(self, layers: Sequence[nn.Module], device=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.device = resolve_device(device)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    @torch.no_grad()
    def init(self, x: torch.Tensor, seed: int = 0) -> "SequentialModel":
        """Create random parameters for input ``x``, layer by layer (the
        flax ``init`` shape pass), from a ``torch.Generator`` seeded with
        ``seed``. Layers that already hold parameters keep them; a model
        whose layers all hold them runs nothing."""
        if all(layer.built for layer in self.layers
               if isinstance(layer, ParamLayer)):
            return self
        gen = torch.Generator().manual_seed(seed)
        x = x.to(self.device)
        for layer in self.layers:
            if isinstance(layer, ParamLayer):
                layer.materialize(x, gen)
            x = layer(x)
        return self

    def share_params_from(self, other: "SequentialModel") -> None:
        """Point every parameter at ``other``'s tensor of the same slot
        (same architecture, no copy)."""
        for mine, theirs in zip(self.layers, other.layers, strict=True):
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
    "LAYER_REGISTRY",
    "SequentialModel",
    "build_sequential",
    "resolve_layer",
]

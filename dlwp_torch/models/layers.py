"""PyTorch layers for spherical-geometry weather CNNs.

Port of the flagship's layers from ``dlwp_tpu.models.layers``. Data are
channels-first: (B, C, H, W), or (B, T, C, H, W) for :class:`ConvLSTM2D`.
Weights keep the flax names and shapes (``kernel`` OIHW and ``bias``;
``input_kernel``, ``recurrent_kernel`` and ``bias`` for the ConvLSTM), so
:func:`dlwp_torch.weights.load_flax_params` fills them one to one.

As in flax, a layer learns its input channel count from its first input:
parameters exist after :meth:`SequentialModel.init` (random, from a
``torch.Generator``) or after ``load_flax_params``. ``init`` runs the
model's forward under :func:`initializing`, in which each parameter layer
creates its parameters from the generator at its first input, so layers
nested in other modules (``SkipTower``) are built the same way.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dlwp_torch.kernels import cyclic_conv, fused_conv_pool, lstm_gates
from dlwp_torch.kernels.cyclic_conv import ACT_CODES as CONV_ACTIVATIONS
from dlwp_torch.kernels.lstm_gates import ACT_CODES, gate_chain, hard_sigmoid
from dlwp_torch.ops.conv import (
    conv_after_upsample2,
    conv_pool2_even_dilation,
    cyclic_conv2d,
    cyclic_conv2d_edgefix,
    row_conv2d,
)
from dlwp_torch.ops.pooling import avg_pool2d, max_pool2d, upsample2d

_ACTIVATIONS = {
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": hard_sigmoid,  # Keras's, ConvLSTM2D's default gate
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "leaky_relu": F.leaky_relu,
    "softplus": F.softplus,
    "swish": F.silu,
}

# Nondecreasing activations commute with max pooling exactly.
MONOTONE_ACTIVATIONS = {
    "linear", None, "tanh", "relu", "sigmoid", "hard_sigmoid", "elu",
    "selu", "leaky_relu", "softplus",
}


def get_activation(act):
    if act is None:
        return _ACTIVATIONS["linear"]
    if callable(act):
        return act
    try:
        return _ACTIVATIONS[act]
    except KeyError:
        raise ValueError(
            f"unknown activation {act!r}; available: {sorted(_ACTIVATIONS)}"
        ) from None


def pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _glorot(shape, gen, dtype, device, in_axis=1, out_axis=0):
    """flax glorot_uniform(in_axis, out_axis): the receptive field is the
    product of the other axes (OIHW by default)."""
    receptive = math.prod(shape) // (shape[in_axis] * shape[out_axis])
    limit = math.sqrt(6.0 / (shape[out_axis] * receptive
                             + shape[in_axis] * receptive))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return ((2 * u - 1) * limit).to(dtype=dtype, device=device)


def _lecun_normal(shape, gen, dtype, device):
    """flax lecun_normal on an (in, out) kernel: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float64)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype=dtype, device=device)


def _zeros(shape, gen, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _orthogonal(shape, gen, dtype, device):
    """Orthonormal columns along axis 0 (flax orthogonal(column_axis=0))."""
    cols = shape[0]
    rows = math.prod(shape[1:])
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    q = q if rows >= cols else q.T  # (rows, cols)
    return q.T.reshape(shape).to(dtype=dtype, device=device)


_INIT_GENERATORS: list = []


@contextlib.contextmanager
def initializing(gen: torch.Generator):
    """Inside, a parameter layer without parameters creates them from
    ``gen`` at its first input (the flax ``init`` shape pass)."""
    _INIT_GENERATORS.append(gen)
    try:
        yield
    finally:
        _INIT_GENERATORS.pop()


class ParamLayer(nn.Module):
    """A layer whose parameter shapes depend on its input: by default its
    channel count (axis -3), :meth:`in_channels`. ``param_dtype``: the
    dtype of its parameters whatever the input's or the loaded tree's
    (None: theirs)."""

    param_dtype = None

    def param_shapes(self, c_in) -> dict[str, tuple]:
        raise NotImplementedError

    def param_names(self) -> tuple[str, ...]:
        return tuple(self.param_shapes(1))

    def flax_dims(self, shapes: dict[str, tuple]):
        """The :meth:`in_channels` value that flax leaves of these shapes
        were made for (``load_flax_params`` checks every shape with it)."""
        k = shapes.get("input_kernel", shapes.get("kernel"))
        return k[1] if k is not None and len(k) > 1 else -1

    def _initializer(self, name: str):
        return _zeros if name == "bias" else _glorot

    def in_channels(self, x: torch.Tensor):
        return x.shape[-3]

    @property
    def built(self) -> bool:
        return all(getattr(self, n) is not None for n in self.param_names())

    def materialize(self, x: torch.Tensor, gen: torch.Generator) -> None:
        """Create random parameters for input ``x`` (no-op when built)."""
        if self.built:
            return
        for name, shape in self.param_shapes(self.in_channels(x)).items():
            val = self._initializer(name)(shape, gen,
                                          self.param_dtype or x.dtype,
                                          x.device)
            setattr(self, name, nn.Parameter(val, requires_grad=False))

    def _require_built(self, x: torch.Tensor):
        if self.built:
            return
        if _INIT_GENERATORS:
            self.materialize(x, _INIT_GENERATORS[-1])
            return
        raise RuntimeError(
            f"{type(self).__name__} has no parameters: call "
            "SequentialModel.init or load_flax_params first"
        )


class _ConvBase(ParamLayer):
    def __init__(self, features, kernel_size=3, dilation=1,
                 activation="linear", use_bias=True):
        super().__init__()
        self.features = features
        self.kernel_size = pair(kernel_size)
        self.dilation = pair(dilation)
        self.activation = activation
        self.use_bias = use_bias
        self.register_parameter("kernel", None)
        self.register_parameter("bias", None)

    def param_shapes(self, c_in):
        shapes = {"kernel": (self.features, c_in) + self.kernel_size}
        if self.use_bias:
            shapes["bias"] = (self.features,)
        return shapes

    def _finish(self, y):
        if self.use_bias:
            y = y + self.bias[:, None, None]
        return get_activation(self.activation)(y)

    def _forward_float32(self, x) -> bool:
        """float32 x, kernel and bias, and no gradient to record for them
        (the conv kernels are forward only)."""
        operands = (x, self.kernel, self.bias)
        return (
            not (torch.is_grad_enabled()
                 and any(t is not None and t.requires_grad for t in operands))
            and all(t.dtype == torch.float32 for t in operands
                    if t is not None)
        )

    def _kernel_takes(self, x) -> bool:
        """What every route to ``cyclic_conv`` needs: a 4-D input, an
        activation of the kernel's epilogue, :meth:`_forward_float32`."""
        return ((self.activation or "linear") in CONV_ACTIVATIONS
                and x.dim() == 4 and self._forward_float32(x))

    def _kernel_conv(self, x, upsample: bool):
        return cyclic_conv(x, self.kernel, self.bias,
                           self.activation or "linear", upsample)


class CyclicConv2D(_ConvBase):
    """Conv2D with periodic-longitude boundary (``layers.py:76``).

    ``spatial``: an optional
    :class:`~dlwp_torch.parallel.spatial.SpatialSharding`; the conv then
    takes its lat-band sharded path whenever the shapes admit it.
    ``impl='edgefix'`` runs :func:`~dlwp_torch.ops.conv.cyclic_conv2d_edgefix`
    at stride 1 with a zero latitude boundary (elsewhere the 'pad' form),
    as the JAX layer does. What :meth:`uses_kernel` admits goes through
    ``cyclic_conv`` (its kernel on the card, its plain version on the
    CPU): pad, conv, bias and activation in one pass; any other case runs
    the composition, which is also the layer's path while a gradient is
    recorded."""

    def __init__(self, features, kernel_size=3, strides=(1, 1), dilation=1,
                 activation="linear", lat_mode="zero", use_bias=True,
                 impl="pad", spatial=None):
        super().__init__(features, kernel_size, dilation, activation, use_bias)
        if impl not in ("pad", "edgefix"):
            raise ValueError(f"impl must be 'pad' or 'edgefix', got {impl!r}")
        self.strides = pair(strides)
        self.lat_mode = lat_mode
        self.impl = impl
        self.spatial = spatial

    def uses_kernel(self, x) -> bool:
        """An unsharded 3x3 conv at stride 1 and dilation 1 with a zero
        latitude boundary (either ``impl``), and what every kernel route
        needs (:meth:`_kernel_takes`)."""
        return (
            self.spatial is None
            and self.kernel_size == (3, 3)
            and self.strides == (1, 1)
            and self.dilation == (1, 1)
            and self.lat_mode == "zero"
            and self._kernel_takes(x)
        )

    def forward(self, x):
        self._require_built(x)
        if self.uses_kernel(x):
            return self._kernel_conv(x, upsample=False)
        if self.spatial is not None:
            y = self.spatial.conv(x, self.kernel, strides=self.strides,
                                  lat_mode=self.lat_mode,
                                  dilation=self.dilation)
        elif (self.impl == "edgefix" and self.strides == (1, 1)
              and self.lat_mode == "zero"):
            y = cyclic_conv2d_edgefix(x, self.kernel, dilation=self.dilation)
        else:
            y = cyclic_conv2d(x, self.kernel, strides=self.strides,
                              lat_mode=self.lat_mode, dilation=self.dilation)
        return self._finish(y)


class RowConv2D(ParamLayer):
    """Latitude-dependent convolution (``layers.py:137``, the reference's
    ``RowConnected2D``): a filter bank per output row, ``kernel`` (H, O,
    C, kh, kw) and ``bias`` (H, O). H is ``nlat``, or the input's rows."""

    def __init__(self, features, kernel_size=3, nlat=None,
                 activation="linear", lat_mode="zero", use_bias=True):
        super().__init__()
        self.features = features
        self.kernel_size = pair(kernel_size)
        self.nlat = nlat
        self.activation = activation
        self.lat_mode = lat_mode
        self.use_bias = use_bias
        self.register_parameter("kernel", None)
        self.register_parameter("bias", None)

    def in_channels(self, x):
        return (x.shape[-3], self.nlat or x.shape[-2])

    def param_names(self):
        return ("kernel", "bias") if self.use_bias else ("kernel",)

    def flax_dims(self, shapes):
        k = shapes.get("kernel")
        return (k[2], k[0]) if k is not None and len(k) == 5 else (-1, -1)

    def param_shapes(self, dims):
        c_in, H = dims
        shapes = {"kernel": (H, self.features, c_in) + self.kernel_size}
        if self.use_bias:
            shapes["bias"] = (H, self.features)
        return shapes

    def _initializer(self, name):
        if name == "kernel":
            return functools.partial(_glorot, in_axis=2, out_axis=1)
        return super()._initializer(name)

    def forward(self, x):
        self._require_built(x)
        y = row_conv2d(x, self.kernel, self.bias, lat_mode=self.lat_mode)
        return get_activation(self.activation)(y)


class FusedConvPool2D(_ConvBase):
    """CyclicConv2D(3x3) + activation + MaxPool2D(2) (``layers.py:410``).

    What :meth:`uses_kernel` admits goes through ``fused_conv_pool`` (its
    kernel on the card, its plain version on the CPU); any other case runs
    the composition conv -> bias -> activation -> pool, as the JAX layer
    composes the ops outside its float32 Pallas branch. While a gradient
    is recorded the layer runs the composition, whose backward autograd
    has: the kernel is forward only, as the JAX Pallas kernel has no VJP
    and the JAX layer trains through the composition.
    """

    def __init__(self, features, kernel_size=3, dilation=1,
                 activation="tanh", use_bias=True):
        super().__init__(features, kernel_size, dilation, activation, use_bias)

    def uses_kernel(self, x) -> bool:
        """A 3x3 tanh stage on an even float32 grid, at a dilation below
        the width, as the JAX layer's Pallas branch takes it, and no
        gradient to record for x, the kernel or the bias."""
        d = self.dilation
        return (
            self.kernel_size == (3, 3)
            and d[0] == d[1]
            and 1 <= d[0] < x.shape[-1]
            and self.activation == "tanh"
            and x.dim() == 4
            and x.shape[-1] % 2 == 0
            and x.shape[-2] % 2 == 0
            and self._forward_float32(x)
        )

    def forward(self, x):
        self._require_built(x)
        if self.uses_kernel(x):
            return fused_conv_pool(x, self.kernel, self.bias,
                                   dilation=self.dilation[0])
        y = self._finish(cyclic_conv2d(x, self.kernel, dilation=self.dilation))
        return max_pool2d(y, (2, 2))


class SplitConvPool2D(_ConvBase):
    """CyclicConv2D + channel split + MaxPool2D(2) on the kept half
    (``layers.py:522``): the first ``keep`` channels go down through the
    pool, the rest come back at full resolution as a skip. Returns
    ``(pooled, skip)``. For even dilations on an even grid with a
    nondecreasing activation the pooled half runs on the quarter-grid
    parity planes (:func:`~dlwp_torch.ops.conv.conv_pool2_even_dilation`),
    else conv -> bias -> activation -> pool. Parameters are a
    ``CyclicConv2D(features)``'s."""

    def __init__(self, features, keep, kernel_size=3, dilation=1,
                 activation="tanh", use_bias=True):
        super().__init__(features, kernel_size, dilation, activation, use_bias)
        self.keep = keep

    def forward(self, x):
        self._require_built(x)
        k, d = self.keep, self.dilation
        act = get_activation(self.activation)

        def finish(y, bias):
            return act(y if bias is None else y + bias[:, None, None])

        bias = self.bias
        skip = finish(cyclic_conv2d(x, self.kernel[k:], dilation=d),
                      None if bias is None else bias[k:])
        kept = None if bias is None else bias[:k]
        if (d[0] % 2 == 0 and d[1] % 2 == 0 and x.shape[-1] % 2 == 0
                and x.shape[-2] % 2 == 0
                and self.activation in MONOTONE_ACTIVATIONS):
            pooled = finish(conv_pool2_even_dilation(x, self.kernel[:k],
                                                     dilation=d), kept)
        else:
            pooled = max_pool2d(
                finish(cyclic_conv2d(x, self.kernel[:k], dilation=d), kept),
                (2, 2))
        return pooled, skip


class UpConv2D(_ConvBase):
    """UpSampling2D(2) + CyclicConv2D collapsed onto the small grid
    (``layers.py:601``). ``emit_small``: a dilation-2 conv whose output
    stays on the small grid for an ``input_small`` consumer. What
    :meth:`uses_kernel` admits goes through ``cyclic_conv``: the
    ``emit_small`` conv, and the parity form of ``conv_after_upsample2``
    with each parity channel stored in its place on the large grid; any
    other case runs the composition."""

    def __init__(self, features, kernel_size=3, dilation=1,
                 activation="linear", use_bias=True, emit_small=False,
                 input_small=False):
        super().__init__(features, kernel_size, dilation, activation, use_bias)
        if emit_small and self.dilation != (2, 2):
            raise ValueError("emit_small needs dilation 2")
        self.emit_small = emit_small
        self.input_small = input_small

    def uses_kernel(self, x) -> bool:
        """The ``emit_small`` 3x3 conv, or the parity form (dilation 1, an
        odd square kernel of at most 5), and what every kernel route
        needs (:meth:`_kernel_takes`)."""
        kh, kw = self.kernel_size
        shape_ok = (kh == kw == 3 if self.emit_small else
                    self.dilation == (1, 1) and kh == kw and kh % 2 == 1
                    and kh <= 5)
        return shape_ok and self._kernel_takes(x)

    def forward(self, x):
        self._require_built(x)
        if self.uses_kernel(x):
            return self._kernel_conv(x, upsample=not self.emit_small)
        if self.emit_small:
            y = cyclic_conv2d(x, self.kernel)
        else:
            y = conv_after_upsample2(x, self.kernel, dilation=self.dilation)
        return self._finish(y)


class ConvLSTM2D(ParamLayer):
    """Convolutional LSTM over (B, T, C, H, W) (``layers.py:190``).

    Keras semantics: gates use ``recurrent_activation`` (default Keras
    hard_sigmoid), candidate and output use ``activation``; either may be a
    name of :func:`get_activation` or a callable. Both convs wrap
    longitude. Per step: the input conv (dilation d) plus bias, the
    recurrent conv (dilation 1), then the gate chain: the ``lstm_gates``
    kernel where :meth:`uses_kernel` admits the step, else the same chain
    in plain PyTorch ops with :func:`get_activation`. The first
    step starts from h = c = 0, so its recurrent conv and forget branch
    vanish and it runs as three plain ops. ``gate_dtype`` bf16 computes the
    gate chain in bf16 with the carry kept in the input dtype.

    The JAX layer unrolls 1 < T <= 4 and scans longer windows; in eager
    PyTorch both are the same Python loop. The input convs of all T steps
    run as one (T*B)-batched conv. ``spatial`` (a ``SpatialSharding``)
    sends both convs down the lat-band sharded path, as in
    :class:`CyclicConv2D`; the gates stay one ``lstm_gates`` call a step.
    """

    def __init__(self, features, kernel_size=3, dilation=1,
                 activation="tanh", recurrent_activation="hard_sigmoid",
                 return_sequences=True, lat_mode="zero", gate_dtype=None,
                 spatial=None):
        super().__init__()
        # Unknown names raise here, as in get_activation.
        get_activation(activation), get_activation(recurrent_activation)
        self.features = features
        self.kernel_size = pair(kernel_size)
        self.dilation = pair(dilation)
        self.activation = activation
        self.recurrent_activation = recurrent_activation
        self.return_sequences = return_sequences
        self.lat_mode = lat_mode
        if isinstance(gate_dtype, str):
            gate_dtype = getattr(torch, gate_dtype)
        if gate_dtype not in (None, torch.bfloat16):
            raise ValueError("gate_dtype must be None or bfloat16")
        self.gate_dtype = gate_dtype
        self.spatial = spatial
        for name in ("input_kernel", "recurrent_kernel", "bias"):
            self.register_parameter(name, None)

    def param_shapes(self, c_in):
        F4 = 4 * self.features
        return {
            "input_kernel": (F4, c_in) + self.kernel_size,
            "recurrent_kernel": (F4, self.features) + self.kernel_size,
            "bias": (F4,),
        }

    def _initializer(self, name):
        if name == "recurrent_kernel":
            return _orthogonal
        return super()._initializer(name)

    def in_channels(self, x):
        return x.shape[2]

    def uses_kernel(self, zx, zh, c) -> bool:
        """Whether a step t >= 1 goes to ``lstm_gates`` (its kernel on the
        card, its plain version on the CPU): activations the kernel has,
        by name, and float32 ``zx``, ``zh`` and ``c``."""
        return (
            all(isinstance(a, str) and a in ACT_CODES
                for a in (self.activation, self.recurrent_activation))
            and all(t.dtype == torch.float32 for t in (zx, zh, c))
        )

    def forward(self, x):
        self._require_built(x)
        B, T, C, H, W = x.shape
        gd = self.gate_dtype
        act = get_activation(self.activation)
        r_act = get_activation(self.recurrent_activation)

        def conv(v, k, dilation=(1, 1)):
            fn = cyclic_conv2d if self.spatial is None else self.spatial.conv
            return fn(v, k, lat_mode=self.lat_mode, dilation=dilation)

        # Time-major, so each step's zx slice is contiguous.
        x_tm = x.transpose(0, 1).reshape(T * B, C, H, W)
        zx = conv(x_tm, self.input_kernel, self.dilation)
        zx = (zx + self.bias[:, None, None]).reshape(T, B, -1, H, W)

        z0 = zx[0] if gd is None else zx[0].to(gd)
        i0, _, g0, o0 = torch.chunk(z0, 4, dim=-3)
        c = r_act(i0) * act(g0)
        h = (r_act(o0) * act(c)).to(x.dtype)
        c = c.to(x.dtype)
        hs = [h]
        for t in range(1, T):
            zh = conv(h, self.recurrent_kernel)
            if self.uses_kernel(zx[t], zh, c):
                h, c = lstm_gates(zx[t], zh, c, self.activation,
                                  self.recurrent_activation, gd)
            else:
                h, c = gate_chain(zx[t], zh, c, act, r_act, gd)
            hs.append(h)
        if self.return_sequences:
            return torch.stack(hs, dim=1)
        return h


class Identity(nn.Module):
    """No-op filler that keeps layer indices equal to the flax slots."""

    def forward(self, x):
        return x


class MaxPool2D(nn.Module):
    def __init__(self, window=2):
        super().__init__()
        self.window = pair(window)

    def forward(self, x):
        return max_pool2d(x, self.window)


class AvgPool2D(nn.Module):
    def __init__(self, window=2):
        super().__init__()
        self.window = pair(window)

    def forward(self, x):
        return avg_pool2d(x, self.window)


class UpSampling2D(nn.Module):
    def __init__(self, factor=2):
        super().__init__()
        self.factor = pair(factor)

    def forward(self, x):
        return upsample2d(x, self.factor)


class Reshape(nn.Module):
    """Reshape the non-batch dims (Keras ``Reshape``)."""

    def __init__(self, shape):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.shape)


class Activation(nn.Module):
    def __init__(self, fn="linear"):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return get_activation(self.fn)(x)

"""Routing of the layers to their kernels, and the gates' gradient.

- ``ConvLSTM2D`` takes every activation of ``get_activation`` and
  callables, as the JAX layer does: 'relu' and a callable, T = 3, against
  the JAX layer in float64 from one seeded weight set (1e-10, float64
  rounding).
- The routing predicates (``uses_kernel``) send only float32 operands at
  what the kernels take to the wrappers (the conv-pool kernel at any
  dilation below the width, as the JAX layer's Pallas branch); float64,
  bf16 and activations the kernel lacks go to the composition or the
  plain gate chain, and their forward agrees with the kernel's plain
  version.
- ``lstm_gates`` is the custom op ``dlwp_torch::lstm_gates`` with a
  registered backward: gradcheck in float64, and its gradients equal
  autograd through ``lstm_gates_plain`` (its backward is that version's
  VJP, so exactly).

The card's side (float64 predict on ``cuda``, the CUDA gate gradient,
``fused_conv_pool`` refusing operands that require grad) is in
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlwp_tpu.models import layers as JL

from dlwp_torch.kernels import lstm_gates, lstm_gates_plain
from dlwp_torch.kernels.fused_conv_pool import fused_conv_pool_plain
from dlwp_torch.models import layers as TL
from dlwp_torch.models.cnn import SequentialModel
from dlwp_torch.weights import load_flax_params

torch.set_num_threads(2)
TOL = 1e-10


def softsign(v):
    """A callable activation both frameworks can apply."""
    return v / (1 + abs(v))


def _run_convlstm(x, **kw):
    """The same seeded weights through the JAX layer (its default XLA gate
    path) and the port's layer, float64."""
    port = SequentialModel([TL.ConvLSTM2D(4, **kw)], device="cpu")
    port.init(torch.from_numpy(x), seed=3)
    tree = {"params": {"layers_0": {
        k: p.numpy().copy() for k, p in port.layers[0].named_parameters()}}}
    want = np.asarray(JL.ConvLSTM2D(features=4, **kw).apply(
        {"params": tree["params"]["layers_0"]}, jnp.asarray(x)))
    model = SequentialModel([TL.ConvLSTM2D(4, **kw)], device="cpu")
    load_flax_params(model, tree, dtype=torch.float64)
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy(), want


@pytest.mark.parametrize("option", [
    {"activation": "relu"},
    {"activation": softsign},
    {"recurrent_activation": softsign},
    {"activation": "elu", "recurrent_activation": "sigmoid"},
], ids=["relu", "callable", "callable_gate", "elu"])
def test_convlstm_any_activation_matches_jax(option, monkeypatch):
    monkeypatch.delenv("DLWP_CONVLSTM_JOINT", raising=False)
    x = np.random.RandomState(4).randn(2, 3, 3, 6, 8)
    got, want = _run_convlstm(x, kernel_size=3, dilation=2, **option)
    assert got.shape == (2, 3, 4, 6, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_convlstm_refuses_unknown_activation_name():
    with pytest.raises(ValueError, match="unknown activation"):
        TL.ConvLSTM2D(4, activation="mish")
    zx, zh, c = _gate_operands(0, torch.float64)
    with pytest.raises(ValueError, match="lstm gates support"):
        lstm_gates(zx, zh, c, "relu")


def _built(layer, x):
    SequentialModel([layer], device="cpu").init(x, seed=0)
    return layer


@pytest.mark.parametrize("dtype,dilation,want", [
    (torch.float32, 1, True),
    (torch.float32, 2, True),
    (torch.float32, 8, True),
    (torch.float64, 2, False),
    (torch.bfloat16, 2, False),
    (torch.float32, 9, True),
    (torch.float32, 23, True),
])
def test_conv_pool_routing(dtype, dilation, want, monkeypatch):
    """float32 at any dilation below the width goes to the wrapper, as the
    JAX layer sends it to its Pallas kernel; float64 and bf16 run conv ->
    bias -> tanh -> pool, which equals the kernel's plain version."""
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 8, 24)).to(dtype)
    layer = _built(TL.FusedConvPool2D(5, 3, dilation=dilation), x)
    assert layer.uses_kernel(x) is want
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(args[0].dtype)
        return fused_conv_pool_plain(*args, **kwargs)

    monkeypatch.setattr(TL, "fused_conv_pool", wrapper)
    with torch.inference_mode():
        got = layer(x)
    assert calls == ([dtype] if want else [])
    ref = fused_conv_pool_plain(x.double(), layer.kernel.double(),
                                layer.bias.double(), dilation)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-6
    assert got.dtype == dtype and got.shape == (2, 5, 4, 12)
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=tol)


def test_conv_pool_routing_other_shapes():
    x = torch.zeros(1, 3, 8, 8)
    assert not _built(TL.FusedConvPool2D(5, 3, dilation=8), x).uses_kernel(x)
    assert _built(TL.FusedConvPool2D(5, 3, dilation=7), x).uses_kernel(x)
    for layer in (TL.FusedConvPool2D(5, 5),
                  TL.FusedConvPool2D(5, 3, activation="relu"),
                  TL.FusedConvPool2D(5, 3, dilation=(1, 2))):
        assert not _built(layer, x).uses_kernel(x)
    odd = torch.zeros(1, 3, 7, 8)
    assert not _built(TL.FusedConvPool2D(5, 3), odd).uses_kernel(odd)


def _gate_operands(seed, dtype, B=2, F=3, H=4, W=5, scale=1.0):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(scale * rng.randn(*s)).to(dtype)
                 for s in ((B, 4 * F, H, W), (B, 4 * F, H, W), (B, F, H, W)))


@pytest.mark.parametrize("dtype,kw,want", [
    (torch.float32, {}, True),
    (torch.float32, {"recurrent_activation": "sigmoid"}, True),
    (torch.float32, {"gate_dtype": "bfloat16"}, True),
    (torch.float64, {}, False),
    (torch.bfloat16, {}, False),
    (torch.float32, {"activation": "relu"}, False),
    (torch.float32, {"activation": softsign}, False),
])
def test_convlstm_routing(dtype, kw, want, monkeypatch):
    """Steps t >= 1 go to ``lstm_gates`` only for float32 operands and
    activations the kernel has; the rest run the plain gate chain."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 2, 4, 6))
    layer = _built(TL.ConvLSTM2D(3, **kw), x.to(dtype))
    zx, zh, c = _gate_operands(1, dtype)
    assert layer.uses_kernel(zx, zh, c) is want
    calls = []

    def wrapper(*args):
        calls.append(args[0].dtype)
        return lstm_gates_plain(*args)

    monkeypatch.setattr(TL, "lstm_gates", wrapper)
    with torch.inference_mode():
        out = layer(x.to(dtype))
    assert out.dtype == dtype and out.shape == (2, 3, 3, 4, 6)
    assert calls == ([dtype] * 2 if want else [])


@pytest.mark.parametrize("acts", [("tanh", "hard_sigmoid"),
                                  ("tanh", "sigmoid"), ("linear", "sigmoid")])
def test_lstm_gates_gradcheck(acts):
    # Inputs at a third of unit scale keep hard_sigmoid's kinks (|t| = 2.5)
    # out of gradcheck's finite differences.
    ops = [t.requires_grad_() for t in _gate_operands(3, torch.float64,
                                                       scale=0.3)]
    h, _ = lstm_gates(*ops, *acts)
    # The op's registered backward, not autograd through the plain ops.
    assert type(h.grad_fn).__name__ == (
        "GeneratedBackwardFor_dlwp_torch_lstm_gates_defaultBackward")
    assert torch.autograd.gradcheck(lambda *a: lstm_gates(*a, *acts), ops)


@pytest.mark.parametrize("gate_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("wrt", [(0, 1, 2), (1,), (2,)])
def test_lstm_gates_gradient_equals_plain(gate_dtype, wrt):
    """The Function's gradients are autograd's through the plain version,
    for any subset of operands that require grad."""
    base = _gate_operands(6, torch.float32)
    rng = np.random.RandomState(7)
    gh, gc = (torch.from_numpy(rng.randn(*base[2].shape)).float()
              for _ in range(2))
    grads = []
    for fn in (lstm_gates, lstm_gates_plain):
        ops = [t.clone().requires_grad_(i in wrt) for i, t in enumerate(base)]
        h, c = fn(*ops, "tanh", "hard_sigmoid", gate_dtype)
        torch.autograd.backward((h, c), (gh, gc))
        grads.append([t.grad for t in ops])
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)

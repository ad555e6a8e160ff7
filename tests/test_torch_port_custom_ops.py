"""The two main-path kernels as torch custom ops, on the CPU.

``dlwp_torch::fused_conv_pool`` and ``dlwp_torch::lstm_gates`` pass
``torch.library.opcheck`` (schema, autograd registration, fake
implementation, AOT dispatch with dynamic shapes; for the gates with
operands that require grad, so the registered backward is traced too).
Their fake implementations give the output shapes for a symbolic batch.
The CUDA implementations' checks run before any launch, so they are
exercised here on CPU tensors: each refuses what the kernel does not
take (dtype, layout, shapes, activations, operands that require grad for
the forward-only conv-pool) with an error, and nothing is launched or
counted. The CPU implementations are the plain versions (bit for bit).
"""

import importlib

import numpy as np
import pytest
import torch
from torch.export import Dim

from dlwp_torch.kernels import (
    fused_conv_pool,
    fused_conv_pool_plain,
    launch_counts,
    lstm_gates,
    lstm_gates_plain,
    reset_launch_counts,
)

from tests.torch_port_threads import one_blas_thread  # noqa: F401

# The modules (the package's names are the wrappers).
conv_pool_module = importlib.import_module("dlwp_torch.kernels.fused_conv_pool")
gates_module = importlib.import_module("dlwp_torch.kernels.lstm_gates")

torch.set_num_threads(2)
CONV_POOL = torch.ops.dlwp_torch.fused_conv_pool.default
GATES = torch.ops.dlwp_torch.lstm_gates.default


def _conv_pool_operands(seed=0, B=2, C=5, H=6, W=8, O=7):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)),
            torch.from_numpy((rng.randn(O, C, 3, 3) / 6).astype(np.float32)),
            torch.from_numpy(rng.randn(O).astype(np.float32)))


def _gate_operands(seed=0, B=2, F=3, H=4, W=6):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in ((B, 4 * F, H, W), (B, 4 * F, H, W), (B, F, H, W)))


@pytest.mark.parametrize("bias,dilation", [(True, 1), (True, 2), (False, 3)])
def test_conv_pool_opcheck(bias, dilation):
    x, k, b = _conv_pool_operands(1)
    torch.library.opcheck(CONV_POOL, (x, k, b if bias else None, dilation))


@pytest.mark.parametrize("gate_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("grad", [False, True])
def test_gates_opcheck(gate_dtype, grad):
    ops = [t.requires_grad_(grad) for t in _gate_operands(2)]
    torch.library.opcheck(GATES, (*ops, "tanh", "hard_sigmoid", gate_dtype))


def test_cpu_implementations_are_the_plain_versions():
    reset_launch_counts()
    x, k, b = _conv_pool_operands(3)
    assert torch.equal(fused_conv_pool(x, k, b, 2),
                       fused_conv_pool_plain(x, k, b, 2))
    ops = _gate_operands(4)
    for got, want in zip(lstm_gates(*ops, "tanh", "sigmoid", torch.bfloat16),
                         lstm_gates_plain(*ops, "tanh", "sigmoid",
                                          "bfloat16")):
        assert torch.equal(got, want)
    assert set(launch_counts().values()) == {0}


class _Pair(torch.nn.Module):
    def forward(self, x, k, zx, zh, c):
        return fused_conv_pool(x, k, None, 2), *lstm_gates(zx, zh, c)


def test_fake_implementations_follow_a_symbolic_batch():
    x, k, _ = _conv_pool_operands(5, B=3)
    gates = _gate_operands(6, B=3)
    b = Dim("b")
    program = torch.export.export(
        _Pair(), (x, k, *gates),
        dynamic_shapes=({0: b}, None, {0: b}, {0: b}, {0: b}))
    module = program.module()
    for B in (1, 2, 5):
        xb, _, _ = _conv_pool_operands(7, B=B)
        gb = _gate_operands(8, B=B)
        y, h, c = module(xb, k, *gb)
        assert y.shape == (B, 7, 3, 4) and h.shape == c.shape == (B, 3, 4, 6)
        assert torch.equal(y, fused_conv_pool_plain(xb, k, None, 2))
        assert torch.equal(h, lstm_gates_plain(*gb)[0])


def _conv_pool_case(case):
    x, k, b = _conv_pool_operands(9)
    if case == "float64":
        return x.double(), k.double(), b.double(), 2
    if case == "strided":
        return x.transpose(2, 3).contiguous().transpose(2, 3), k, b, 2
    if case == "odd_grid":
        return x[..., :5, :].contiguous(), k, b, 2
    if case == "bias_shape":
        return x, k, b[:-1].contiguous(), 2
    return x, k.requires_grad_(True), b, 2  # requires_grad


@pytest.mark.parametrize("case", ["float64", "strided", "odd_grid",
                                  "bias_shape", "requires_grad"])
def test_conv_pool_cuda_implementation_refuses(case):
    """The op's CUDA implementation, which an exported program calls
    without the Python wrapper, checks before it launches."""
    reset_launch_counts()
    err = NotImplementedError if case == "requires_grad" else ValueError
    with pytest.raises(err):
        conv_pool_module._op_cuda(*_conv_pool_case(case))
    assert launch_counts()["fused_conv_pool"] == 0


@pytest.mark.parametrize("case", ["float64", "strided", "shapes",
                                  "activation", "gate_dtype"])
def test_gates_cuda_implementation_refuses(case):
    reset_launch_counts()
    zx, zh, c = _gate_operands(10)
    acts = ["tanh", "hard_sigmoid", None]
    if case == "float64":
        c = c.double()
    elif case == "strided":
        zh = zh.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "shapes":
        c = c[:, :-1].contiguous()
    elif case == "activation":
        acts[1] = "relu"
    else:
        acts[2] = "float16"
    with pytest.raises(ValueError):
        gates_module._op_cuda(zx, zh, c, *acts)
    assert launch_counts()["lstm_gates"] == 0


def test_conv_pool_wrapper_refuses_grad_and_detaches_without(monkeypatch):
    """Forward only on both devices: under a recorded gradient the wrapper
    refuses; under no_grad it hands the op detached operands (which the
    CUDA implementation requires)."""
    x, k, b = _conv_pool_operands(11)
    k.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        fused_conv_pool(x, k, b, 1)
    seen = []
    real = conv_pool_module._op

    def spy(*args):
        seen.append([t.requires_grad for t in args[:3]])
        return real(*args)

    monkeypatch.setattr(conv_pool_module, "_op", spy)
    with torch.no_grad():
        y = fused_conv_pool(x, k, b, 1)
    assert seen == [[False, False, False]]
    assert torch.equal(y, fused_conv_pool_plain(x, k.detach(), b, 1))

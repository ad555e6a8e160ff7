"""The port's CUDA kernels on the card (skipped without one).

This file imports no JAX, so it also runs on a machine that has only
PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs
(fp32 1e-5: only the summation order differs; bf16 gates 5e-2, a few bf16
rounding steps near 1), and the fused flagship on the card against the
same model on the CPU.
"""

import numpy as np
import pytest
import torch

from dlwp_torch import build_sequential
from dlwp_torch.flagship import convlstm_specs
from dlwp_torch.kernels import (
    fused_conv_pool,
    fused_conv_pool_plain,
    launch_counts,
    lstm_gates,
    lstm_gates_plain,
    reset_launch_counts,
)

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from dlwp_torch.device import resolve_device

    return resolve_device("cuda")


def _conv_pool_operands(seed, B, C, H, W, O):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, C, H, W).astype(np.float32),
            (rng.randn(O, C, 3, 3) / np.sqrt(9 * C)).astype(np.float32),
            (0.1 * rng.randn(O)).astype(np.float32))


def _gate_operands(seed, B=3, F=5, H=9, W=17):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 4 * F, H, W).astype(np.float32),
            rng.randn(B, 4 * F, H, W).astype(np.float32),
            rng.randn(B, F, H, W).astype(np.float32))


def test_kernels_match_plain_on_card(dev):
    reset_launch_counts()
    for dil in (1, 2, 3):
        x, k, b = (torch.from_numpy(a).to(dev) for a in _conv_pool_operands(
            dil, B=3, C=11, H=10, W=18, O=37))
        torch.testing.assert_close(fused_conv_pool(x, k, b, dil),
                                   fused_conv_pool_plain(x, k, b, dil),
                                   rtol=0, atol=1e-5)
    zx, zh, c = (torch.from_numpy(a).to(dev) for a in _gate_operands(7))
    for ra in ("hard_sigmoid", "sigmoid"):
        for gd in (None, "bfloat16"):
            tol = 1e-5 if gd is None else 5e-2
            for got, want in zip(lstm_gates(zx, zh, c, "tanh", ra, gd),
                                 lstm_gates_plain(zx, zh, c, "tanh", ra, gd)):
                torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert launch_counts() == {"fused_conv_pool": 3, "lstm_gates": 4}


def test_flagship_on_card_matches_cpu(dev):
    """Three autoregressive steps of the fused flagship at 8x16 through the
    kernels, against the CPU model (plain versions) with the same weights;
    fp32 on both sides, so 1e-4 covers the summation order."""
    specs = convlstm_specs(8, 16)
    x = torch.from_numpy(
        np.random.RandomState(0).randn(2, 2, 3, 8, 16).astype(np.float32))
    cpu = build_sequential(specs, device="cpu").init(x, seed=1)
    card = build_sequential(specs, device=dev)
    card.init(x, seed=1)
    reset_launch_counts()
    xs = {"cpu": x, "cuda": x.to(dev)}
    with torch.inference_mode():
        for _ in range(3):
            for name, model in (("cpu", cpu), ("cuda", card)):
                v = xs[name]
                xs[name] = torch.cat([model(v), v[:, :, 2:3]], dim=2)
    assert launch_counts() == {"fused_conv_pool": 6, "lstm_gates": 3}
    torch.testing.assert_close(xs["cuda"].cpu(), xs["cpu"], rtol=0, atol=1e-4)

"""The port's kernels: plain versions vs the Pallas functions, dispatch rules.

The plain PyTorch versions of ``fused_conv_pool`` and ``lstm_gates`` are held
against the JAX package's Pallas kernels run as its own tests run them on the
CPU (interpret mode). A CPU tensor must take the plain version and never
touch the launch counter; the CUDA kernels themselves are checked on the
card by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlwp_tpu.ops.fused_stages import fused_conv_pool as jax_conv_pool
from dlwp_tpu.ops.lstm_gates import fused_lstm_gates as jax_gates

from dlwp_torch.kernels import (
    cube_pad,
    cyclic_conv,
    cyclic_conv_plain,
    fused_conv_pool,
    fused_conv_pool_plain,
    halo_exchange,
    halo_exchange_plain,
    launch_counts,
    lstm_gates,
    lstm_gates_plain,
    overlap_conv,
    overlap_conv_db,
    overlap_conv_plain,
    reset_launch_counts,
)
from dlwp_torch.ops.padding import cube_pad_plain

torch.set_num_threads(2)


def _conv_pool_operands(seed, B=2, C=5, H=8, W=12, O=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, C, H, W).astype(np.float32),
            (rng.randn(O, C, 3, 3) / np.sqrt(9 * C)).astype(np.float32),
            (0.1 * rng.randn(O)).astype(np.float32))


def _gate_operands(seed, B=3, F=5, H=9, W=17):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 4 * F, H, W).astype(np.float32),
            rng.randn(B, 4 * F, H, W).astype(np.float32),
            rng.randn(B, F, H, W).astype(np.float32))


@pytest.mark.parametrize("dil", [1, 2])
def test_fused_conv_pool_plain_matches_pallas(dil):
    x, k, b = _conv_pool_operands(dil)
    want = jax_conv_pool(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                         dilation=dil, interpret=True)
    got = fused_conv_pool_plain(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(b), dil)
    assert got.shape == (2, 6, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("gate_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("ra", ["hard_sigmoid", "sigmoid"])
def test_lstm_gates_plain_matches_pallas(ra, gate_dtype):
    zx, zh, c = _gate_operands(0)
    h1, c1 = jax_gates(jnp.asarray(zx), jnp.asarray(zh), jnp.asarray(c),
                       "tanh", ra, None if gate_dtype is None else jnp.bfloat16)
    h2, c2 = lstm_gates_plain(torch.from_numpy(zx), torch.from_numpy(zh),
                              torch.from_numpy(c), "tanh", ra, gate_dtype)
    assert h2.dtype == c2.dtype == torch.float32
    tol = 5e-6 if gate_dtype is None else 5e-2
    np.testing.assert_allclose(h2.numpy(), np.asarray(h1), atol=tol)
    np.testing.assert_allclose(c2.numpy(), np.asarray(c1), atol=tol)


def test_cpu_tensors_take_plain_version_without_counting():
    reset_launch_counts()
    x, k, b = (torch.from_numpy(a) for a in _conv_pool_operands(3))
    torch.testing.assert_close(fused_conv_pool(x, k, b, 2),
                               fused_conv_pool_plain(x, k, b, 2),
                               rtol=0, atol=0)
    zx, zh, c = (torch.from_numpy(a) for a in _gate_operands(4))
    for got, want in zip(lstm_gates(zx, zh, c), lstm_gates_plain(zx, zh, c)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    shards = [[x[:, :, :4], x[:, :, 4:]]]
    for got, want in zip(halo_exchange(shards, (1, 2))[0],
                         halo_exchange_plain(shards, (1, 2))[0]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got in (overlap_conv(shards, k)[0], overlap_conv_db(shards, k, 1)[0]):
        for a, b_ in zip(got, overlap_conv_plain(shards, k)[0]):
            torch.testing.assert_close(a, b_, rtol=0, atol=0)
    eq, pol = torch.randn(8, 3, 4, 4), torch.randn(4, 3, 4, 4)
    torch.testing.assert_close(cube_pad(eq, pol), cube_pad_plain(eq, pol),
                               rtol=0, atol=0)
    for upsample in (False, True):
        torch.testing.assert_close(
            cyclic_conv(x, k, b, "tanh", upsample),
            cyclic_conv_plain(x, k, b, "tanh", upsample), rtol=0, atol=0)
    assert launch_counts() == {"fused_conv_pool": 0, "lstm_gates": 0,
                               "barotropic_step": 0, "halo_exchange": 0,
                               "overlap_conv": 0, "overlap_conv_db": 0,
                               "cube_pad": 0, "cyclic_conv": 0}


@pytest.mark.parametrize("case", ["odd_grid", "bad_kernel", "meta_device",
                                  "gate_shapes", "gate_activation"])
def test_wrappers_reject_bad_inputs(case):
    x, k, b = (torch.from_numpy(a) for a in _conv_pool_operands(5))
    zx, zh, c = (torch.from_numpy(a) for a in _gate_operands(6))
    with pytest.raises(ValueError):
        if case == "odd_grid":
            fused_conv_pool(x[..., :7, :], k, b)
        elif case == "bad_kernel":
            fused_conv_pool(x, k[..., :2], b)
        elif case == "meta_device":
            fused_conv_pool(x.to("meta"), k.to("meta"), b.to("meta"))
        elif case == "gate_shapes":
            lstm_gates(zx, zh[:, :-1], c)
        else:
            lstm_gates(zx, zh, c, "tanh", "relu")

"""Parity of the port's ops (dlwp_torch.ops, dlwp_torch.grid) with dlwp_tpu.

The same float64 inputs, made with numpy from a seed, go through the JAX
function and its PyTorch counterpart on the CPU; tolerances are at float64
rounding level (1e-10).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlwp_tpu.ops import conv as jconv
from dlwp_tpu.ops import padding as jpad
from dlwp_tpu.ops import pooling as jpool

from dlwp_torch.ops import conv as tconv
from dlwp_torch.ops import padding as tpad
from dlwp_torch.ops import pooling as tpool

torch.set_num_threads(2)
# The grid packages re-export the function ``insolation`` over the module.
jins = importlib.import_module("dlwp_tpu.grid.insolation")
tins = importlib.import_module("dlwp_torch.grid.insolation")
TOL = 1e-10


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("lat_mode", ["zero", "edge", "reflect", "symmetric"])
def test_pad_latlon(lat_mode):
    x = _rand(0, 2, 3, 7, 10)
    want = jpad.pad_latlon(jnp.asarray(x), (2, 1), (3, 2), lat_mode=lat_mode)
    got = tpad.pad_latlon(_t(x), (2, 1), (3, 2), lat_mode=lat_mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dil", [1, 2])
@pytest.mark.parametrize("lat_mode", ["zero", "edge", "reflect", "symmetric"])
def test_cyclic_conv2d(lat_mode, dil, k):
    x = _rand(1, 2, 3, 11, 14)
    w = _rand(2, 4, 3, k, k)
    want = jconv.cyclic_conv2d(jnp.asarray(x), jnp.asarray(w),
                               lat_mode=lat_mode, dilation=(dil, dil))
    got = tconv.cyclic_conv2d(_t(x), _t(w), lat_mode=lat_mode,
                              dilation=(dil, dil))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_cyclic_conv2d_strided_leading_dims():
    x = _rand(3, 2, 2, 3, 8, 12)  # two leading batch dims
    w = _rand(4, 5, 3, 3, 3)
    want = jconv.cyclic_conv2d(jnp.asarray(x), jnp.asarray(w), strides=(2, 2))
    got = tconv.cyclic_conv2d(_t(x), _t(w), strides=(2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dil", [1, 2])
def test_conv_after_upsample2(dil, k):
    a = _rand(5, 2, 3, 5, 8)
    w = _rand(6, 4, 3, k, k)
    want = jconv.conv_after_upsample2(jnp.asarray(a), jnp.asarray(w),
                                      dilation=(dil, dil))
    got = tconv.conv_after_upsample2(_t(a), _t(w), dilation=(dil, dil))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # and against the definition: conv of the upsampled grid
    direct = tconv.cyclic_conv2d(tpool.upsample2d(_t(a)), _t(w),
                                 dilation=(dil, dil))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=TOL)


@pytest.mark.parametrize("op", ["max_pool2d", "avg_pool2d", "upsample2d"])
def test_pooling(op):
    x = _rand(7, 2, 3, 8, 12)
    want = getattr(jpool, op)(jnp.asarray(x), (2, 2))
    got = getattr(tpool, op)(_t(x), (2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_day_of_year():
    dates = (np.datetime64("2007-01-01")
             + np.arange(0, 800, 37) * np.timedelta64(6, "h"))
    np.testing.assert_array_equal(tins.day_of_year(dates),
                                  jins.day_of_year(dates))


def test_insolation():
    lat = np.linspace(87.5, -87.5, 9)
    lon = np.arange(16) * 22.5
    days = np.array([0.25, 80.5, 172.0, 300.75, 364.9])
    want = np.asarray(jins.insolation(jnp.asarray(days), lat, lon))
    np.testing.assert_allclose(tins.insolation(days, lat, lon), want,
                               atol=TOL)
    np.testing.assert_allclose(tins.insolation(days[1], lat, lon), want[1],
                               atol=TOL)


def test_insolation_from_tables():
    lat = np.linspace(87.5, 0.0, 8)
    lon = np.arange(16) * 22.5
    days = np.random.RandomState(8).uniform(0, 365, (3, 2))
    tables = tins.insolation_tables(lat, lon, dtype=np.float64)
    np.testing.assert_array_equal(
        tables, jins.insolation_tables(lat, lon, dtype=np.float64))
    want = jins.insolation_from_tables(jnp.asarray(days), jnp.asarray(tables))
    got = tins.insolation_from_tables(_t(days), _t(tables))
    assert got.shape == (3, 2, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)

"""The plain reference against ``dlwp_torch`` on the CPU at a tiny size:
the forward exactly (float64), the rollouts and train steps through the
harness's own comparison (float32)."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from h100bench import inputs, specs
from h100bench.reference import spec_net
from h100bench.tests import tiny


def tiny_cfg(name):
    cfg = copy.deepcopy(specs.load_json("configs", name))
    cfg["grid"] = dict(tiny.GRID)
    return cfg


@pytest.mark.parametrize("name", ["flagship", "tower"])
def test_forward_equals_the_program_in_float64(name):
    from dlwp_torch.models import DLWPNeuralNet

    cfg = tiny_cfg(name)
    w = inputs.make_weights(cfg, inputs.generator(5, "cpu"), "cpu")
    w = {k: v.double() for k, v in w.items()}
    net = DLWPNeuralNet(is_recurrent=cfg["is_recurrent"], time_dim=2,
                        scaler_type=None, device="cpu")
    net.build_model(specs.layers(cfg))
    inputs.load_into(net.base_model, w)
    x = torch.randn((3,) + spec_net.input_shape(cfg), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = net.base_model(x)
        ref = spec_net.forward(w, cfg, x)
    assert got.shape == ref.shape
    assert torch.allclose(got, ref, rtol=0, atol=1e-12)


def test_insolation_equals_the_program():
    from dlwp_torch.grid.insolation import day_of_year, insolation

    g = specs.Grid(**tiny.GRID)
    times = inputs.series_times(40)
    days = spec_net.day_of_year(times)
    assert np.array_equal(days, day_of_year(times))
    ref = spec_net.insolation(torch.as_tensor(days), g.lat(), g.lon())
    got = insolation(days, np.asarray(g.lat()), np.asarray(g.lon()))
    np.testing.assert_allclose(ref.numpy(), got, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("ref"))


@pytest.mark.parametrize("cell", ["flagship_tiny.forecast_tiny",
                                  "tower_tiny.forecast_tiny",
                                  "flagship_tiny.train_tiny"])
def test_program_agrees_with_the_reference(copy_root, cell):
    result = tiny.run(copy_root, cell)
    assert result["correct"], result["checks"]
    for row in result["checks"].values():
        assert row["value"] < 1e-5

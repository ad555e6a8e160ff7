"""Card tests of the cubed-sphere U-Net: the ``cube_pad`` kernel against its
plain version, and the cube forecast's CUDA graph replay against the eager
loop. Skipped without a card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cube_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dlwp_torch.kernels import cube_pad, launch_counts, reset_launch_counts
from dlwp_torch.ops.padding import cube_pad_plain, cube_pad_vjp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from dlwp_torch.device import resolve_device

    return resolve_device("cuda")


# (B, C, n, pad): the U-Net's pads at B = 64 (first, widest, smallest
# faces), then odd sizes and a wider halo.
PAD_CASES = [(64, 10, 48, 1), (64, 64, 48, 1), (64, 128, 12, 1),
             (3, 5, 7, 1), (2, 3, 9, 2), (1, 1, 4, 4)]


@pytest.mark.parametrize("B, C, n, pad", PAD_CASES)
def test_cube_pad_kernel_bit_equal_to_plain(dev, B, C, n, pad):
    """Forward: the kernel's padded field equals the plain gather bit for
    bit (one launch). Backward: the op's gradient is the plain VJP's."""
    g = torch.Generator(device=dev).manual_seed(B * 1000 + C + n)
    eq = torch.randn(4 * B, C, n, n, device=dev, generator=g)
    pol = torch.randn(2 * B, C, n, n, device=dev, generator=g)
    reset_launch_counts()
    got = cube_pad(eq, pol, pad)
    torch.cuda.synchronize()
    assert launch_counts()["cube_pad"] == 1
    assert torch.equal(got, cube_pad_plain(eq, pol, pad))
    leaves = [eq.clone().requires_grad_(True), pol.clone().requires_grad_(True)]
    out = cube_pad(*leaves, pad)
    grad = torch.randn(out.shape, device=dev, generator=g)
    out.backward(grad)
    want = cube_pad_vjp(grad, pad)
    assert torch.equal(leaves[0].grad, want[0])
    assert torch.equal(leaves[1].grad, want[1])


def _cube_estimator(dev, B: int, seed=0):
    """The cube U-Net at its published widths on 6 x 48 x 48 (4 fields,
    insolation) with seeded weights, its estimator and seeded inputs."""
    from dlwp_torch import PredictorDataset, SeriesSampler, TimeSeriesEstimator
    from dlwp_torch.grid.cubed_sphere import folded_lat_lon
    from dlwp_torch.models import DLWPNeuralNet

    n_face, n = 48, B + 6
    lat, lon = folded_lat_lon(n_face)
    rng = np.random.RandomState(seed)
    data = PredictorDataset(
        predictors=rng.randn(n, 4, 6 * n_face, n_face).astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["Z500", "TAU300-700", "Z1000", "T2m"], lat=lat, lon=lon)
    net = DLWPNeuralNet(time_dim=2, scaler_type=None, device=dev)
    net.build_model([("CubeUNet", [8], {"filters": [32, 64, 128]})])
    sampler = SeriesSampler(data, model=net, input_time_steps=2,
                            output_time_steps=2, add_insolation=True,
                            batch_size=B)
    net.init(sampler.generate(np.arange(1))[0], seed=seed + 1)
    est = TimeSeriesEstimator(net, sampler)
    x0, days, mean_state, _ = est.prepare_inputs(np.arange(B))
    return est, (x0, days, mean_state)


@pytest.mark.parametrize("B", [1, 8])
def test_cube_graph_rollout_equals_eager_on_card(dev, monkeypatch, B):
    """The cube forecast replays CUDA graphs (one capture, a replay a step
    after the first) and is bit-equal to the eager loop, with the same
    ``cube_pad`` launches counted."""
    from dlwp_torch.forecast import graph_counts, reset_graph_counts
    from dlwp_torch.forecast import rollout as port_rollout

    est, (x0, days, ms) = _cube_estimator(dev, B)
    reset_graph_counts()
    for steps in (4, 3):
        roll = est.rollout_fn(steps)
        reset_launch_counts()
        got = roll(x0, days, ms)
        torch.cuda.synchronize()
        replayed = launch_counts()
        reset_launch_counts()
        with monkeypatch.context() as m:
            m.setattr(port_rollout, "_replays_graphs", lambda *a: False)
            want = roll(x0, days, ms)
        torch.cuda.synchronize()
        assert torch.equal(got, want), steps
        assert replayed == launch_counts()
        assert replayed["cube_pad"] == 10 * steps
    assert graph_counts() == {"captures": 1, "replays": 4 - 1 + 3,
                              "eager_steps": 1 + 4 + 3}

"""The cubed-sphere U-Net of DLWP-CS on the CPU, at a small size (faces of
8 x 8, widths 8-16-32, seeded weights), against the benchmark's plain
reference (``h100bench/reference/cube_unet.py``, written from the paper
without the program's index table):

- the halo's geometry: each edge cell's source is the nearest cell centre
  across its edge on the gnomonic cube's 3-D coordinates;
- the program's padding equals the reference's per-edge slices, forward
  and vector-Jacobian product, and so does the ``cube_pad`` op's plain
  fallback;
- ``CubeSphereConv2D``'s polar flip: the layer commutes with the cube's
  symmetries where its kernels share theirs;
- the model, its loss and gradients, and ``TimeSeriesEstimator.rollout_fn``
  against the reference; ``Trainer.fit_device`` trains it; the layers'
  spans;
- the data-parallel training cell's driver over 2 gloo ranks.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dlwp_torch import PredictorDataset, SeriesSampler, TimeSeriesEstimator
from dlwp_torch.data import DeviceSeriesSampler
from dlwp_torch.grid import cubed_sphere as cs
from dlwp_torch.kernels import cube_pad, launch_counts, reset_launch_counts
from dlwp_torch.models import (
    LAYER_REGISTRY,
    CubeSphereConv2D,
    CubeSpherePadding2D,
    CubeUNet,
    DLWPNeuralNet,
)
from dlwp_torch.models.cube import from_faces, to_faces
from dlwp_torch.ops.padding import cube_pad_plain, cube_pad_vjp
from dlwp_torch.utils import profiling
from dlwp_torch.weights import flax_tree, load_flax_params
from h100bench import inputs, specs
from h100bench.reference import cube_unet as ref

torch.set_num_threads(2)

N = 8
CFG = {"name": "cube_test", "reference": "cube_unet",
       "grid": {"kind": "cubed_sphere", "faces": 6, "face_size": N},
       "channels": ["Z500", "TAU300-700", "Z1000", "T2m"], "insolation": True,
       "input_time_steps": 2, "output_time_steps": 2, "dt_hours": 6,
       "filters": [8, 16, 32],
       "layers": [["CubeUNet", [8], {"filters": [8, 16, 32]}]]}
# float64 on the CPU: the program and the reference differ in summation
# order only, so they agree to round-off of a few ulps of float64.
TIGHT = dict(rtol=1e-10, atol=1e-12)


def _weights(seed=1, dtype=torch.float64):
    w = inputs.make_weights(CFG, torch.Generator().manual_seed(seed), "cpu")
    return {k: v.to(dtype) for k, v in w.items()}


def _model(weights, dtype=torch.float64):
    net = DLWPNeuralNet(time_dim=2, scaler_type=None, device="cpu")
    net.build_model([tuple(s) for s in CFG["layers"]])
    inputs.load_into(net.base_model, weights)
    for p in net.base_model.parameters():
        p.data = p.data.to(dtype)
    return net


# ------------------------------------------------------------ the geometry
@pytest.mark.parametrize("n, pad", [(8, 1), (48, 1), (9, 2)])
def test_halo_sources_are_nearest_cells_across_each_edge(n, pad):
    """A halo cell beyond an edge lies where the face's own cell at the
    same depth inside lands when mirrored across the plane of the edge
    (the cube's symmetry that swaps the two faces): its table source is
    the nearest cell centre of the face across the edge, at distance 0.
    A corner cell takes the corner cell of the face across its top or
    bottom edge."""
    src = cs.halo_sources(n, pad)
    xyz = cs.cell_xyz(n)
    conn = cs.connectivity()
    m = n + 2 * pad
    for f in range(6):
        for r in range(m):
            for c in range(m):
                i, j = r - pad, c - pad
                outside = (not 0 <= i < n) + (not 0 <= j < n)
                g, gi, gj = src[f, r, c]
                if outside == 0:
                    assert (g, gi, gj) == (f, i, j)
                    continue
                if outside == 2:
                    corner = src[f, r, pad if j < 0 else m - 1 - pad]
                    assert (g, gi, gj) == tuple(corner)
                    assert g == conn[(f, "top" if i < 0 else "bottom")][0]
                    continue
                edge = ("top" if i < 0 else "bottom" if i >= n
                        else "left" if j < 0 else "right")
                assert g == conn[(f, edge)][0]
                inside = (-1 - i if i < 0 else 2 * n - 1 - i if i >= n else i,
                          -1 - j if j < 0 else 2 * n - 1 - j if j >= n else j)
                normal = cs.FRAMES[f][0] - cs.FRAMES[g][0]
                normal /= np.linalg.norm(normal)
                p = xyz[f][inside]
                p = p - 2 * (p @ normal) * normal
                d = np.linalg.norm(xyz[g].reshape(-1, 3) - p, axis=1)
                assert divmod(int(np.argmin(d)), n) == (gi, gj)
                assert d.min() < 1e-12


def test_cube_grid_and_connectivity():
    """Faces 0-3 centre on the equator at 0, 90, 180, 270 E, 4 and 5 on
    the poles; the reference's cell centres are the program's; every edge
    is shared with the neighbour's matching edge."""
    lat, lon = cs.lat_lon(N)
    centre = N // 2
    for k in range(4):
        assert abs(lat[k, centre - 1:centre + 1, centre - 1:centre + 1]
                   .mean()) < 1e-9
    assert lat[4].min() > 35 and lat[5].max() < -35
    rlat, rlon = ref.lat_lon(N)
    flat, flon = cs.folded_lat_lon(N)
    np.testing.assert_allclose(rlat, flat, atol=1e-9)
    np.testing.assert_allclose(np.cos(np.radians(rlon - flon)), 1.0,
                               atol=1e-12)
    conn = cs.connectivity()
    for (f, e), (g, ge, rev) in conn.items():
        assert conn[(g, ge)] == (f, e, rev)


# ------------------------------------------------------------- the padding
@pytest.mark.parametrize("B, C, n, pad", [(2, 3, 8, 1), (1, 2, 5, 1),
                                          (3, 1, 6, 2), (1, 1, 4, 4)])
def test_padding_matches_reference_forward_and_vjp(B, C, n, pad):
    """The program's pad (the plain gather, the op's CPU fallback and the
    layer) equals the reference's explicit per-edge slices, and its VJP
    equals autograd through the reference."""
    g = torch.Generator().manual_seed(B + 10 * C + 100 * n)
    x = torch.randn(B, C, 6 * n, n, generator=g, dtype=torch.float64)
    eq, pol = to_faces(x)
    want = ref.pad(x.reshape(B, C, 6, n, n), pad)
    m = n + 2 * pad
    for got in (cube_pad_plain(eq, pol, pad), cube_pad(eq, pol, pad),
                torch.cat(CubeSpherePadding2D(pad)((eq, pol)))):
        folded = from_faces((got[:4 * B], got[4 * B:]))
        torch.testing.assert_close(folded, want.reshape(B, C, 6 * m, m),
                                   rtol=0, atol=0)
    grad = torch.randn(B, C, 6, m, m, generator=g, dtype=torch.float64)
    leaf = x.reshape(B, C, 6, n, n).clone().requires_grad_(True)
    ref.pad(leaf, pad).backward(grad)
    geq, gpol = to_faces(grad.reshape(B, C, 6 * m, m))
    got_eq, got_pol = cube_pad_vjp(torch.cat([geq, gpol]), pad)
    torch.testing.assert_close(from_faces((got_eq, got_pol)),
                               leaf.grad.reshape(B, C, 6 * n, n), **TIGHT)
    leaves = [eq.clone().requires_grad_(True), pol.clone().requires_grad_(True)]
    cube_pad(*leaves, pad).backward(torch.cat([geq, gpol]))
    torch.testing.assert_close(leaves[0].grad, got_eq, rtol=0, atol=0)
    torch.testing.assert_close(leaves[1].grad, got_pol, rtol=0, atol=0)


def test_cpu_cube_pad_launches_nothing():
    reset_launch_counts()
    cube_pad(torch.randn(4, 1, 4, 4), torch.randn(2, 1, 4, 4))
    assert launch_counts()["cube_pad"] == 0


# ------------------------------------------------------- the polar flip
def _cell_map(rotation):
    """The permutation of the cube's cells (folded rows) that a rotation
    or reflection of the sphere makes of a field: the rotated field at
    cell p is the field at the cell whose centre is rotation^-1 p."""
    xyz = cs.cell_xyz(N).reshape(-1, 3)
    back = xyz @ np.linalg.inv(rotation).T
    d = back @ xyz.T
    idx = d.argmax(axis=1)
    assert np.allclose(d[np.arange(len(idx)), idx], 1.0)
    return torch.as_tensor(idx)


def _apply(x, idx):
    B, C = x.shape[:2]
    return x.reshape(B, C, -1)[:, :, idx].reshape(x.shape)


def _layer(eq_kernel, polar_kernel):
    conv = CubeSphereConv2D(3, 3, activation="linear")
    conv.equatorial_kernel = torch.nn.Parameter(eq_kernel)
    conv.polar_kernel = torch.nn.Parameter(polar_kernel)
    zero = torch.zeros(3, dtype=torch.float64)
    conv.equatorial_bias = torch.nn.Parameter(zero)
    conv.polar_bias = torch.nn.Parameter(zero.clone())
    pad = CubeSpherePadding2D(1)

    def fn(x):
        return from_faces(conv(pad(to_faces(x))))

    return fn


ROT_Z = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
MIRROR = np.diag([1.0, 1.0, -1.0])


def _kernels():
    g = torch.Generator().manual_seed(5)
    return [torch.randn(3, 2, 3, 3, generator=g, dtype=torch.float64)
            for _ in range(2)]


def test_polar_flip_mirror_symmetry():
    """The reflection across the equator maps the north face onto the
    south face as the polar flip stores it, so a layer whose equatorial
    kernel is symmetric top to bottom commutes with it, whatever its polar
    kernel. A kernel that is not symmetric breaks it (the test is not
    empty)."""
    k_eq, k_pol = _kernels()
    idx = _cell_map(MIRROR)
    x = torch.randn(2, 2, 6 * N, N, generator=torch.Generator().manual_seed(6),
                    dtype=torch.float64)
    layer = _layer((k_eq + k_eq.flip(-2)) / 2, k_pol)
    torch.testing.assert_close(layer(_apply(x, idx)), _apply(layer(x), idx),
                               **TIGHT)
    broken = _layer(k_eq, k_pol)
    assert not torch.allclose(broken(_apply(x, idx)), _apply(broken(x), idx))


def test_rotation_about_the_axis_rotates_the_output():
    """A quarter turn about the polar axis moves each equatorial face to
    the next one and turns the polar faces in place: a layer whose polar
    kernel is symmetric under quarter turns commutes with it. (Its corner
    taps are zero: the halo's corner cells, where three faces meet, are
    filled by a convention that no symmetry of the cube fixes.)"""
    k_eq, k_pol = _kernels()
    c4 = sum(torch.rot90(k_pol, r, dims=(-2, -1)) for r in range(4)) / 4
    c4[..., ::2, ::2] = 0.0
    layer = _layer(k_eq, c4)
    x = torch.randn(2, 2, 6 * N, N, generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64)
    for rotation in (ROT_Z, ROT_Z @ ROT_Z):
        idx = _cell_map(rotation)
        torch.testing.assert_close(layer(_apply(x, idx)),
                                   _apply(layer(x), idx), **TIGHT)


# ------------------------------------------------------------- the model
def test_registry_and_weights_find_the_cube_layers():
    for name in ("CubeUNet", "CubeSpherePadding2D", "CubeSphereConv2D",
                 "CubeAveragePooling2D", "CubeUpSampling2D"):
        assert name in LAYER_REGISTRY
    net = _model(_weights())
    tree = flax_tree(net.base_model)
    conv = tree["params"]["layers_0"]["CubeSphereConv2D_4"]
    assert conv["polar_kernel"].shape == (32, 16, 3, 3)
    other = _model(_weights(seed=9))
    load_flax_params(other.base_model, tree, dtype=torch.float64)
    for (_, a), (_, b) in zip(net.base_model.named_parameters(),
                              other.base_model.named_parameters()):
        assert torch.equal(a, b)


def test_published_widths_build_through_the_api():
    net = DLWPNeuralNet(time_dim=2, scaler_type=None, device="cpu")
    net.build_model([("CubeUNet", [8], {"filters": [32, 64, 128]})])
    x = torch.randn(1, 10, 6 * 8, 8)
    net.base_model.init(x)
    model = net.base_model.layers[0]
    assert isinstance(model, CubeUNet)
    shapes = [tuple(m.equatorial_kernel.shape) for m in model.modules()
              if isinstance(m, CubeSphereConv2D)]
    assert [s[:2] for s in shapes] == [
        (32, 10), (32, 32), (64, 32), (64, 64), (128, 64), (64, 128),
        (64, 128), (32, 64), (32, 64), (32, 32), (8, 32)]
    assert net.base_model(x).shape == (1, 8, 48, 8)


def test_model_loss_and_gradients_match_reference():
    weights = _weights()
    net = _model(weights)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 2, 5, 6 * N, N, generator=g, dtype=torch.float64)
    y = torch.randn(3, 2, 4, 6 * N, N, generator=g, dtype=torch.float64)
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want = ref.loss(params, CFG, x, y)
    want.backward()
    model = net.base_model
    for p in model.parameters():
        p.requires_grad_(True)
    pred = model(x.reshape(3, 10, 6 * N, N))
    torch.testing.assert_close(
        pred, ref.forward(weights, CFG, x.reshape(3, 10, 6 * N, N)), **TIGHT)
    got = torch.mean((pred.reshape(y.shape) - y) ** 2)
    got.backward()
    torch.testing.assert_close(got, want.detach(), **TIGHT)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, params[name].grad, **TIGHT)


def _cube_data(n_samples, seed=0):
    lat, lon = cs.folded_lat_lon(N)
    rng = np.random.RandomState(seed)
    return PredictorDataset(
        predictors=rng.randn(n_samples, 4, 6 * N, N).astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n_samples) * np.timedelta64(6, "h")),
        varlev=list(CFG["channels"]), lat=lat, lon=lon)


def test_rollout_matches_reference():
    """``rollout_fn`` on the folded cube (2-D latitudes and longitudes,
    insolation spliced in each step) against the reference rollout:
    float32, both computing insolation in float64 from their own cell
    centres, so relative differences stay at float32 round-off."""
    weights = _weights(dtype=torch.float32)
    net = _model(weights, torch.float32)
    data = _cube_data(10)
    sampler = SeriesSampler(data, model=net, input_time_steps=2,
                            output_time_steps=2, add_insolation=True,
                            batch_size=3)
    est = TimeSeriesEstimator(net, sampler)
    x0, days, mean_state, _ = est.prepare_inputs(np.arange(3))
    steps = 5
    got = est.rollout_fn(steps)(x0, days, mean_state)
    assert got.shape == (steps, 3, 2, 4, 6 * N, N)
    with torch.no_grad():
        for it, want in enumerate(ref.rollout(weights, CFG, x0, days, steps)):
            scale = want.square().mean().sqrt()
            assert (got[it] - want).abs().max() / scale < 1e-5, it


def test_fit_device_trains_the_cube_model():
    """``Trainer.fit_device`` over a device sampler: the first step's loss
    is the reference's on the same batch, and the loss falls."""
    weights = _weights(dtype=torch.float32)
    net = DLWPNeuralNet(time_dim=2, scaler_type=None, device="cpu")
    data = _cube_data(40, seed=2)
    sampler = SeriesSampler(data, model=net, input_time_steps=2,
                            output_time_steps=2, add_insolation=True,
                            batch_size=4, shuffle=False)
    net.build_model([tuple(s) for s in CFG["layers"]], learning_rate=3e-3)
    inputs.load_into(net.base_model, weights)
    dev_sampler = DeviceSeriesSampler(sampler, device="cpu")
    x, y = dev_sampler[0]
    want = float(ref.loss(weights, CFG, x, y))
    history = net.trainer.fit_device(dev_sampler, epochs=4, verbose=False)
    losses = history.history["loss"]
    assert abs(losses[0] - want) < 0.5 * want
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


def test_cube_spans_and_launch_counts():
    """One eager forward in a profiler window: a span for the U-Net, each
    of its 10 pads (with the kernel wrapper's inside), 11 convs, 2 pools
    and 2 upsamplings."""
    net = _model(_weights(dtype=torch.float32), torch.float32)
    x = torch.randn(1, 10, 6 * N, N)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        net.base_model(x)
    names = [r.name for r in profiling.spans()]
    profiling.clear_spans()
    count = {n: names.count(n) for n in set(names)}
    assert count == {"layer.CubeUNet": 1, "layer.CubeSpherePadding2D": 10,
                     "kernel.cube_pad": 10, "layer.CubeSphereConv2D": 11,
                     "layer.CubeAveragePooling2D": 2,
                     "layer.CubeUpSampling2D": 2}


# ------------------------------------------- the data-parallel train cell
def test_train_dp_driver_over_two_gloo_ranks(tmp_path):
    """The ``flagship.train_dp4`` cell's driver, its ranks spawned as
    processes over gloo on the CPU at a tiny size: its first three steps
    agree with the reference at the global batch (float32; summation order
    and the all-reduce's mean only)."""
    from h100bench.tests import tiny
    from h100bench.tests.test_h100bench_cube_dp import add_cells

    root = tiny.make_copy(tmp_path)
    add_cells(root)
    result = tiny.run(root, "flagship_tiny.train_dp_tiny")
    assert result["correct"], result["checks"]
    assert result["notes"]["ranks"] == 2
    assert result["checks"]["loss_gap"]["value"] < 1e-5


def test_reference_walk_counts_the_published_model():
    cfg = copy.deepcopy(specs.load_json("configs", "dlwp_cs48"))
    shapes = ref.walk(cfg)
    assert len(shapes) == 11
    assert round(2 * sum(s.macs for s in shapes) / 1e9, 2) == 2.38

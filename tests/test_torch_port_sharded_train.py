"""The port's sharded training slice vs dlwp_tpu.parallel / dlwp_tpu.train.

- ``halo_exchange_lon`` (the cyclic lon ring) against the JAX one under
  ``shard_map``: bit for bit;
- ``sharded_cyclic_conv2d(lon_axis_name=...)`` on lat x lon tiles and on a
  lon-only mesh against JAX's and the unsharded conv: 1e-12;
- gradients through lat x lon tiles against ``jax.grad``: 1e-10;
- the kernel paths under autograd (``_FastConv``: forward through the
  kernels' plain versions here, backward recomputed through the plain
  exchange): gradients equal to impl 'ppermute' and to JAX's ``_fast_conv``,
  and ``gradcheck``;
- fit histories on data x lat, ConvLSTM (``target_spec``), data x lat x lon
  and data-only meshes against the JAX package with the same weights:
  1e-9; the ragged batch dropped with one warning; sequence training's
  recompute; ``DeviceSeriesSampler(sharding=)``; ``dryrun_multichip``.

Float64 unless a test says float32: the kernel paths take float32 only
(a float64 model goes through the plain exchange), so the tests that
reach them through a model run in float32, at 1e-5 (the summation order of
float32 convs). JAX runs on the conftest's 8 virtual CPU devices, the port
on meshes that repeat the CPU. Inputs come from numpy seeds.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from dlwp_tpu.models import DLWPNeuralNet as JNet
from dlwp_tpu.models import build_sequential as jax_build
from dlwp_tpu.parallel import MeshConfig as JMeshConfig
from dlwp_tpu.parallel import build_mesh as jax_build_mesh
from dlwp_tpu.parallel.halo import halo_exchange_lon as jax_halo_lon
from dlwp_tpu.parallel.halo import sharded_cyclic_conv2d as jax_sharded_conv
from dlwp_tpu.parallel.spatial import SpatialSharding as JaxSpatial
from dlwp_tpu.parallel.spatial import _fast_conv as jax_fast_conv
from dlwp_tpu.train import TrainConfig as JConfig
from dlwp_tpu.train import Trainer as JTrainer

import dlwp_torch.parallel.spatial as spatial_mod
from dlwp_torch import (
    DLWPNeuralNet,
    DeviceSeriesSampler,
    PredictorDataset,
    SeriesSampler,
    build_sequential,
    dryrun_multichip,
    flax_tree,
    load_flax_params,
)
from dlwp_torch.ops.conv import cyclic_conv2d
from dlwp_torch.parallel import (
    MeshConfig,
    SpatialSharding,
    build_mesh,
    halo_exchange_lon,
    sharded_cyclic_conv2d,
)
from dlwp_torch.parallel.mesh import join_tiles, split_tiles
from dlwp_torch.parallel.spatial import _FastConv
from dlwp_torch.train import TrainConfig, Trainer

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL_EXACT = 1e-12
TOL_GRAD = 1e-10
TOL_RUN = 1e-9
TOL_F32 = 1e-5


def require_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def port_mesh(data, lat, lon=1):
    return build_mesh(MeshConfig(data=data, lat=lat, lon=lon),
                      devices=[CPU] * (data * lat * lon))


def jax_mesh(data, lat, lon=1):
    require_devices(data * lat * lon)
    return jax_build_mesh(JMeshConfig(data=data, lat=lat, lon=lon),
                          devices=jax.devices()[:data * lat * lon])


def rand(seed, *shape, scale=1.0):
    return scale * np.random.RandomState(seed).randn(*shape)


def grads(fn, *tensors, cot=None):
    """``fn``'s value and the gradients at ``tensors`` of sum(fn ** 2), or
    of sum(fn * cot) (``cot``: the output's cotangent)."""
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    (out.square() if cot is None else out * cot).sum().backward()
    return out.detach(), [t.grad for t in leaves]


# ------------------------------------------------------------ the lon ring
@pytest.mark.parametrize("n_lon", [1, 4])
@pytest.mark.parametrize("halo", [(2, 1), (1, 1), (0, 2)])
def test_halo_exchange_lon_matches_jax(halo, n_lon):
    require_devices(n_lon)
    x = rand(0, 2, 3, 8, 16)
    jmesh = JaxMesh(np.asarray(jax.devices()[:n_lon]), ("lon",))
    spec = P(None, None, None, "lon")
    want = np.asarray(jax.jit(jax.shard_map(
        lambda a: jax_halo_lon(a, halo), mesh=jmesh, in_specs=spec,
        out_specs=spec))(jnp.asarray(x)))
    mesh = build_mesh(MeshConfig(data=1, lat=1, lon=n_lon),
                      devices=[CPU] * n_lon, axis_names=("data", "lat", "lon"))
    tiles = split_tiles(torch.from_numpy(x), mesh, None, "lat", "lon")
    got = torch.cat(halo_exchange_lon(tiles[0][0], halo), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)


def test_tiles_round_trip_and_divisibility():
    x = torch.from_numpy(rand(1, 4, 3, 8, 16))
    tiles = split_tiles(x, port_mesh(2, 2, 2), "data", "lat", "lon")
    assert [len(tiles), len(tiles[0]), len(tiles[0][0])] == [2, 2, 2]
    assert tiles[1][0][1].shape == (2, 3, 4, 8)
    assert all(t.is_contiguous() for r in tiles for b in r for t in b)
    assert torch.equal(join_tiles(tiles, CPU), x)
    with pytest.raises(ValueError, match="does not divide"):
        split_tiles(x[..., :15], port_mesh(1, 1, 2), None, "lat", "lon")


# ---------------------------------------------------------- tile convs
CONVS = {"3x3": (3, 1), "3x3_dilated": (3, 2), "5x5": (5, 1),
         "5x5_dilated": (5, 2)}


@pytest.mark.parametrize("conv", list(CONVS))
@pytest.mark.parametrize("mesh", ["2x2x2", "1x1x8"])
def test_tile_conv_matches_jax(mesh, conv):
    shape = tuple(int(v) for v in mesh.split("x"))
    ks, d = CONVS[conv]
    x, k = rand(2, 2, 3, 8, 32), rand(3, 5, 3, ks, ks, scale=0.1)
    jm = jax_mesh(*shape)
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(jm, P("data", None, "lat", "lon")))
    want = np.asarray(jax.jit(lambda a, b: jax_sharded_conv(
        a, b, jm, dilation=(d, d), lon_axis_name="lon"))(xs, jnp.asarray(k)))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    got = sharded_cyclic_conv2d(xt, kt, port_mesh(*shape), dilation=(d, d),
                                lon_axis_name="lon").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_EXACT)
    single = cyclic_conv2d(xt, kt, dilation=(d, d)).numpy()
    np.testing.assert_allclose(got, single, rtol=0, atol=TOL_EXACT)
    spatial = SpatialSharding(port_mesh(*shape), lon_axis="lon",
                              impl="overlap")
    assert spatial.shardable(x.shape, k.shape, (1, 1), (d, d), "zero")
    np.testing.assert_allclose(
        spatial.conv(xt, kt, dilation=(d, d)).numpy(), single, rtol=0,
        atol=TOL_EXACT)


def test_lon_shardable_mirrors_jax():
    """The dispatch rule, JAX's ``shardable`` case for case: W dividing
    over the lon shards, each lon halo within one tile, a lon-only mesh."""
    jm, pm = jax_mesh(1, 1, 8), port_mesh(1, 1, 8)
    js = JaxSpatial(mesh=jm, lon_axis="lon")
    ps = SpatialSharding(pm, lon_axis="lon")
    assert ps.lon_shards == js.lon_shards == 8
    assert ps.activation_spec(5) == tuple(js.activation_spec(5))
    for x_shape, k_shape, d in (((2, 3, 8, 32), (4, 3, 3, 3), (1, 1)),
                                ((2, 3, 8, 36), (4, 3, 3, 3), (1, 1)),
                                ((2, 3, 8, 16), (4, 3, 5, 5), (1, 1)),
                                ((2, 3, 8, 16), (4, 3, 3, 3), (1, 2)),
                                ((2, 3, 8, 16), (4, 3, 3, 3), (1, 3))):
        for strides, mode in (((1, 1), "zero"), ((2, 2), "zero"),
                              ((1, 1), "edge")):
            assert ps.shardable(x_shape, k_shape, strides, d, mode) == \
                js.shardable(x_shape, k_shape, strides, d, mode)


def test_tile_grads_match_jax():
    """Gradients through the lat x lon tiles (the lon ring's transpose is
    the reverse ring) against ``jax.grad`` and the unsharded conv; the
    JAX test of the same name mirrored."""
    jm = jax_mesh(2, 2, 2)
    js = JaxSpatial(mesh=jm, lat_axis="lat", lon_axis="lon")
    ps = SpatialSharding(port_mesh(2, 2, 2), lat_axis="lat", lon_axis="lon")
    x, k = rand(4, 4, 2, 8, 16), rand(5, 3, 2, 3, 3, scale=0.1)

    def jloss(xx, kk):
        xx = jax.lax.with_sharding_constraint(
            xx, NamedSharding(jm, js.activation_spec(4)))
        return jnp.sum(js.conv(xx, kk) ** 2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x),
                                                    jnp.asarray(k))
    _, got = grads(ps.conv, torch.from_numpy(x), torch.from_numpy(k))
    _, single = grads(cyclic_conv2d, torch.from_numpy(x), torch.from_numpy(k))
    for g, w, s in zip(got, want, single):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL_GRAD)
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=0,
                                   atol=TOL_GRAD)


# ------------------------------------------------- the kernel paths' VJP
@pytest.mark.parametrize("impl", ["overlap", "pallas"])
def test_fast_conv_grads_match_ppermute_and_jax(impl):
    """The kernel paths' gradient is the plain exchange's at the saved
    inputs: in float64, called directly with a fixed cotangent, equal to
    impl='ppermute' bit for bit; in float32 through
    ``SpatialSharding.conv`` (which then takes the Function), equal to
    JAX's ``_fast_conv`` (interpret mode). JAX's overlap path cannot
    differentiate float64 (its float32 kernel output meets a float64
    cotangent), so JAX is compared in float32."""
    require_devices(2)
    mesh = port_mesh(1, 2)
    x, k = rand(6, 2, 3, 8, 16), rand(7, 4, 3, 3, 3, scale=0.1)
    # float32 values, so the overlap path's float32 output passes the same
    # cotangent back.
    cot = torch.from_numpy(rand(8, 2, 4, 8, 16).astype(np.float32)
                           .astype(np.float64))
    cfg = SpatialSharding(mesh, data_axis=None, impl=impl)
    plain = SpatialSharding(mesh, data_axis=None, impl="ppermute")
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    _, got = grads(lambda a, b: _FastConv.apply(a, b, cfg, (1, 1)), xt, kt,
                   cot=cot)
    _, want = grads(plain.conv, xt, kt, cot=cot)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert torch.equal(g, w)

    jcfg = JaxSpatial(mesh=JaxMesh(np.asarray(jax.devices()[:2]), ("lat",)),
                      data_axis=None, impl=impl, interpret=True)
    x32, k32 = x.astype(np.float32), k.astype(np.float32)

    def jax_out_and_grads(a, b):
        # The output, and the gradient of sum(out ** 2): the cotangent
        # 2 * out, as jax.grad of the sum passes it.
        out, vjp = jax.vjp(lambda a, b: jax_fast_conv(a, b, jcfg, (1, 1)),
                           a, b)
        return out, vjp(2.0 * out)

    jout, jgrads = jax.jit(jax_out_and_grads)(jnp.asarray(x32),
                                              jnp.asarray(k32))
    calls = []
    real = _FastConv.apply
    try:
        _FastConv.apply = lambda *a: calls.append(1) or real(*a)
        out, got32 = grads(cfg.conv, torch.from_numpy(x32),
                           torch.from_numpy(k32))
    finally:
        _FastConv.apply = real
    assert calls == [1]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL_F32)
    for g, w in zip(got32, jgrads):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= TOL_F32 * np.abs(w).max()


@pytest.mark.parametrize("conv", ["3x3", "3x3_dilated", "5x5"])
def test_fast_conv_gradcheck(conv):
    """``gradcheck`` of the Function at a tiny size: impl 'pallas' (the
    halo kernel's plain version keeps float64), one input needing grad or
    both."""
    ks, d = CONVS[conv]
    cfg = SpatialSharding(port_mesh(1, 2), data_axis=None, impl="pallas")
    x = torch.from_numpy(rand(8, 1, 2, 4, 6)).requires_grad_(True)
    k = torch.from_numpy(rand(9, 2, 2, ks, ks, scale=0.3)).requires_grad_(True)
    fn = lambda a, b: _FastConv.apply(a, b, cfg, (d, d))  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, k))
    assert torch.autograd.gradcheck(fn, (x, k.detach()))
    assert torch.autograd.gradcheck(fn, (x.detach(), k))


# ------------------------------------------------------------ fit on a mesh
TOWER = [("CyclicConv2D", (8, 3), {"dilation": 2, "activation": "tanh"}),
         ("MaxPooling2D", (2,), None),
         ("CyclicConv2D", (16, 3), {"activation": "tanh"}),
         ("UpSampling2D", (2,), None),
         ("CyclicConv2D", (2, 5), {"activation": "linear"})]
TILES = [("CyclicConv2D", (8, 3), {"activation": "tanh"}),
         ("CyclicConv2D", (2, 3), {"activation": "linear"})]
LSTM = [("ConvLSTM2D", (8, 3),
         {"return_sequences": True, "activation": "tanh"}),
        ("Reshape", ((2 * 8, 16, 32),), None),
        ("CyclicConv2D", (4, 3), {"activation": "linear"})]
FITS = {
    # (specs, mesh, batch_spec, target_spec, x shape, y shape, batch)
    "data2_lat4": (TOWER, (2, 4), ("data", None, "lat", None), None,
                   (8, 2, 16, 32), (8, 2, 16, 32), 8),
    "convlstm_target_spec": (LSTM, (2, 4), ("data", None, None, "lat", None),
                             ("data", None, "lat", None), (4, 2, 2, 16, 32),
                             (4, 4, 16, 32), 4),
    "data2_lat2_lon2": (TILES, (2, 2, 2), ("data", None, "lat", "lon"), None,
                        (4, 2, 8, 16), (4, 2, 8, 16), 4),
}


@pytest.mark.parametrize("case", list(FITS))
def test_fit_on_a_mesh_matches_jax(case):
    """``DLWPNeuralNet.fit`` for 3 epochs on a mesh against the JAX
    model's on the same mesh from the same weights, and against the
    port's unsharded fit; then the rollout (not recurrent) or the
    prediction. Float64: every conv takes the plain exchange."""
    specs, shape, bspec, tspec, xs, ys, batch = FITS[case]
    recurrent = len(xs) == 5
    x, y = rand(10, *xs), rand(11, *ys)
    if not recurrent:
        y = np.roll(x, 1, axis=-1)
    kw = dict(scaler_type=None, is_recurrent=recurrent,
              time_dim=2 if recurrent else 1)
    build = dict(learning_rate=3e-3, batch_spec=bspec, target_spec=tspec)
    sharded = DLWPNeuralNet(device="cpu", **kw)
    sharded.build_model(specs, mesh=port_mesh(*shape), **build)
    single = DLWPNeuralNet(device="cpu", **kw)
    single.build_model(specs, learning_rate=3e-3)
    lat_axes = [a for a in bspec[1:] if a]
    assert sharded._spatial.lat_axis == lat_axes[0]
    assert sharded._spatial.lon_axis == (lat_axes[1] if len(lat_axes) > 1
                                         else None)
    assert sharded.base_model.layers[0].spatial is sharded._spatial
    assert sharded.trainer.target_spec == (tspec or bspec)
    single.init(x, seed=3)
    single.load_flax_params(flax_tree(single.base_model), dtype=torch.float64)
    tree = flax_tree(single.base_model)
    sharded.load_flax_params(tree, dtype=torch.float64)

    jnet = JNet(**kw)
    jnet.build_model(specs, mesh=jax_mesh(*shape), learning_rate=3e-3,
                     batch_spec=P(*bspec),
                     target_spec=None if tspec is None else P(*tspec))
    jnet.trainer.params = jax.tree.map(jnp.asarray, tree)
    jnet.trainer.opt_state = jnet.trainer.tx.init(jnet.trainer.params)

    fit = dict(epochs=3, batch_size=batch, verbose=False)
    got = sharded.fit(x, y, **fit).history["loss"]
    want = jnet.fit(x, y, **fit).history["loss"]
    ref = single.fit(x, y, **fit).history["loss"]
    np.testing.assert_allclose(got, want, rtol=TOL_RUN, atol=0)
    np.testing.assert_allclose(got, ref, rtol=TOL_RUN, atol=0)
    if recurrent:
        got, want = sharded.predict(x), jnet.predict(x)
    else:
        got = sharded.predict_timeseries(x[:2], 3)
        want = jnet.predict_timeseries(x[:2], 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL_RUN)


def _jax_trainer(specs, x, cfg, **mesh_kw):
    model = build_sequential(specs, device="cpu")
    model.init(torch.from_numpy(x[:1]), seed=1)
    tree = flax_tree(model)
    tr = JTrainer(jax_build(specs), JConfig(**cfg), **mesh_kw)
    tr.params = jax.tree.map(jnp.asarray, tree)
    tr.opt_state = tr.tx.init(tr.params)
    return model, tr


def test_data_only_mesh_matches_jax():
    """JAX's ``test_batch_sharded_train_step``: a Trainer on a (data 8, lat
    1) mesh with ``batch_spec=("data",)`` against the JAX one from the same
    weights; in the port's single program the batch stays whole, so it is
    also the unsharded trainer's history."""
    specs = [("CyclicConv2D", (4, 3), {"activation": "tanh"}),
             ("CyclicConv2D", (2, 3), {})]
    x = rand(12, 16, 2, 8, 16)
    y = np.roll(x, 1, axis=-1)
    cfg = dict(epochs=3, batch_size=16, seed=1)
    model, jtr = _jax_trainer(specs, x, cfg, mesh=jax_mesh(8, 1),
                              batch_spec=P("data"))
    want = jtr.fit(x=x, y=y, verbose=False).history["loss"]
    tree = flax_tree(model)
    tr = Trainer(model, TrainConfig(**cfg), mesh=port_mesh(8, 1),
                 batch_spec=("data",))
    got = tr.fit(x=x, y=y, verbose=False).history["loss"]
    single = build_sequential(specs, device="cpu")
    load_flax_params(single, tree, dtype=torch.float64)
    ref = Trainer(single, TrainConfig(**cfg)).fit(x=x, y=y, verbose=False)
    np.testing.assert_allclose(got, want, rtol=TOL_RUN, atol=0)
    assert got == ref.history["loss"]


def test_ragged_batch_dropped_once_as_in_jax():
    """20 samples at batch 16 on 8 data shards: the last 4 do not divide,
    so both trainers drop them every epoch, warning once; the histories
    agree."""
    specs = [("CyclicConv2D", (1, 1), {})]
    x = rand(13, 20, 1, 4, 8)
    cfg = dict(epochs=2, batch_size=16, shuffle=False)
    model, jtr = _jax_trainer(specs, x, cfg, mesh=jax_mesh(8, 1),
                              batch_spec=P("data"))
    tr = Trainer(model, TrainConfig(**cfg), mesh=port_mesh(8, 1),
                 batch_spec=("data",))
    steps = []
    real = tr.train_step
    tr.train_step = lambda xb, yb: steps.append(len(xb)) or real(xb, yb)
    for trainer, key in ((jtr, "jax"), (tr, "port")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            hist = trainer.fit(x=x, y=0.5 * x, verbose=False)
        ragged = [w for w in caught if "ragged batch" in str(w.message)]
        assert len(ragged) == 1, key
        if key == "jax":
            want = hist.history["loss"]
    assert steps == [16, 16]
    np.testing.assert_allclose(hist.history["loss"], want, rtol=TOL_RUN)


def test_target_spec_shift_matches_jax():
    """Without a ``target_spec``, sequence training shifts the batch spec's
    feature axes right for the target's step axis, as the JAX trainer
    does; one given is kept; S=1 takes the batch spec."""
    jm, pm = jax_mesh(2, 4), port_mesh(2, 4)
    model = build_sequential(TILES, device="cpu")
    for S, tspec in ((1, None), (2, None), (2, ("data", None, None, "lat"))):
        jt = JTrainer(jax_build(TILES), JConfig(sequence_steps=S), mesh=jm,
                      batch_spec=P("data", None, "lat", None),
                      target_spec=None if tspec is None else P(*tspec))
        pt = Trainer(model, TrainConfig(sequence_steps=S), mesh=pm,
                     batch_spec=("data", None, "lat", None),
                     target_spec=tspec)
        assert pt.target_spec == tuple(jt._target_sharding.spec)
        assert pt.batch_spec == tuple(jt._sharding.spec)
    assert Trainer(model).target_spec is None


def test_sequence_training_recomputes_through_the_kernel_paths():
    """S=2 in float32 on a lat=2 mesh with impl 'overlap': each model step
    runs under checkpoint, so each conv's Function runs its forward twice
    (the step and checkpoint's recompute) and its backward once; the
    losses and gradients equal the unsharded trainer's (1e-5)."""
    specs = [("CyclicConv2D", (6, 3), {"activation": "tanh"}),
             ("CyclicConv2D", (2, 3), {})]
    x = rand(14, 4, 2, 8, 16).astype(np.float32)
    y = np.stack([np.roll(x, 1, -1), np.roll(x, 2, -1)], axis=1)
    cfg = TrainConfig(sequence_steps=2)
    sharded = build_sequential(
        specs, spatial=SpatialSharding(port_mesh(1, 2), impl="overlap"),
        device="cpu")
    sharded.init(torch.from_numpy(x[:1]), seed=2)
    single = build_sequential(specs, device="cpu")
    load_flax_params(single, flax_tree(sharded))
    counts = {"forward": 0, "backward": 0}
    real_impl, real_plain = spatial_mod._fast_conv_impl, \
        spatial_mod._ppermute_conv

    def impl(*a):
        counts["forward"] += 1
        return real_impl(*a)

    def plain(*a):
        counts["backward"] += 1
        return real_plain(*a)

    runs = {}
    try:
        spatial_mod._fast_conv_impl, spatial_mod._ppermute_conv = impl, plain
        for name, model in (("sharded", sharded), ("single", single)):
            tr = Trainer(model, cfg)
            loss = tr.train_step(x, y)["loss"].item()
            runs[name] = (loss, {n: p.grad.clone()
                                 for n, p in model.named_parameters()})
    finally:
        spatial_mod._fast_conv_impl = real_impl
        spatial_mod._ppermute_conv = real_plain
    assert counts == {"forward": 2 * 2 * 2, "backward": 2 * 2}
    (loss_s, g_s), (loss_1, g_1) = runs["sharded"], runs["single"]
    assert abs(loss_s - loss_1) <= TOL_F32 * abs(loss_1)
    for n in g_1:
        scale = g_1[n].abs().max().item()
        assert (g_s[n] - g_1[n]).abs().max().item() <= TOL_F32 * scale, n


def _dataset(n=30, H=8, W=16):
    rs = np.random.RandomState(15)
    return PredictorDataset(
        predictors=rs.randn(n, 2, H, W).astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(70.0, -70.0, H), lon=np.arange(W) * 22.5)


def test_device_sampler_on_a_mesh_trains_like_unsharded():
    """``DeviceSeriesSampler(sharding=mesh)`` keeps the series on the
    mesh's first device, and ``fit_device`` trains the lat=2 model built
    with impl 'overlap' (float32, the Function's path) to the unsharded
    run's losses and weights (1e-5); a sharding that is not a mesh is
    refused."""
    mesh = port_mesh(2, 2)
    data = _dataset()
    runs = {}
    for name, build in (
            ("sharded", dict(mesh=mesh, batch_spec=("data", None, "lat",
                                                    None),
                             spatial_impl="overlap")),
            ("single", {})):
        net = DLWPNeuralNet(scaler_type=None, device="cpu")
        net.build_model(TILES, learning_rate=3e-3, **build)
        kw = dict(batch_size=4, shuffle=True, seed=2, input_time_steps=1,
                  output_time_steps=1)
        dev = DeviceSeriesSampler(SeriesSampler(data, model=net, **kw),
                                  sharding=mesh if build else None,
                                  device=None if build else "cpu")
        assert dev.device == CPU and dev._series.dtype == torch.float32
        net.init(dev[0][0].numpy(), seed=4)
        hist = net.trainer.fit_device(dev, epochs=2, verbose=False)
        runs[name] = (hist.history["loss"],
                      {k: v.clone() for k, v in
                       net.base_model.state_dict().items()})
    (got, p_s), (want, p_1) = runs["sharded"], runs["single"]
    np.testing.assert_allclose(got, want, rtol=TOL_F32)
    for k in p_1:
        assert (p_s[k] - p_1[k]).abs().max() <= TOL_F32 * p_1[k].abs().max()
    spec = (mesh, ("data", None, "lat", None))
    assert DeviceSeriesSampler(SeriesSampler(data), sharding=spec).sharding \
        is spec
    with pytest.raises(TypeError, match="Mesh"):
        DeviceSeriesSampler(SeriesSampler(data), sharding="lat")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_on_cpu_meshes(n):
    losses = dryrun_multichip(n, devices=[CPU] * n)
    names = ["dp x sp", "convlstm"] + (["data x lat x lon"] if n % 4 == 0
                                       else [])
    assert sorted(losses) == sorted(names)
    assert all(np.isfinite(v) for v in losses.values())
    with pytest.raises(ValueError, match="need as many devices"):
        dryrun_multichip(n + 1, devices=[CPU] * n)


def test_entry_main_runs_the_dry_run(monkeypatch, capsys):
    """``python -m dlwp_torch.entry --device cpu --dryrun 4``: the compile
    check (its export stubbed here: the serving tests cover it), then the
    dry run over 4 CPU entries."""
    import dlwp_torch.entry as entry_mod
    import dlwp_torch.serve as serve

    class Exported:
        def __init__(self, fn):
            self.call = fn

    monkeypatch.setattr(serve, "export_program",
                        lambda fn, tensors: Exported(fn))
    seen = []
    real = entry_mod.dryrun_multichip
    monkeypatch.setattr(entry_mod, "dryrun_multichip",
                        lambda n, devices: seen.append((n, devices))
                        or real(n, devices))
    assert entry_mod.main(["--device", "cpu", "--dryrun", "4"]) == 0
    assert seen == [(4, [CPU] * 4)]
    out = capsys.readouterr().out
    assert "entry OK: (8, 2, 2, 36, 144)" in out
    assert "dryrun_multichip(4) OK" in out

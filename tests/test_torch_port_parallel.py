"""The port's lat-band spatial-parallel path vs dlwp_tpu.parallel, on the CPU.

The JAX side runs as ``tests/test_parallel.py`` runs it: on the conftest's
8 virtual CPU devices, with the Pallas kernels in interpret mode on 1-D
``("lat",)`` meshes. The port runs on meshes of repeated CPU devices, where
the kernel wrappers take their plain versions. Inputs are float32 from
numpy seeds, handed to both. Tolerances: halos exact (a copy); the overlap
conv 1e-5 and the halo conv 1e-6, the JAX tests' own bars against the
conv oracle; the sharded flagship 1e-5 (float32 summation order).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import dlwp_tpu.parallel.pallas_overlap as jpo
from dlwp_tpu.models import build_sequential as jax_build
from dlwp_tpu.models import layers as JL
from dlwp_tpu.parallel import build_mesh as jax_build_mesh
from dlwp_tpu.parallel import MeshConfig as JaxMeshConfig
from dlwp_tpu.parallel.halo import halo_exchange_lat as jax_halo
from dlwp_tpu.parallel.pallas_halo import (
    pallas_halo_exchange_lat as jax_pallas_halo,
    pallas_sharded_cyclic_conv2d as jax_pallas_conv,
)
from dlwp_tpu.parallel.spatial import SpatialSharding as JaxSpatial

import dlwp_torch.parallel.pallas_overlap as po
from dlwp_torch import (
    DLWPNeuralNet,
    PredictorDataset,
    SeriesSampler,
    TimeSeriesEstimator,
    build_sequential,
    load_flax_params,
)
from dlwp_torch.flagship import convlstm_specs
from dlwp_torch.kernels import launch_counts, reset_launch_counts
from dlwp_torch.models import layers as TL
from dlwp_torch.models.cnn import SequentialModel
from dlwp_torch.ops.conv import cyclic_conv2d
from dlwp_torch.parallel import (
    MeshConfig,
    SpatialSharding,
    build_mesh,
    halo_exchange_lat,
    overlapped_cyclic_conv2d,
    pallas_sharded_cyclic_conv2d,
    sharded_cyclic_conv2d,
)
from dlwp_torch.parallel.mesh import join_shards, split_shards
from dlwp_torch.parallel.pallas_halo import pallas_halo_exchange_lat

torch.set_num_threads(1)
CPU = torch.device("cpu")
LAT_SPEC = P(None, None, "lat", None)


def require_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def jax_mesh(n):
    require_devices(n)
    return JaxMesh(np.asarray(jax.devices()[:n]), ("lat",))


def port_mesh(lat, data=1):
    return build_mesh(MeshConfig(data=data, lat=lat),
                      devices=[CPU] * (data * lat))


def jax_lat_map(fn, n, x):
    """``fn`` of each lat band of ``x`` (shard_map on an n-device 1-D
    mesh), the global result as numpy."""
    mesh = jax_mesh(n)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, LAT_SPEC))
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=LAT_SPEC, out_specs=LAT_SPEC,
        check_vma=False))(xs))


def jax_sharded(conv, n, x, k):
    """A JAX sharded conv (it runs its own shard_map) of ``x`` laid out in
    lat bands over an n-device 1-D mesh, as numpy."""
    mesh = jax_mesh(n)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, LAT_SPEC))
    return np.asarray(jax.jit(lambda a, kk: conv(
        a, kk, mesh, data_axis=None, interpret=True))(xs, jnp.asarray(k)))


def operands(seed, shape, o, k=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    kernel = (0.1 * rng.randn(o, shape[1], k, k)).astype(np.float32)
    return x, kernel


# ------------------------------------------------------------------- halos
@pytest.mark.parametrize("lat", [2, 4, 8])
@pytest.mark.parametrize("halo", [(1, 1), (2, 2), (0, 1)])
def test_halo_exchange_matches_jax(halo, lat):
    x, _ = operands(lat, (2, 3, 16, 24), 1)
    want_pallas = jax_lat_map(
        lambda a: jax_pallas_halo(a, halo, interpret=True), lat, x)
    want_ppermute = jax_lat_map(lambda a: jax_halo(a, halo), lat, x)
    mesh = port_mesh(lat)
    got = pallas_halo_exchange_lat(torch.from_numpy(x), halo, mesh).numpy()
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_ppermute)
    rows = split_shards(torch.from_numpy(x), mesh, None, "lat")
    plain = join_shards([halo_exchange_lat(r, halo) for r in rows], CPU)
    np.testing.assert_array_equal(plain.numpy(), want_ppermute)


# ------------------------------------------------------------ overlap conv
@pytest.mark.parametrize("case", ["8_shards", "2_shard_4_rows"])
def test_overlapped_conv_matches_jax(case):
    n, shape, o = ((8, (4, 3, 16, 24), 5) if case == "8_shards"
                   else (2, (2, 2, 4, 16), 3))
    x, k = operands(n, shape, o)
    want = jax_sharded(jpo.overlapped_cyclic_conv2d, n, x, k)
    got = overlapped_cyclic_conv2d(torch.from_numpy(x), torch.from_numpy(k),
                                   port_mesh(n), data_axis=None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    oracle = cyclic_conv2d(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-5)


@pytest.mark.parametrize("B", [6, 5])
def test_double_buffered_path_matches_jax(B, monkeypatch):
    """The pipelined kernel forced in both packages by shrinking the
    scoped-VMEM budget to 100 KiB: one piece with a chunk of 2 (B=5 pads
    the batch to 6). A 40 KiB budget, as ``tests/test_parallel.py`` sets,
    sends these shapes to the per-sample fallback instead."""
    monkeypatch.setattr(jpo, "_SCOPED_VMEM_BUDGET", 100 * 1024)
    monkeypatch.setattr(po, "_SCOPED_VMEM_BUDGET", 100 * 1024)
    chunks = []
    real_db = po._overlap_local_db
    monkeypatch.setattr(po, "_overlap_local_db", lambda s, k, c: (
        chunks.append((s[0][0].shape[0], c)), real_db(s, k, c))[1])
    x, k = operands(B, (B, 3, 16, 24), 5)
    want = jax_sharded(jpo.overlapped_cyclic_conv2d, 4, x, k)
    got = overlapped_cyclic_conv2d(torch.from_numpy(x), torch.from_numpy(k),
                                   port_mesh(4), data_axis=None)
    assert chunks == [(B, 2)]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    oracle = cyclic_conv2d(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-5)


@pytest.mark.parametrize("ksize", [3, 5])
def test_pallas_sharded_conv_matches_jax(ksize):
    x, k = operands(ksize, (2, 2, 32, 16), 3, k=ksize)
    want = jax_sharded(jax_pallas_conv, 8, x, k)
    got = pallas_sharded_cyclic_conv2d(torch.from_numpy(x),
                                       torch.from_numpy(k), port_mesh(8),
                                       data_axis=None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    ppermute = sharded_cyclic_conv2d(torch.from_numpy(x),
                                     torch.from_numpy(k), port_mesh(8),
                                     data_axis=None)
    np.testing.assert_allclose(ppermute.numpy(), want, atol=1e-6)


# ---------------------------------------------------------------- dispatch
def test_shardable_matches_jax():
    require_devices(8)
    pairs = []
    for data, lat in ((2, 4), (8, 1), (1, 8)):
        jm = jax_build_mesh(JaxMeshConfig(data=data, lat=lat))
        pm = port_mesh(lat, data)
        for axis in ("data", None):
            pairs.append((JaxSpatial(mesh=jm, data_axis=axis),
                          SpatialSharding(pm, data_axis=axis)))
    for js, ps in pairs:
        for ndim in (4, 5):
            assert ps.activation_spec(ndim) == tuple(js.activation_spec(ndim))
    shapes = [(4, 3, 16, 24), (1, 2, 9, 16), (3, 3, 16, 24), (4, 3, 8, 24),
              (2, 2, 4, 8), (4, 2, 3, 16, 24), (8, 3, 32, 16)]
    kernels = [(5, 3, 3, 3), (5, 3, 5, 5), (5, 3, 7, 7), (5, 3, 1, 1)]
    n = 0
    for (js, ps), shape, kshape, strides, dil, mode in itertools.product(
            pairs, shapes, kernels, [(1, 1), (2, 2)],
            [(1, 1), (2, 2), (3, 3)], ["zero", "edge"]):
        want = js.shardable(shape, kshape, strides, dil, mode)
        assert ps.shardable(shape, kshape, strides, dil, mode) == want, (
            shape, kshape, strides, dil, mode, js.data_axis)
        n += want
    assert n > 0


def _jax_db_chunks(monkeypatch, shape, o):
    calls = []

    def record(x, kernel, axis_name, data_axis, chunk, interpret=False):
        calls.append((x.shape[0], chunk))
        return jnp.zeros((x.shape[0], kernel.shape[0]) + x.shape[2:],
                         jnp.float32)

    monkeypatch.setattr(jpo, "_overlap_local_db", record)
    fn = jax.shard_map(lambda a, k: jpo._overlap_local(a, k, "lat", None),
                       mesh=jax_mesh(1), in_specs=(P(), P()),
                       out_specs=P(), check_vma=False)
    jax.eval_shape(fn, jax.ShapeDtypeStruct(shape, jnp.float32),
                   jax.ShapeDtypeStruct((o, shape[1], 3, 3), jnp.float32))
    return calls


def _port_db_chunks(monkeypatch, shape, o):
    calls = []

    def record(shards, kernel, chunk=None):
        if chunk is not None:
            calls.append((shards[0][0].shape[0], chunk))
        return [[torch.empty((s.shape[0], o) + s.shape[2:], device="meta")
                 for s in r] for r in shards]

    monkeypatch.setattr(po, "_overlap_local_db", record)
    monkeypatch.setattr(po, "overlap_conv", record)
    shards = [[torch.empty(shape, device="meta")]]
    po._overlap_local(shards, torch.empty(o, shape[1], 3, 3, device="meta"))
    return calls


# Per-shard shapes (B, C, H_loc, W) and O: the flagship's overlap convs on a
# lat=2 mesh at B=64 and B=8, then odd ones (tiny C, large B, W=18).
DISPATCH_SHAPES = [
    ((64, 12, 18, 144), 48), ((64, 32, 9, 72), 64), ((64, 128, 9, 72), 64),
    ((8, 12, 18, 144), 48), ((8, 32, 9, 72), 64), ((8, 128, 9, 72), 64),
    ((64, 3, 4, 24), 5), ((300, 12, 18, 144), 48), ((200, 128, 9, 72), 64),
    ((5000, 1, 2, 16), 1), ((40, 64, 2, 18), 32),
]
SMALL_SHAPES = [((64, 3, 4, 24), 5), ((6, 3, 4, 24), 5), ((5, 3, 4, 24), 5),
                ((40, 8, 2, 18), 4), ((9, 2, 8, 16), 3)]


@pytest.mark.parametrize("budget", ["tpu", "60k", "100k"])
def test_overlap_dispatch_matches_jax(budget, monkeypatch):
    """The chunk ``_overlap_local_db`` receives, launch by launch, is the
    same in both packages over the flagship's shapes and odd ones."""
    if budget != "tpu":
        kib = int(budget[:-1]) * 1024
        monkeypatch.setattr(jpo, "_SCOPED_VMEM_BUDGET", kib)
        monkeypatch.setattr(po, "_SCOPED_VMEM_BUDGET", kib)
    plans = {}
    # Small budgets cut wide shapes into many pieces, each traced on the
    # JAX side: they take narrow ones.
    for shape, o in DISPATCH_SHAPES if budget == "tpu" else SMALL_SHAPES:
        want = _jax_db_chunks(monkeypatch, shape, o)
        got = _port_db_chunks(monkeypatch, shape, o)
        assert got == want, (shape, o)
        plans[shape] = got
    assert any(plans.values())  # the pipelined kernel is reached
    if budget == "tpu":
        assert plans[(64, 12, 18, 144)] == [(64, 5)]
        assert plans[(64, 32, 9, 72)] == [(64, 11)]
        assert plans[(64, 128, 9, 72)] == [(28, 4), (28, 4), (8, 4)]
        assert plans[(8, 12, 18, 144)] == []


# ------------------------------------------------------------------ layers
def _tree(model, x, seed=0):
    model.init(torch.from_numpy(x), seed=seed)
    return {"params": {
        f"layers_{i}": {k: p.numpy().copy()
                        for k, p in layer.named_parameters()}
        for i, layer in enumerate(model.layers)
        if any(True for _ in layer.parameters())
    }}


def _spatial_pair(impl, n=4):
    return (JaxSpatial(mesh=jax_mesh(n), data_axis=None, impl=impl,
                       interpret=True),
            SpatialSharding(port_mesh(n), data_axis=None, impl=impl))


@pytest.mark.parametrize("impl", ["ppermute", "pallas", "overlap"])
@pytest.mark.parametrize("conv", ["3x3", "3x3_dilated", "5x5", "convlstm"])
def test_spatial_layers_match_jax(conv, impl):
    js, ps = _spatial_pair(impl)
    if conv == "convlstm":
        x = np.random.RandomState(3).randn(2, 2, 3, 16, 24).astype(np.float32)
        make_port = lambda s: TL.ConvLSTM2D(4, 3, dilation=2, spatial=s)
        jl = JL.ConvLSTM2D(features=4, kernel_size=3, dilation=2, spatial=js)
    else:
        x = np.random.RandomState(4).randn(2, 3, 16, 24).astype(np.float32)
        kw = {"3x3": dict(kernel_size=3), "5x5": dict(kernel_size=5),
              "3x3_dilated": dict(kernel_size=3, dilation=2)}[conv]
        make_port = lambda s: TL.CyclicConv2D(4, activation="tanh",
                                              spatial=s, **kw)
        jl = JL.CyclicConv2D(features=4, activation="tanh", spatial=js, **kw)
    tree = _tree(SequentialModel([make_port(None)], device="cpu"), x)
    want = np.asarray(jax.jit(jl.apply)(
        {"params": tree["params"]["layers_0"]}, jnp.asarray(x)))
    model = SequentialModel([make_port(ps)], device="cpu")
    load_flax_params(model, tree)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------- the whole slice
H, W = 16, 32
BATCH_SPEC = ("data", None, None, "lat", None)


def test_sharded_flagship_matches_jax_and_builds_unfused():
    """The ConvLSTM flagship at 16x32 on a lat=2 mesh: every level shards
    (16, 8 and 4 rows), so all three kernels' plain versions run."""
    x = np.random.RandomState(5).randn(2, 2, 3, H, W).astype(np.float32)
    specs = convlstm_specs(H, W)
    js, ps = _spatial_pair("overlap", n=2)
    tree = _tree(build_sequential(specs, device="cpu"), x)
    want = np.asarray(jax.jit(jax_build(specs, spatial=js).apply)(
        tree, jnp.asarray(x)))
    model = build_sequential(specs, spatial=ps, device="cpu")
    assert [type(l).__name__ for l in model.layers][2:6] == [
        "CyclicConv2D", "MaxPool2D", "CyclicConv2D", "MaxPool2D"]
    assert all(l.spatial is ps for l in model.layers
               if isinstance(l, (TL.CyclicConv2D, TL.ConvLSTM2D)))
    load_flax_params(model, tree)
    reset_launch_counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert set(launch_counts().values()) == {0}  # CPU: plain versions
    np.testing.assert_allclose(got, want, atol=1e-5)


def _stack(mesh=None, impl="overlap"):
    n = 12
    data = PredictorDataset(
        predictors=np.random.RandomState(6).randn(n, 2, H, W)
        .astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, H), lon=np.arange(W) * (360.0 / W),
    )
    net = DLWPNeuralNet(time_dim=2, is_recurrent=True, scaler_type=None,
                        device="cpu")
    net.build_model(convlstm_specs(H, W), mesh=mesh,
                    batch_spec=BATCH_SPEC if mesh else None,
                    spatial_impl=impl)
    sampler = SeriesSampler(data, model=net, input_time_steps=2,
                            output_time_steps=2, add_insolation=True)
    net.init(sampler.generate(np.arange(1))[0], seed=0)
    return net, sampler


@pytest.mark.parametrize("impl", ["overlap", "pallas", "ppermute"])
def test_sharded_forecast_matches_unsharded(impl):
    ref, sampler = _stack()
    net, sh_sampler = _stack(port_mesh(2), impl)
    assert net._spatial is not None and net._spatial.impl == impl
    assert net._spatial.data_axis == "data" and net._spatial.lat_axis == "lat"
    net.base_model.share_params_from(ref.base_model)
    want = TimeSeriesEstimator(ref, sampler).predict(3).values
    got = TimeSeriesEstimator(net, sh_sampler).predict(3).values
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-5, rel


def test_lon_axis_and_kernel_path_grads():
    """What this test once saw refused now runs: lon tiles (the conv of a
    lat x lon tile mesh, free and through SpatialSharding, equals the
    unsharded conv) and the gradient through the overlap kernel path
    (equal to the unsharded conv's); an unknown impl still raises."""
    x, k = operands(11, (2, 3, 8, 16), 4)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    want = cyclic_conv2d(xt, kt)
    tiles = build_mesh(MeshConfig(data=1, lat=2, lon=2), devices=[CPU] * 4)
    spatial = SpatialSharding(tiles, lon_axis="lon", impl="overlap")
    assert spatial.lon_shards == 2
    assert spatial.activation_spec(4) == ("data", None, "lat", "lon")
    for got in (spatial.conv(xt, kt),
                sharded_cyclic_conv2d(xt, kt, tiles, lon_axis_name="lon")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    spatial = SpatialSharding(port_mesh(2), impl="overlap")
    xg, kg = xt.clone().requires_grad_(True), kt.clone().requires_grad_(True)
    spatial.conv(xg, kg).square().sum().backward()
    xr, kr = xt.clone().requires_grad_(True), kt.clone().requires_grad_(True)
    cyclic_conv2d(xr, kr).square().sum().backward()
    for got, ref in ((xg.grad, xr.grad), (kg.grad, kr.grad)):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    with pytest.raises(ValueError, match="impl"):
        SpatialSharding(port_mesh(2), impl="nccl")


@pytest.mark.parametrize("name,args", [
    ("batch_sharding", ()), ("batch_sharding", (4,)),
    ("space_sharding", (4, 2)), ("space_sharding", (5, 3)),
    ("batch_space_sharding", (4, 2)), ("batch_space_sharding", (5, 3)),
])
def test_sharding_helpers_match_the_jax_specs(name, args):
    """``batch_sharding``, ``space_sharding`` and ``batch_space_sharding``
    give the JAX helpers' specs as axis-name tuples, with the mesh: the
    ``(Mesh, spec)`` pair that ``DeviceSeriesSampler(sharding=)`` takes
    (``batch_sharding`` is exported from the package, as in JAX)."""
    import dlwp_tpu.parallel.mesh as jmesh

    import dlwp_torch.parallel as tp
    import dlwp_torch.parallel.mesh as tmesh

    want = getattr(jmesh, name)(
        jax_build_mesh(JaxMeshConfig(data=2, lat=1),
                       devices=jax.devices()[:2]), *args).spec
    mesh = build_mesh(MeshConfig(data=2, lat=1), devices=[CPU] * 2)
    got_mesh, spec = getattr(tmesh, name)(mesh, *args)
    assert got_mesh is mesh and spec == tuple(want)
    assert tp.batch_sharding is tmesh.batch_sharding
    from dlwp_torch.data.device_sampler import DeviceSeriesSampler

    n = 6
    sampler = SeriesSampler(PredictorDataset(
        predictors=np.zeros((n, 2, 4, 8), np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, 4), lon=np.arange(8) * 45.0),
        batch_size=2, input_time_steps=1, output_time_steps=1)
    assert DeviceSeriesSampler(sampler, device="cpu",
                               sharding=(got_mesh, spec)).sharding == (
        got_mesh, spec)

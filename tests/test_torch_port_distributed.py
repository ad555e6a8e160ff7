"""The port's multi-process layer (``dlwp_torch.parallel.distributed``)
against ``dlwp_tpu`` and ``tests/multiproc_worker.py``'s checks.

Two real processes on localhost, ``torch.distributed`` with gloo and
``device="cpu"``, each giving 2 mesh entries that repeat the CPU: this
file runs itself as the worker (``python this_file.py <address> <nproc>
<rank> <out dir>``), and the tests below read what each rank wrote. They
cover, case by case, the JAX worker's checks (``is_primary`` on exactly
one rank, ``multihost_mesh``'s shape, the linear-loss data-parallel
gradient bit-equal across ranks and equal to its numpy oracle and to
``jax.value_and_grad`` on the full batch), ``sharded_cyclic_conv2d`` on a
lat axis of 4 bands across the 2 ranks in float64 against the JAX
``cyclic_conv2d`` at 1e-12, and 3 train steps of a narrow flagship with
the data axis across ranks in float64 against the JAX ``Trainer`` on the
whole batch at 1e-9, with the parameters bit-equal across ranks and a
checkpoint written by rank 0 alone and resumed by both.

A lat axis across the processes (lat 4 over the 2 ranks; over 4 ranks of
one entry each in the second spawn, :func:`grid_worker`): the kernel
impls' conv (float32, 1e-5) and the gradients of the plain conv (float64,
1e-12) and of the kernel impls (``_FastConv``, float32) against
``jax.vjp``; the lon ring across ranks and its gradient; the sharded
spectral engine and 20 barotropic steps, each rank on its own bands,
against the JAX single-device engine; and the narrow flagship's 3 train
steps on lat 4 over 2 ranks and on (data 2 across ranks) x (lat 2 across
ranks) against the JAX ``Trainer`` at 1e-9. ``python -m dlwp_torch.entry
--distributed`` (and ``--lat-across``) runs in two processes given
torchrun's environment variables. One-process cases run in the test
process itself.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

NPROC = 2
GRID_NPROC = 4
TIMEOUT = 300
TOL_EXACT = 1e-12
TOL_RUN = 1e-9
TOL_F32 = 1e-5
H, W, C, TD, F = 8, 16, 2, 2, 4
BATCH, N_TRAIN, LR = 4, 12, 3e-3


def small_specs():
    """The flagship's layers at an 8x16 grid, narrow (as
    ``tests/test_torch_port_train.py``'s)."""
    return [
        ("ConvLSTM2D", (F, 3),
         {"dilation": 2, "return_sequences": True, "activation": "tanh"}),
        ("Reshape", ((TD * F, H, W),), None),
        ("CyclicConv2D", (6, 3), {"dilation": 2, "activation": "tanh"}),
        ("MaxPooling2D", (2,), None),
        ("CyclicConv2D", (8, 3), {"activation": "tanh"}),
        ("UpSampling2D", (2,), None),
        ("CyclicConv2D", (6, 3), {"dilation": 2, "activation": "tanh"}),
        ("CyclicConv2D", (TD * C, 5), {"activation": "linear"}),
        ("Reshape", ((TD, C, H, W),), None),
    ]


def linear_data():
    """The JAX worker's linear regression (same seeds and shapes)."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 5).astype(np.float32)
    y = rng.randn(8).astype(np.float32)
    w0 = np.linspace(-1.0, 1.0, 5).astype(np.float32)
    return x, y, w0


def conv_data():
    rng = np.random.RandomState(1)
    return rng.randn(2, 3, 8, 16), rng.randn(4, 3, 3, 3)


def train_data():
    rs = np.random.RandomState(2)
    x = rs.randn(N_TRAIN, TD, C + 1, H, W)
    y = 0.5 * rs.randn(N_TRAIN, TD, C, H, W)
    return x, y


# ---------------------------------------------------------------- worker
def worker(address, nproc, pid, out_dir):
    """One rank: every check's results go to ``out_dir/rank<pid>.npz``
    (arrays) and ``.json`` (the rest)."""
    os.environ.pop("DLWP_CONVLSTM_JOINT", None)
    torch.set_num_threads(1)
    from dlwp_torch import build_sequential
    from dlwp_torch.parallel import MeshConfig, SpatialSharding
    from dlwp_torch.parallel.distributed import (
        all_reduce_mean,
        initialize_distributed,
        is_primary,
        multihost_mesh,
        process_count,
        process_index,
    )
    from dlwp_torch.parallel.halo import halo_exchange_lat
    from dlwp_torch.parallel.mesh import Remote, split_shards
    from dlwp_torch.kernels.halo_exchange import halo_rows_plain
    from dlwp_torch.parallel.halo import sharded_cyclic_conv2d
    from dlwp_torch.train import TrainConfig, Trainer

    cpu = [torch.device("cpu")] * 2
    initialize_distributed(address, nproc, pid, device="cpu")
    initialize_distributed(address, nproc, pid, device="cpu")  # idempotent
    info = {"rank": process_index(), "count": process_count(),
            "primary": is_primary()}
    arrays = {}

    mixed = multihost_mesh(MeshConfig(data=nproc, lat=2), devices=cpu)
    info["mixed_shape"] = mixed.shape
    info["mixed_ranks"] = mixed.ranks.tolist()
    info["mixed_spans"] = [mixed.spans_processes("data"),
                           mixed.spans_processes("lat")]

    # 1. the data-parallel gradient of the JAX worker's linear loss.
    mesh = multihost_mesh(MeshConfig(data=-1, lat=1), devices=cpu)
    info["dp_shape"] = mesh.shape
    x, y, w0 = linear_data()
    start, stop = mesh.process_rows("data")
    per = len(x) // mesh.shape["data"]
    xb = torch.from_numpy(x[start * per:stop * per])
    yb = torch.from_numpy(y[start * per:stop * per])
    w = torch.from_numpy(w0).requires_grad_(True)
    loss = ((xb @ w - yb) ** 2).mean()
    loss.backward()
    loss, grad = all_reduce_mean([loss.detach().reshape(1), w.grad])
    arrays["loss"], arrays["grad"] = loss.numpy(), grad.numpy()

    # 2. lat bands across the process boundary, float64.
    mesh_sp = multihost_mesh(MeshConfig(data=1, lat=-1), devices=cpu)
    info["sp_shape"] = mesh_sp.shape
    field, kernel = (torch.from_numpy(a) for a in conv_data())
    shards = split_shards(field, mesh_sp, None, "lat")[0]
    info["remote"] = [isinstance(s, Remote) for s in shards]
    whole = halo_rows_plain(list(field.chunk(4, dim=-2)), (2, 1))
    got = halo_exchange_lat(shards, (2, 1))
    info["halo_equal"] = all(
        isinstance(g, Remote) or torch.equal(g, want)
        for g, want in zip(got, whole))
    arrays["spconv"] = sharded_cyclic_conv2d(
        field, kernel, mesh_sp, data_axis=None).numpy()
    f32 = field.float()
    arrays["spconv_ppermute"] = SpatialSharding(
        mesh_sp, data_axis=None, impl="ppermute").conv(
            f32, kernel.float()).numpy()
    lat_across_checks(mesh_sp, arrays)
    arrays.update(lon_ring(multihost_mesh(
        MeshConfig(data=1, lat=1, lon=-1), devices=cpu[:1])))
    arrays.update(spectral_core(multihost_mesh(MeshConfig(data=1, lat=-1),
                                               devices=cpu)))
    # The kernel impls on (data across ranks, lat within each): this
    # rank's block of the batch.
    block = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 8, 16)
                             ).float()
    arrays["mixed_overlap"] = SpatialSharding(
        mixed, impl="overlap").conv(block, kernel.float()).numpy()
    arrays["mixed_block"] = block.numpy()

    # 3. narrow-flagship training, data across ranks, float64.
    xs, ys = train_data()
    model = build_sequential(small_specs(), spatial=SpatialSharding(mixed),
                             device="cpu")
    model.init(torch.from_numpy(xs[:1]), seed=pid)  # rank 0's wins
    steps = []

    class Steps:
        def __call__(self, *a):
            pass

        def on_batch(self, loss):
            steps.append(loss)

    spec = ("data", None, None, "lat", None)
    tr = Trainer(model, TrainConfig(learning_rate=LR, epochs=1,
                                    batch_size=BATCH),
                 mesh=mixed, batch_spec=spec)
    hist = tr.fit(xs, ys, verbose=False, callbacks=[Steps()],
                  checkpoint_dir=os.path.join(out_dir, "ckpt"))
    info["steps"], info["history"] = steps, hist.history["loss"]
    for k, v in model.state_dict().items():
        arrays[f"param/{k}"] = v.detach().numpy()
    # Resume on every rank from rank 0's checkpoint, into fresh weights.
    again = build_sequential(small_specs(), spatial=SpatialSharding(mixed),
                             device="cpu")
    again.init(torch.from_numpy(xs[:1]), seed=7)
    tr2 = Trainer(again, TrainConfig(learning_rate=LR, epochs=1,
                                     batch_size=BATCH),
                  mesh=mixed, batch_spec=spec)
    tr2.fit(xs, ys, verbose=False, resume=True,
            checkpoint_dir=os.path.join(out_dir, "ckpt"))
    info["resumed_equal"] = all(
        torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                          model.state_dict().values()))

    # 4. the same training with the lat axis across the ranks (4 bands,
    # two a rank; every rank on the whole batch).
    lat_model = build_sequential(small_specs(),
                                 spatial=SpatialSharding(mesh_sp),
                                 device="cpu")
    lat_model.init(torch.from_numpy(xs[:1]), seed=pid)  # rank 0's wins
    steps.clear()
    hist = Trainer(lat_model, TrainConfig(learning_rate=LR, epochs=1,
                                          batch_size=BATCH),
                   mesh=mesh_sp, batch_spec=spec).fit(
        xs, ys, verbose=False, callbacks=[Steps()])
    info["lat_steps"], info["lat_history"] = steps, hist.history["loss"]
    for k, v in lat_model.state_dict().items():
        arrays[f"lat_param/{k}"] = v.detach().numpy()

    np.savez(os.path.join(out_dir, f"rank{pid}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{pid}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


def cotangent(shape):
    return np.random.RandomState(6).randn(*shape)


def lat_across_checks(mesh, arrays):
    """On a mesh whose lat axis spans the ranks: the float64 plain conv's
    gradient (``sharded_cyclic_conv2d``, dilated), and the kernel impls'
    float32 conv and gradient (``_FastConv``) at a fixed cotangent."""
    from dlwp_torch.parallel import SpatialSharding
    from dlwp_torch.parallel.halo import sharded_cyclic_conv2d

    field, kernel = (torch.from_numpy(a) for a in conv_data())
    x, k = field.requires_grad_(True), kernel.requires_grad_(True)
    y = sharded_cyclic_conv2d(x, k, mesh, dilation=(2, 1), data_axis=None)
    cot = torch.from_numpy(cotangent(y.shape))
    arrays["plain_grad_x"], arrays["plain_grad_k"] = (
        g.numpy() for g in torch.autograd.grad(y, [x, k], cot))
    for impl in ("pallas", "overlap"):
        x32 = field.detach().float().requires_grad_(True)
        k32 = kernel.detach().float().requires_grad_(True)
        y = SpatialSharding(mesh, data_axis=None, impl=impl).conv(x32, k32)
        arrays[f"spconv_{impl}"] = y.detach().numpy()
        arrays[f"grad_x_{impl}"], arrays[f"grad_k_{impl}"] = (
            g.numpy() for g in torch.autograd.grad(y, [x32, k32],
                                                   cot.float()))


def lon_ring(mesh) -> dict:
    """A float64 conv on lat x lon tiles whose lon ring (and lat axis, on
    a 2 x 2 mesh) spans the ranks, and its gradient."""
    from dlwp_torch.parallel.halo import sharded_cyclic_conv2d

    field, kernel = (torch.from_numpy(a).requires_grad_(True)
                     for a in conv_data())
    y = sharded_cyclic_conv2d(field, kernel, mesh, data_axis=None,
                              lon_axis_name="lon")
    gx, gk = torch.autograd.grad(y, [field, kernel],
                                 torch.from_numpy(cotangent(y.shape)))
    return {"lon": y.detach().numpy(), "lon_grad_x": gx.numpy(),
            "lon_grad_k": gk.numpy()}


SPEC_T, SPEC_NLAT, SPEC_NLON = 15, 16, 32
BARO_T, BARO_NLAT, BARO_NLON = 15, 32, 64


def spectral_fields():
    rng = np.random.RandomState(8)
    M = SPEC_T + 1
    spec = rng.randn(2, M, M) + 1j * rng.randn(2, M, M)
    spec = 1e-5 * spec * (np.arange(M)[None, :] >= np.arange(M)[:, None])
    spec[..., 0, :] = spec[..., 0, :].real
    return rng.randn(2, SPEC_NLAT, SPEC_NLON), spec


def baro_z(grid):
    lat = np.radians(grid.lat)[:, None]
    lon = np.radians(grid.lon)[None, :]
    return (5500.0 - 300.0 * np.sin(lat) ** 2
            + 60.0 * np.cos(lat) ** 3 * np.cos(3 * lon))


def spectral_core(mesh) -> dict:
    """The sharded spectral engine (analysis, synthesis, the wind pair)
    and 20 steps of the sharded barotropic model, float64, with the lat
    axis across the ranks; each rank holds its own bands."""
    from dlwp_torch import BarotropicModel, LatLonGrid, SphericalHarmonics
    from dlwp_torch.parallel import (
        ShardedBarotropicModel,
        ShardedSphericalHarmonics,
    )

    sh = SphericalHarmonics.build(LatLonGrid.gaussian(SPEC_NLAT, SPEC_NLON),
                                  SPEC_T, dtype=torch.float64, device="cpu")
    ssh = ShardedSphericalHarmonics(sh, mesh)
    field, spec = (torch.from_numpy(a) for a in spectral_fields())
    u, v = ssh.uv_from_vrtdiv(spec, 0.5 * spec)
    out = {"sph_analyze": ssh.analyze(field).numpy(),
           "sph_synthesize": ssh.synthesize(spec).numpy(),
           "sph_u": u.numpy(), "sph_v": v.numpy(),
           "sph_mine": np.asarray(ssh.mine)}
    grid = LatLonGrid.gaussian(BARO_NLAT, BARO_NLON)
    kw = dict(dt=1800.0, damping_coefficient=1e-4, dtype=torch.float64,
              device="cpu")
    ref = BarotropicModel(grid, BARO_T, **kw)
    model = ShardedBarotropicModel(grid, BARO_T, mesh=mesh, **kw)
    state = model.run_sharded(ref.from_z(baro_z(grid)), 20)
    out["baro_vrt"] = state.vrt_spec.numpy()
    out["baro_prev"] = state.vrt_spec_prev.numpy()
    return out


def grid_worker(address, nproc, pid, out_dir):
    """One of GRID_NPROC ranks, each giving one CPU entry: float64
    ``sharded_cyclic_conv2d`` on (data 2, lat 2), where a rank holds
    nothing of the other data row, and on lat 4 across the ranks, where a
    rank's band has other ranks' bands on both sides; and a checkpoint of
    a Trainer whose mesh is the rank's own, written by every rank."""
    torch.set_num_threads(1)
    from dlwp_torch import build_sequential
    from dlwp_torch.kernels.halo_exchange import halo_rows_plain
    from dlwp_torch.parallel import MeshConfig, SpatialSharding, build_mesh
    from dlwp_torch.parallel.distributed import (
        initialize_distributed,
        multihost_mesh,
    )
    from dlwp_torch.parallel.halo import (
        halo_exchange_lat,
        sharded_cyclic_conv2d,
    )
    from dlwp_torch.parallel.mesh import Remote, split_shards
    from dlwp_torch.train import TrainConfig, Trainer

    cpu = [torch.device("cpu")]
    initialize_distributed(address, nproc, pid, device="cpu")
    field, kernel = (torch.from_numpy(a) for a in conv_data())
    grid = multihost_mesh(MeshConfig(data=2, lat=2), devices=cpu)
    lat4 = multihost_mesh(MeshConfig(data=1, lat=-1), devices=cpu)
    info = {"grid_ranks": grid.ranks.tolist(),
            "lat4_ranks": lat4.ranks.tolist()}
    arrays = {
        "grid": sharded_cyclic_conv2d(field, kernel, grid).numpy(),
        "lat4": sharded_cyclic_conv2d(field, kernel, lat4,
                                      data_axis=None).numpy(),
        "lat4_dilated": sharded_cyclic_conv2d(
            field, kernel, lat4, dilation=(2, 1), data_axis=None).numpy(),
    }
    (row,) = split_shards(field, lat4, None, "lat")
    whole = halo_rows_plain(list(field.chunk(nproc, dim=-2)), (2, 1))
    info["halo_equal"] = all(
        isinstance(g, Remote) or torch.equal(g, want)
        for g, want in zip(halo_exchange_lat(row, (2, 1)), whole))
    lat_across_checks(lat4, arrays)
    arrays.update(lon_ring(multihost_mesh(MeshConfig(data=1, lat=2, lon=2),
                                          devices=cpu)))
    # Training on (data 2 across ranks) x (lat 2 across ranks).
    xs, ys = train_data()
    grid_model = build_sequential(small_specs(),
                                  spatial=SpatialSharding(grid),
                                  device="cpu")
    grid_model.init(torch.from_numpy(xs[:1]), seed=pid)  # rank 0's wins
    steps = []

    class Steps:
        def __call__(self, *a):
            pass

        def on_batch(self, loss):
            steps.append(loss)

    hist = Trainer(grid_model, TrainConfig(learning_rate=LR, epochs=1,
                                           batch_size=BATCH),
                   mesh=grid, batch_spec=("data", None, None, "lat", None)
                   ).fit(xs, ys, verbose=False, callbacks=[Steps()])
    info["grid_steps"], info["grid_history"] = steps, hist.history["loss"]
    for k, v in grid_model.state_dict().items():
        arrays[f"grid_param/{k}"] = v.detach().numpy()
    # A mesh of the rank's own entry (not across processes): every rank
    # keeps its own checkpoints.
    xs, ys = train_data()
    model = build_sequential(small_specs(), device="cpu")
    model.init(torch.from_numpy(xs[:1]), seed=pid)
    own = os.path.join(out_dir, f"own{pid}")
    Trainer(model, TrainConfig(learning_rate=LR, epochs=1,
                               batch_size=BATCH),
            mesh=build_mesh(MeshConfig(), cpu)).fit(
        xs[:BATCH], ys[:BATCH], verbose=False, checkpoint_dir=own)
    info["own_checkpoint"] = sorted(os.listdir(own)) if os.path.isdir(
        own) else []
    np.savez(os.path.join(out_dir, f"rank{pid}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{pid}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    run = grid_worker if sys.argv[5:] == ["grid"] else worker
    run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------- tests
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlwp_tpu.models import build_sequential as jax_build  # noqa: E402
from dlwp_tpu.ops.conv import cyclic_conv2d as jax_cyclic  # noqa: E402
from dlwp_tpu.train import TrainConfig as JConfig  # noqa: E402
from dlwp_tpu.train import Trainer as JTrainer  # noqa: E402

from dlwp_torch import build_sequential, flax_tree  # noqa: E402
from dlwp_torch.ops.conv import cyclic_conv2d  # noqa: E402
from dlwp_torch.parallel import MeshConfig  # noqa: E402
from dlwp_torch.parallel.distributed import (  # noqa: E402
    is_primary,
    multihost_mesh,
    process_count,
    process_index,
)

from tests.torch_port_threads import one_blas_thread  # noqa: E402,F401


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(out, nproc, *mode):
    """This file as ``nproc`` worker processes on localhost; each rank's
    ``(info, arrays)``."""
    address = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), address, str(nproc),
         str(pid), str(out), *mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            results.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, stdout, stderr in results:
        assert rc == 0, f"worker failed (rc={rc}):\n{stdout}\n{stderr}"
    got = []
    for pid in range(nproc):
        with open(out / f"rank{pid}.json") as f:
            info = json.load(f)
        with np.load(out / f"rank{pid}.npz") as z:
            got.append((info, dict(z)))
    return got


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results: ``[(info, arrays), ...]`` by rank."""
    return _run_workers(tmp_path_factory.mktemp("ranks"), NPROC)


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    """The GRID_NPROC ranks of :func:`grid_worker`."""
    return _run_workers(tmp_path_factory.mktemp("grid"), GRID_NPROC, "grid")


def test_one_primary_and_the_process_layout(ranks):
    infos = [info for info, _ in ranks]
    assert [i["rank"] for i in infos] == list(range(NPROC))
    assert all(i["count"] == NPROC for i in infos)
    assert sorted(i["primary"] for i in infos) == [False, True]
    assert infos[0]["primary"]


def test_multihost_mesh_shapes(ranks):
    for info, _ in ranks:
        assert info["mixed_shape"] == {"data": NPROC, "lat": 2}
        assert info["mixed_ranks"] == [[0, 0], [1, 1]]
        assert info["mixed_spans"] == [True, False]
        assert info["dp_shape"] == {"data": 2 * NPROC, "lat": 1}
        assert info["sp_shape"] == {"data": 1, "lat": 2 * NPROC}
    assert ranks[0][0]["remote"] == [False, False, True, True]
    assert ranks[1][0]["remote"] == [True, True, False, False]


def test_data_parallel_gradient_matches_oracles(ranks):
    (_, a0), (_, a1) = ranks
    np.testing.assert_array_equal(a0["loss"], a1["loss"])
    np.testing.assert_array_equal(a0["grad"], a1["grad"])
    x, y, w0 = linear_data()
    resid = x @ w0 - y
    np.testing.assert_allclose(a0["loss"][0], np.mean(resid ** 2), rtol=1e-5)
    np.testing.assert_allclose(a0["grad"], 2.0 * x.T @ resid / len(y),
                               rtol=1e-4, atol=1e-5)
    loss, grad = jax.value_and_grad(
        lambda w: jnp.mean((jnp.asarray(x) @ w - jnp.asarray(y)) ** 2))(
            jnp.asarray(w0))
    np.testing.assert_allclose(a0["loss"][0], float(loss), rtol=1e-5)
    np.testing.assert_allclose(a0["grad"], np.asarray(grad), rtol=1e-5,
                               atol=1e-6)


def test_lat_bands_across_processes_match_jax(ranks):
    field, kernel = conv_data()
    want = np.asarray(jax_cyclic(jnp.asarray(field), jnp.asarray(kernel)))
    for info, arrays in ranks:
        assert info["halo_equal"]
        np.testing.assert_allclose(arrays["spconv"], want, rtol=0,
                                   atol=TOL_EXACT)
        np.testing.assert_allclose(arrays["spconv_ppermute"], want, rtol=0,
                                   atol=TOL_F32)


@pytest.mark.parametrize("nproc", [NPROC, GRID_NPROC])
@pytest.mark.parametrize("impl", ["pallas", "overlap"])
def test_kernel_impls_refuse_a_lat_axis_across_processes(request, impl,
                                                         nproc):
    """The kernel impls no longer refuse a lat axis across processes: lat
    4 over 2 ranks (two bands a rank) and over 4 ranks, float32, against
    the JAX ``cyclic_conv2d`` (the kernels' plain versions here, their
    edge rows exchanged between the processes). On (data across ranks,
    lat within each) the kernel impl runs the rank's block as before."""
    field, kernel = conv_data()
    want = np.asarray(jax_cyclic(jnp.asarray(field), jnp.asarray(kernel)))
    for _, arrays in _ranks_of(request, nproc):
        np.testing.assert_allclose(arrays[f"spconv_{impl}"], want, rtol=0,
                                   atol=TOL_F32)
    if nproc == NPROC:
        for _, arrays in _ranks_of(request, nproc):
            # Data across ranks, lat within each: the kernel impl runs.
            block = torch.from_numpy(arrays["mixed_block"])
            want = cyclic_conv2d(block,
                                 torch.from_numpy(kernel).float()).numpy()
            np.testing.assert_allclose(arrays["mixed_overlap"], want, rtol=0,
                                       atol=TOL_F32)


def _ranks_of(request, nproc):
    return request.getfixturevalue("ranks" if nproc == NPROC
                                   else "grid_ranks")


def _jax_conv_vjp(dilation=(1, 1)):
    """JAX ``cyclic_conv2d`` of the conv data, and its gradient at the
    workers' cotangent."""
    field, kernel = conv_data()
    y, vjp = jax.vjp(lambda x, k: jax_cyclic(x, k, dilation=dilation),
                     jnp.asarray(field), jnp.asarray(kernel))
    gx, gk = vjp(jnp.asarray(cotangent(y.shape)))
    return np.asarray(y), np.asarray(gx), np.asarray(gk)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("nproc", [NPROC, GRID_NPROC])
@pytest.mark.parametrize("path", ["plain", "pallas", "overlap"])
def test_gradients_with_lat_across_processes_match_jax(request, path,
                                                       nproc):
    """The gradient of a conv whose lat axis spans the ranks, against
    ``jax.vjp`` of ``cyclic_conv2d``: ``sharded_cyclic_conv2d`` (dilated,
    float64, 1e-12) and the kernel impls through ``_FastConv`` (float32,
    1e-5), on every rank."""
    if path == "plain":
        _, gx, gk = _jax_conv_vjp((2, 1))
        keys, tol = ("plain_grad_x", "plain_grad_k"), TOL_EXACT
    else:
        _, gx, gk = _jax_conv_vjp()
        keys, tol = (f"grad_x_{path}", f"grad_k_{path}"), TOL_F32
    for _, arrays in _ranks_of(request, nproc):
        _close(arrays[keys[0]], gx, tol)
        _close(arrays[keys[1]], gk, tol)


@pytest.mark.parametrize("nproc", [NPROC, GRID_NPROC])
def test_lon_ring_across_processes_matches_jax(request, nproc):
    """A conv on lat x lon tiles whose lon ring spans the ranks (lon 2 over
    2 ranks; lat 2 x lon 2 over 4) and its gradient, float64, against
    JAX."""
    y, gx, gk = _jax_conv_vjp()
    for _, arrays in _ranks_of(request, nproc):
        _close(arrays["lon"], y, TOL_EXACT)
        _close(arrays["lon_grad_x"], gx, TOL_EXACT)
        _close(arrays["lon_grad_k"], gk, TOL_EXACT)


@pytest.mark.parametrize("part", ["transforms", "barotropic"])
def test_spectral_core_across_processes_matches_jax(ranks, part):
    """``ShardedSphericalHarmonics`` and 20 ``ShardedBarotropicModel``
    steps with the lat axis across the ranks (each rank its own two of
    four bands), float64, against the JAX single-device engine and model:
    1e-10 of the scale for the transforms, 1e-12 relative RMS for the
    steps."""
    from dlwp_tpu.barotropic import BarotropicModel as JModel
    from dlwp_tpu.grid import LatLonGrid as JGrid
    from dlwp_tpu.spectral import SphericalHarmonics as JSH

    assert [list(a["sph_mine"]) for _, a in ranks] == [[0, 1], [2, 3]]
    if part == "transforms":
        jsh = JSH.build(JGrid.gaussian(SPEC_NLAT, SPEC_NLON), SPEC_T,
                        dtype=jnp.float64)
        field, spec = spectral_fields()

        def transforms(field, spec, half):
            u, v = jsh.uv_from_vrtdiv(spec, half)
            return {"sph_analyze": jsh.analyze(field),
                    "sph_synthesize": jsh.synthesize(spec),
                    "sph_u": u, "sph_v": v}

        # One compiled program.
        want = jax.jit(transforms)(jnp.asarray(field), jnp.asarray(spec),
                                   jnp.asarray(0.5 * spec))
        for _, arrays in ranks:
            for key, w in want.items():
                w = np.asarray(w)
                np.testing.assert_allclose(arrays[key], w, rtol=0,
                                           atol=1e-10 * np.abs(w).max())
        return
    grid = JGrid.gaussian(BARO_NLAT, BARO_NLON)
    jm = JModel(grid, BARO_T, dt=1800.0, damping_coefficient=1e-4,
                dtype=jnp.float64)
    state = jm.run(jm.from_z(jnp.asarray(baro_z(grid))), 20)
    for _, arrays in ranks:
        for key, w in (("baro_vrt", state.vrt_spec),
                       ("baro_prev", state.vrt_spec_prev)):
            w = np.asarray(w)
            rel = (np.sqrt(np.mean(np.abs(arrays[key] - w) ** 2))
                   / np.sqrt(np.mean(np.abs(w) ** 2)))
            assert rel <= 1e-12, (key, rel)


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX Trainer's 3 steps on the whole batches from rank 0's
    initial weights: (step losses, history, parameter leaves); one run
    for every layout's check."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("DLWP_CONVLSTM_JOINT", raising=False)
        return _jax_fit()


def _jax_fit():
    xs, ys = train_data()
    init = build_sequential(small_specs(), device="cpu")
    init.init(torch.from_numpy(xs[:1]), seed=0)
    tree = flax_tree(init)
    jt = JTrainer(jax_build(small_specs()),
                  JConfig(learning_rate=LR, epochs=1, batch_size=BATCH))
    jt.params = jax.tree.map(jnp.asarray, tree)
    jt.opt_state = jt.tx.init(jt.params)
    steps = []

    class Steps:
        def __call__(self, *a):
            pass

        def on_batch(self, loss):
            steps.append(loss)

    hist = jt.fit(x=xs, y=ys, verbose=False, callbacks=[Steps()])
    leaves = jax.tree.leaves(jax.tree.map(np.asarray, jt.params)["params"])
    return steps, hist.history["loss"], leaves


def _check_training(got, prefix, steps_key, history_key, jax_fit):
    """Every rank's steps, history and parameters (``prefix`` keys):
    bit-equal across ranks, and the JAX Trainer's (``jax_fit``) to 1e-9."""
    i0, a0 = got[0]
    keys = sorted(k for k in a0 if k.startswith(prefix))
    for info, arrays in got[1:]:
        for k in keys:
            np.testing.assert_array_equal(a0[k], arrays[k])
        assert info[steps_key] == i0[steps_key]
        assert info[history_key] == i0[history_key]
    assert len(i0[steps_key]) == 3
    np.testing.assert_allclose(i0[history_key][0], np.mean(i0[steps_key]),
                               rtol=1e-15)
    steps, history, want = jax_fit
    np.testing.assert_allclose(i0[steps_key], steps, rtol=TOL_RUN, atol=0)
    np.testing.assert_allclose(i0[history_key], history, rtol=TOL_RUN,
                               atol=0)
    xs, _ = train_data()
    model = build_sequential(small_specs(), device="cpu")
    model.init(torch.from_numpy(xs[:1]), seed=0)
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(a0[k])
                           for k in keys})
    mine = jax.tree.leaves(flax_tree(model)["params"])
    assert len(want) == len(mine)
    for w_, m_ in zip(want, mine):
        np.testing.assert_allclose(m_, w_, rtol=0,
                                   atol=TOL_RUN * max(1.0, np.abs(w_).max()))


def test_data_parallel_training_matches_jax(ranks, jax_fit, monkeypatch):
    """3 train steps (one epoch of 12 samples at B=4) with each rank on
    half of every batch, against the JAX Trainer on the whole batches
    from rank 0's initial weights."""
    monkeypatch.delenv("DLWP_CONVLSTM_JOINT", raising=False)
    _check_training(ranks, "param/", "steps", "history", jax_fit)


@pytest.mark.parametrize("layout", ["lat 4 over 2 ranks",
                                    "data 2 x lat 2 over 4 ranks"])
def test_lat_across_processes_training_matches_jax(request, jax_fit,
                                                   monkeypatch, layout):
    """The same 3 train steps, float64, with the lat axis across the
    ranks: lat 4 over 2 ranks (every rank on the whole batch), and data 2
    across ranks x lat 2 across ranks (gradients averaged over the data
    axis's ranks only); parameters bit-equal across ranks."""
    monkeypatch.delenv("DLWP_CONVLSTM_JOINT", raising=False)
    if layout.startswith("lat"):
        _check_training(request.getfixturevalue("ranks"), "lat_param/",
                        "lat_steps", "lat_history", jax_fit)
    else:
        _check_training(request.getfixturevalue("grid_ranks"),
                        "grid_param/", "grid_steps", "grid_history", jax_fit)


def test_checkpoint_written_by_rank_0_and_resumed_by_both(ranks):
    for info, _ in ranks:
        assert info["resumed_equal"]


def _run_entry(*flags):
    """``python -m dlwp_torch.entry --distributed --device cpu`` in NPROC
    processes given torchrun's environment variables (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK); each rank's result line."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = str(_free_port())
    procs = []
    for rank in range(NPROC):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(NPROC), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dlwp_torch.entry", "--distributed",
             "--device", "cpu", *flags], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rc={p.returncode}:\n{stdout}\n{stderr}"
            line = next(ln for ln in stdout.splitlines()
                        if ln.startswith("train_distributed rank"))
            outs.append(json.loads(line.split(": ", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert sorted(o["rank"] for o in outs) == [0, 1]
    assert all(o["backend"] == "gloo" for o in outs)
    assert outs[0]["losses"] == outs[1]["losses"]
    assert len(outs[0]["losses"]) == 3
    assert np.isfinite(outs[0]["losses"]).all()
    assert outs[0]["param_checksum"] == outs[1]["param_checksum"]
    return outs


def test_entry_distributed_under_a_torchrun_environment():
    """``python -m dlwp_torch.entry --distributed --device cpu`` in two
    processes: the flagship's 3 train steps on (data across the 2
    processes, lat 2 within each), the same losses and parameters on both
    ranks."""
    outs = _run_entry()
    assert all(o["mesh"] == {"data": 2, "lat": 2} for o in outs)


def test_entry_lat_across_under_a_torchrun_environment():
    """The same with ``--lat-across``: one lat band a process, both on the
    same batches."""
    outs = _run_entry("--lat-across")
    assert all(o["mesh"] == {"data": 1, "lat": 2} for o in outs)


@pytest.mark.parametrize("layout", ["data 2 x lat 2", "lat 4"])
def test_rows_held_elsewhere_across_four_processes_match_jax(grid_ranks,
                                                             layout):
    """Four ranks of one entry each: on (data 2, lat 2) a rank holds
    nothing of one data row; on lat 4 the middle ranks' bands have other
    ranks' bands on both sides. Every rank gets the whole float64 conv."""
    field, kernel = conv_data()
    key = {"data 2 x lat 2": "grid", "lat 4": "lat4"}[layout]
    want = np.asarray(jax_cyclic(jnp.asarray(field), jnp.asarray(kernel)))
    for info, arrays in grid_ranks:
        assert info["grid_ranks"] == [[0, 1], [2, 3]]
        assert info["lat4_ranks"] == [[0, 1, 2, 3]]
        np.testing.assert_allclose(arrays[key], want, rtol=0, atol=TOL_EXACT)
    if key == "lat4":
        want = np.asarray(jax_cyclic(jnp.asarray(field), jnp.asarray(kernel),
                                     dilation=(2, 1)))
        for info, arrays in grid_ranks:
            assert info["halo_equal"]
            np.testing.assert_allclose(arrays["lat4_dilated"], want, rtol=0,
                                       atol=TOL_EXACT)


def test_a_trainer_on_its_own_entries_checkpoints_on_every_rank(grid_ranks):
    for info, _ in grid_ranks:
        assert info["own_checkpoint"], info


@pytest.mark.parametrize("local_world, cards, want", [
    ("2", 1, "gloo"), ("2", 2, "nccl"), ("1", 1, "nccl"), (None, 1, "nccl"),
    ("4", 2, "gloo"),
])
def test_backend_follows_the_ranks_a_card(monkeypatch, local_world, cards,
                                          want):
    """On the card: NCCL, unless torchrun starts more ranks on this host
    (LOCAL_WORLD_SIZE) than it has cards; then gloo. No card needed: the
    card count and the group's start are stood in for."""
    from dlwp_torch.parallel import distributed

    got = {}
    monkeypatch.setattr(distributed, "resolve_device",
                        lambda d: torch.device(d or "cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: got.setdefault("card", i))
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: got.setdefault("backend",
                                                             backend))
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "RANK": "1",
           "WORLD_SIZE": "2", "LOCAL_RANK": "1"}
    if local_world is not None:
        env["LOCAL_WORLD_SIZE"] = local_world
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    distributed.initialize_distributed()
    assert got == {"backend": want, "card": 1 % cards}
    got.clear()
    distributed.initialize_distributed(device="cpu")
    assert got == {"backend": "gloo"}


def test_initialize_without_a_coordinator_says_what_is_missing(monkeypatch):
    from dlwp_torch.parallel.distributed import initialize_distributed

    for key in ("MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        initialize_distributed(device="cpu")


def test_single_process_mesh_and_primary():
    """``tests/test_parallel.py``'s one-process case: without a process
    group, multihost_mesh is build_mesh over the given entries."""
    mesh = multihost_mesh(MeshConfig(data=-1, lat=2),
                          devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {"data": 4, "lat": 2}
    assert mesh.ranks is None and not mesh.spans_processes("data")
    assert is_primary() and process_index() == 0 and process_count() == 1
    assert multihost_mesh(MeshConfig(data=1, lat=2, lon=2),
                          devices=[torch.device("cpu")] * 4,
                          ici_axis="band").axis_names == ("data", "band",
                                                          "lon")

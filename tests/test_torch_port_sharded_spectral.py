"""The port's sharded spectral core (``ShardedSphericalHarmonics``,
``ShardedBarotropicModel``) against its unsharded engine and model and
against the JAX package's sharded ones, in float64 on CPU meshes (the port's
mesh repeats the CPU device; JAX's is the suite's virtual CPU devices).

Sharding moves blocks and slices tables by m; it does not change what is
summed, only where, so the transforms agree to 1e-12 x the output's scale
(in practice bit for bit), and 20 barotropic steps to 1e-12, JAX's own
limit for its sharded model (``tests/test_parallel.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_tpu.barotropic import BarotropicModel as JModel
from dlwp_tpu.grid import LatLonGrid as JGrid
from dlwp_tpu.parallel import MeshConfig as JMeshConfig
from dlwp_tpu.parallel import build_mesh as jax_build_mesh
from dlwp_tpu.parallel.barotropic import ShardedBarotropicModel as JSharded
from dlwp_tpu.parallel.spectral import ShardedSphericalHarmonics as JSSH
from dlwp_tpu.spectral import SphericalHarmonics as JSH

from dlwp_torch import BarotropicModel, LatLonGrid, SphericalHarmonics
from dlwp_torch.parallel import (
    MeshConfig,
    ShardedBarotropicModel,
    ShardedSphericalHarmonics,
    build_mesh,
)

torch.set_num_threads(2)
TOL = 1e-12
CPU = torch.device("cpu")


def _mesh(lat, data=1):
    return build_mesh(MeshConfig(data=data, lat=lat),
                      devices=[CPU] * (data * lat))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _spec(rng, lead, T):
    M = T + 1
    c = rng.randn(*lead, M, M) + 1j * rng.randn(*lead, M, M)
    c = c * (np.arange(M)[None, :] >= np.arange(M)[:, None])
    c[..., 0, :] = c[..., 0, :].real
    return 1e-5 * c


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("lat", [1, 2, 4])
def test_sharded_transforms_match_unsharded_and_jax(lat, fold):
    T, nlat, nlon = 15, 16, 32
    sh = SphericalHarmonics.build(LatLonGrid.gaussian(nlat, nlon), T,
                                  dtype=torch.float64, fold=fold,
                                  device="cpu")
    ssh = ShardedSphericalHarmonics(sh, _mesh(lat, data=2 if lat < 4 else 1))
    jsh = JSH.build(JGrid.gaussian(nlat, nlon), T, dtype=jnp.float64,
                    fold=fold)
    jssh = JSSH(jsh, jax_build_mesh(JMeshConfig(data=8 // lat, lat=lat)))
    rng = np.random.RandomState(lat)
    field = rng.randn(3, nlat, nlon)
    spec = _spec(rng, (3,), T)
    u, v = rng.randn(3, nlat, nlon), rng.randn(3, nlat, nlon)
    t = torch.from_numpy
    _close(ssh.analyze(t(field)), sh.analyze(t(field)))
    _close(ssh.analyze(t(field)), jssh.analyze(jnp.asarray(field)))
    _close(ssh.synthesize(t(spec)), sh.synthesize(t(spec)))
    _close(ssh.synthesize(t(spec)), jssh.synthesize(jnp.asarray(spec)))
    for got, flat, ref in zip(
            ssh.uv_from_vrtdiv(t(spec), t(0.5 * spec)),
            sh.uv_from_vrtdiv(t(spec), t(0.5 * spec)),
            jssh.uv_from_vrtdiv(jnp.asarray(spec), jnp.asarray(0.5 * spec))):
        _close(got, flat)
        _close(got, ref)
    for got, flat, ref in zip(ssh.vrtdiv_from_uv(t(u), t(v)),
                              sh.vrtdiv_from_uv(t(u), t(v)),
                              jssh.vrtdiv_from_uv(jnp.asarray(u),
                                                  jnp.asarray(v))):
        _close(got, flat)
        _close(got, ref)


def test_shard_layout_and_transposes():
    """Grid shards are latitude bands and spectral shards m bands on their
    mesh entries; the two transposes are inverse block moves."""
    sh = SphericalHarmonics.build(LatLonGrid.gaussian(16, 32), 15,
                                  dtype=torch.float64, device="cpu")
    ssh = ShardedSphericalHarmonics(sh, _mesh(4))
    assert (ssh.m_per, ssh.j_per, len(ssh.devices)) == (4, 4, 4)
    x = torch.randn(2, 16, 32, dtype=torch.float64)
    shards = ssh.split(x)
    assert [tuple(s.shape) for s in shards] == [(2, 4, 32)] * 4
    torch.testing.assert_close(ssh.join(shards), x, rtol=0, atol=0)
    F = [torch.randn(2, 16, 4, dtype=torch.complex128) for _ in range(4)]
    spec = ssh._transpose_to_spec(F)
    assert [tuple(s.shape) for s in spec] == [(2, 4, 16)] * 4
    torch.testing.assert_close(spec[1][..., 8:12], F[2][..., 4:8, :],
                               rtol=0, atol=0)
    back = ssh._transpose_to_grid(spec)
    for a, b in zip(back, F):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ssh.m_vals(2), sh.m_vals[8:12], rtol=0, atol=0)


def test_divisibility_rule():
    sh = SphericalHarmonics.build(LatLonGrid.regular(19, 36), 12,
                                  dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        ShardedSphericalHarmonics(sh, _mesh(2))


def _z(grid):
    lat = np.radians(grid.lat)[:, None]
    lon = np.radians(grid.lon)[None, :]
    return (5500.0 - 300.0 * np.sin(lat) ** 2
            + 60.0 * np.cos(lat) ** 3 * np.cos(3 * lon))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("lat", [2, 4])
def test_sharded_barotropic_matches_unsharded_and_jax(lat, fold):
    """20 steps of ``run_sharded`` (T15 on a 32x64 Gaussian grid, JAX's
    test) against the port's single-device ``run`` and JAX's
    ``run_sharded``; ``step_sharded`` is one such step."""
    kw = dict(dt=1800.0, damping_coefficient=1e-4)
    grid = LatLonGrid.gaussian(32, 64)
    ref = BarotropicModel(grid, 15, dtype=torch.float64, fold=fold,
                          device="cpu", **kw)
    shd = ShardedBarotropicModel(grid, 15, dtype=torch.float64, fold=fold,
                                 device="cpu", mesh=_mesh(lat), **kw)
    state = ref.from_z(_z(grid))
    want = ref.run(state, 20)
    got = shd.run_sharded(state, 20)
    _close(got.vrt_spec, want.vrt_spec)
    _close(got.vrt_spec_prev, want.vrt_spec_prev)
    assert got.step == 20 and float(got.t) == float(want.t)
    one = shd.step_sharded(state)
    _close(one.vrt_spec, ref.step_forward(state).vrt_spec)

    jgrid = JGrid.gaussian(32, 64)
    jmesh = jax_build_mesh(JMeshConfig(data=8 // lat, lat=lat))
    jref = JModel(jgrid, 15, dtype=jnp.float64, fold=fold, **kw)
    jshd = JSharded(jgrid, 15, mesh=jmesh, dtype=jnp.float64, fold=fold, **kw)
    jstate = jref.from_z(jnp.asarray(_z(jgrid)))
    jstate = jstate.replace(
        vrt_spec=jax.device_put(jstate.vrt_spec, jshd.spec_sharding()),
        vrt_spec_prev=jax.device_put(jstate.vrt_spec_prev,
                                     jshd.spec_sharding()))
    _close(got.vrt_spec, jshd.run_sharded(jstate, 20).vrt_spec)

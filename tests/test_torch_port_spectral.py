"""The port's grids, Legendre tables and spherical-harmonic transforms
against the JAX package's, in float64 on the CPU.

The tables are the same float64 numpy code in both packages, so they agree
to rtol 1e-12 (in practice exactly). The transforms differ only in the
order of their sums (torch einsum/FFT vs XLA), so they agree to
1e-12 x the scale of the output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlwp_tpu.grid import LatLonGrid as JaxGrid
from dlwp_tpu.spectral import SphericalHarmonics as JaxSH
from dlwp_tpu.spectral import legendre_tables as jax_legendre_tables
from dlwp_tpu.spectral.transforms import dft_tables as jax_dft_tables

from dlwp_torch.grid import LatLonGrid, clenshaw_curtis_weights, gaussian_latitudes
from dlwp_torch.spectral import SphericalHarmonics, dft_tables, legendre_tables

torch.set_num_threads(2)
RTOL_TABLES = 1e-12  # same float64 numpy code
ATOL_SCALE = 1e-12  # transforms: float64, only the sum order differs

# (kind, nlat, nlon, truncation): a pole-inclusive regular grid and a
# Gaussian grid, small enough for the CPU.
GRIDS = [("regular", 19, 36, 12), ("gaussian", 16, 32, 10)]


def _grids(kind, nlat, nlon):
    return (getattr(JaxGrid, kind)(nlat, nlon),
            getattr(LatLonGrid, kind)(nlat, nlon))


def _engines(kind, nlat, nlon, T, fourier):
    jg, pg = _grids(kind, nlat, nlon)
    return (JaxSH.build(jg, T, dtype=jnp.float64, fourier=fourier),
            SphericalHarmonics.build(pg, T, dtype=torch.float64,
                                     fourier=fourier, device="cpu"))


def _spec(rng, lead, T):
    """Random band-limited spectral coefficients (zeros for n < m, real
    m = 0 column), scaled like a vorticity field."""
    M = T + 1
    c = rng.randn(*lead, M, M) + 1j * rng.randn(*lead, M, M)
    c = c * (np.arange(M)[None, :] >= np.arange(M)[:, None])
    c[..., 0, :] = c[..., 0, :].real
    return 1e-5 * c


def _close(got, want, atol_scale=ATOL_SCALE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_scale * scale)


@pytest.mark.parametrize("kind,nlat,nlon,T", GRIDS)
def test_grid_matches(kind, nlat, nlon, T):
    jg, pg = _grids(kind, nlat, nlon)
    assert pg.grid_type == jg.grid_type and pg.shape == jg.shape
    for name in ("lat", "lon", "quad_weights", "mu", "coslat", "coriolis"):
        np.testing.assert_allclose(getattr(pg, name), getattr(jg, name),
                                   rtol=RTOL_TABLES, atol=0)
    np.testing.assert_allclose(pg.cos_lat_weights("midlatitude"),
                               jg.cos_lat_weights("midlatitude"),
                               rtol=RTOL_TABLES)


def test_quadrature_helpers_match():
    from dlwp_tpu.grid import latlon as jax_latlon

    np.testing.assert_allclose(clenshaw_curtis_weights(19),
                               jax_latlon.clenshaw_curtis_weights(19),
                               rtol=RTOL_TABLES)
    for a, b in zip(gaussian_latitudes(16), jax_latlon.gaussian_latitudes(16)):
        np.testing.assert_allclose(a, b, rtol=RTOL_TABLES)
    lat, lon = np.linspace(80.0, -80.0, 9), np.arange(18) * 20.0
    jg = JaxGrid.from_coords(lat, lon)
    pg = LatLonGrid.from_coords(lat, lon)
    assert pg.grid_type == jg.grid_type == "custom"
    np.testing.assert_array_equal(pg.quad_weights, jg.quad_weights)


@pytest.mark.parametrize("kind,nlat,nlon,T", GRIDS)
def test_legendre_tables_match(kind, nlat, nlon, T):
    jg, pg = _grids(kind, nlat, nlon)
    a, b = legendre_tables(T, pg.mu), jax_legendre_tables(T, jg.mu)
    for name in ("mu", "P", "G", "H", "n_total", "mask"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                   rtol=RTOL_TABLES, atol=0)
    assert a.nlat == b.nlat == nlat


@pytest.mark.parametrize("nlon,M", [(36, 13), (72, 25), (144, 73), (32, 17)])
def test_dft_tables_match(nlon, M):
    for a, b in zip(dft_tables(nlon, M), jax_dft_tables(nlon, M)):
        np.testing.assert_allclose(a, b, rtol=RTOL_TABLES, atol=0)
    with pytest.raises(ValueError):
        dft_tables(nlon, nlon // 2 + 2)


@pytest.mark.parametrize("fourier", ["fft", "matmul"])
@pytest.mark.parametrize("kind,nlat,nlon,T", GRIDS)
def test_engine_tables_match(kind, nlat, nlon, T, fourier):
    jsh, psh = _engines(kind, nlat, nlon, T, fourier)
    names = SphericalHarmonics.TABLES + (
        ("dft_fwd", "dft_inv") if fourier == "matmul" else ())
    for name in names:
        got = getattr(psh, name)
        assert got.dtype == torch.float64 and got.device.type == "cpu", name
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jsh, name)),
                                   rtol=RTOL_TABLES, atol=0, err_msg=name)
    if fourier == "fft":
        assert psh.dft_fwd is None and psh.dft_inv is None
    assert psh.nspec == jsh.nspec
    for a, b in zip(psh.wavenumbers, jsh.wavenumbers):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["single", "batched"])
@pytest.mark.parametrize("fourier", ["fft", "matmul"])
@pytest.mark.parametrize("kind,nlat,nlon,T", GRIDS)
def test_transforms_match(kind, nlat, nlon, T, fourier, lead):
    jsh, psh = _engines(kind, nlat, nlon, T, fourier)
    rng = np.random.RandomState(nlat + len(lead))
    vrt, div = _spec(rng, lead, T), _spec(rng, lead, T)
    field = 5500.0 + 100.0 * rng.randn(*lead, nlat, nlon)
    u, v = 10.0 * rng.randn(2, *lead, nlat, nlon)
    t = torch.from_numpy

    _close(psh.synthesize(t(vrt)), jsh.synthesize(jnp.asarray(vrt)))
    _close(psh.analyze(t(field)), jsh.analyze(jnp.asarray(field)))
    _close(psh.laplacian(t(field)), jsh.laplacian(jnp.asarray(field)))
    for got, want in zip(psh.gradients(t(vrt)), jsh.gradients(jnp.asarray(vrt))):
        _close(got, want)
    for got, want in zip(psh.uv_from_vrtdiv(t(vrt), t(div)),
                         jsh.uv_from_vrtdiv(jnp.asarray(vrt), jnp.asarray(div))):
        _close(got, want)
    for got, want in zip(psh.vrtdiv_from_uv(t(u), t(v)),
                         jsh.vrtdiv_from_uv(jnp.asarray(u), jnp.asarray(v))):
        _close(got, want)


@pytest.mark.parametrize("kind,nlat,nlon,T", GRIDS)
def test_mu_multiplier_matches(kind, nlat, nlon, T):
    jsh, psh = _engines(kind, nlat, nlon, T, "fft")
    sign = np.where(psh.grid.lat < 0, -1.0, 1.0)
    op_p, op_j = psh.mu_multiplier_operator(sign), jsh.mu_multiplier_operator(sign)
    np.testing.assert_allclose(op_p.numpy(), np.asarray(op_j),
                               rtol=RTOL_TABLES, atol=1e-15)
    spec = _spec(np.random.RandomState(3), (2,), T)
    _close(psh.apply_mu_multiplier(op_p, torch.from_numpy(spec)),
           jsh.apply_mu_multiplier(op_j, jnp.asarray(spec)))


def test_pack_unpack_round_trip_matches():
    jsh, psh = _engines("regular", 19, 36, 12, "fft")
    spec = _spec(np.random.RandomState(4), (3,), 12)
    packed = psh.pack(torch.from_numpy(spec))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jsh.pack(jnp.asarray(spec))))
    np.testing.assert_array_equal(psh.unpack(packed).numpy(), spec)


def test_fold_builds_and_matches_jax():
    """The call that raised before the fold was ported now builds and
    round-trips as the JAX engine does (the fold's own tests:
    ``tests/test_torch_port_fold.py``)."""
    grid = LatLonGrid.regular(19, 36)
    psh = SphericalHarmonics.build(grid, 12, dtype=torch.float64, fold=True,
                                   device="cpu")
    jsh = JaxSH.build(JaxGrid.regular(19, 36), 12, dtype=jnp.float64,
                      fold=True)
    spec = _spec(np.random.RandomState(5), (2,), 12)
    _close(psh.synthesize(torch.from_numpy(spec)),
           jsh.synthesize(jnp.asarray(spec)))
    _close(psh.analyze(psh.synthesize(torch.from_numpy(spec))), spec)


def test_build_rejects_what_the_jax_package_rejects():
    grid = LatLonGrid.regular(19, 36)
    with pytest.raises(ValueError):
        SphericalHarmonics.build(grid, 12, fourier="dft", device="cpu")
    with pytest.raises(ValueError):
        SphericalHarmonics.build(grid, 19, device="cpu")  # T + 1 > nlat
    with pytest.raises(ValueError):
        SphericalHarmonics.build(grid, 12, dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError):
        SphericalHarmonics.build(grid, 12, dtype="float32", device="cpu")
    f32 = SphericalHarmonics.build(grid, 12, dtype=torch.float32, device="cpu")
    assert f32.P.dtype == torch.float32 and f32.cdtype == torch.complex64

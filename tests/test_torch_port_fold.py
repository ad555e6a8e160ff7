"""The hemisphere-parity fold (``SphericalHarmonics.build(fold=True)``) of
the port against its unfolded engine and against the JAX package's folded
engine, in float64 on the CPU; and the port's barotropic models, folded and
not, against the reference oracle (``tests/oracles/reference_barotropic.py``)
as ``tests/test_reference_oracle.py`` holds the JAX models.

The packed tables are the same float64 numpy code in both packages (rtol
1e-12). The transforms differ from JAX and from the unfolded engine only in
the order of their sums, so they agree to 1e-10 x the scale of the output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_tpu.grid import LatLonGrid as JaxGrid
from dlwp_tpu.spectral import SphericalHarmonics as JaxSH

from dlwp_torch.barotropic import BarotropicModel, BarotropicModelPsi
from dlwp_torch.grid import LatLonGrid
from dlwp_torch.spectral import SphericalHarmonics

from tests.oracles.reference_barotropic import (
    PackedQuadratureTransforms,
    RefBarotropicPsi,
    RefBarotropicVrt,
)

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(2)
TOL = 1e-10  # float64, fold vs unfolded and vs JAX: the sum order differs

# (kind, nlat, nlon, truncation): odd J (an equator row) on the regular
# grid, even J on the Gaussian one, and an odd T + 1.
GRIDS = [("regular", 19, 36, 12), ("regular", 17, 32, 9),
         ("gaussian", 16, 32, 10)]


def _engines(kind, nlat, nlon, T, fourier="fft"):
    jg = getattr(JaxGrid, kind)(nlat, nlon)
    pg = getattr(LatLonGrid, kind)(nlat, nlon)
    jax_fold = JaxSH.build(jg, T, dtype=jnp.float64, fourier=fourier,
                           fold=True)
    fold = SphericalHarmonics.build(pg, T, dtype=torch.float64,
                                    fourier=fourier, fold=True, device="cpu")
    flat = SphericalHarmonics.build(pg, T, dtype=torch.float64,
                                    fourier=fourier, device="cpu")
    return jax_fold, fold, flat


def _spec(rng, lead, T):
    M = T + 1
    c = rng.randn(*lead, M, M) + 1j * rng.randn(*lead, M, M)
    c = c * (np.arange(M)[None, :] >= np.arange(M)[:, None])
    c[..., 0, :] = c[..., 0, :].real
    return 1e-5 * c


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("kind,nlat,nlon,T", GRIDS)
def test_fold_tables_match_jax(kind, nlat, nlon, T):
    jsh, psh, _ = _engines(kind, nlat, nlon, T)
    assert set(psh.fold_tabs) == set(jsh.fold_tabs)
    for name, (sym, anti, p) in psh.fold_tabs.items():
        js, ja, jp = jsh.fold_tabs[name]
        assert p == jp, name
        np.testing.assert_allclose(sym.numpy(), np.asarray(js), rtol=1e-12,
                                   atol=0)
        np.testing.assert_allclose(anti.numpy(), np.asarray(ja), rtol=1e-12,
                                   atol=0)
    np.testing.assert_array_equal(psh.even_m.numpy(), np.asarray(jsh.even_m))


@pytest.mark.parametrize("fourier", ["fft", "matmul"])
@pytest.mark.parametrize("kind,nlat,nlon,T", GRIDS)
def test_fold_transforms_match_unfolded_and_jax(kind, nlat, nlon, T, fourier):
    jsh, psh, flat = _engines(kind, nlat, nlon, T, fourier)
    rng = np.random.RandomState(0)
    spec = _spec(rng, (2,), T)
    grid = np.asarray(flat.synthesize(torch.from_numpy(spec)))
    field = rng.randn(2, nlat, nlon)
    u, v = rng.randn(2, nlat, nlon), rng.randn(2, nlat, nlon)
    inputs = {"spec": spec, "half": 0.5 * spec, "field": field,
              "grid": grid, "u": u, "v": v}
    cases = [
        ("synthesize", lambda e, a: e.synthesize(a["spec"])),
        ("analyze", lambda e, a: e.analyze(a["field"])),
        ("round trip", lambda e, a: e.analyze(a["grid"])),
        ("gradients", lambda e, a: e.gradients(a["spec"])),
        ("uv_from_vrtdiv", lambda e, a: e.uv_from_vrtdiv(a["spec"],
                                                         a["half"])),
        ("vrtdiv_from_uv", lambda e, a: e.vrtdiv_from_uv(a["u"], a["v"])),
    ]
    # JAX's side of every case, one compiled program.
    jax_outs = jax.jit(lambda a: [fn(jsh, a) for _, fn in cases])(
        {k: jnp.asarray(w) for k, w in inputs.items()})
    tensors = {k: torch.from_numpy(w) for k, w in inputs.items()}
    for (name, fn), jax_out in zip(cases, jax_outs):
        got = fn(psh, tensors)
        flat_out = fn(flat, tensors)
        if not isinstance(got, tuple):
            got, flat_out, jax_out = (got,), (flat_out,), (jax_out,)
        for g, f, j in zip(got, flat_out, jax_out):
            _close(g, f)
            _close(g, j)
    # The band-limited grid comes back to its coefficients.
    _close(psh.analyze(torch.from_numpy(grid)), spec)


def test_fold_equator_row_enters_once():
    """Odd J: the equator row of a field enters each half once (no mirror
    row is added to it), as in the JAX engine, and every antisymmetric
    table vanishes there, so it counts once in all."""
    jsh, psh, _ = _engines("regular", 9, 16, 6)
    x = np.random.RandomState(1).randn(3, 9)
    s, a = psh._fold_rows(torch.from_numpy(x))
    js, ja = jsh._fold_rows(jnp.asarray(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(s.numpy()[:, -1], x[:, 4])
    np.testing.assert_array_equal(a.numpy()[:, -1], x[:, 4])
    for name, (_, anti, _) in psh.fold_tabs.items():
        row = anti[:, -1, :] if name in ("P", "G", "H") else anti[..., -1]
        assert float(row.abs().max()) <= 1e-12 * float(anti.abs().max())
    np.testing.assert_allclose(psh._unfold_rows(s, a).numpy(), 2 * x,
                               rtol=1e-15)


def test_fold_rejects_an_asymmetric_grid():
    grid = LatLonGrid.from_coords(np.linspace(89.0, -80.0, 12),
                                  np.arange(24) * 15.0)
    with pytest.raises(ValueError, match="symmetric"):
        SphericalHarmonics.build(grid, 8, fold=True, device="cpu")


# ------------------------------------------------------- barotropic models
# The oracle's grids and limits (tests/test_reference_oracle.py): 40 steps
# of dt 1800 s in float64, packed spectral vorticity to rtol 1e-8 and
# heights to 1e-5 m.
N_STEPS, DT = 40, 1800.0


def _oracle_grid(kind):
    if kind == "gaussian":
        return LatLonGrid.gaussian(24, 48), 15
    return LatLonGrid.regular(25, 48), 10


def _oracle_z(grid, truncation):
    eng = PackedQuadratureTransforms(grid.nlon, grid.nlat, truncation,
                                     grid.lat, grid.quad_weights, grid.radius)
    rng = np.random.RandomState(7)
    coeff = rng.randn(eng.nspec) + 1j * rng.randn(eng.nspec)
    coeff *= np.exp(-0.15 * (eng.indxn + eng.indxm))
    coeff[eng.indxm == 0] = coeff[eng.indxm == 0].real
    coeff[0] = 0.0
    return 5500.0 + 40.0 * eng.spec_to_grid(coeff)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("grid_kind", ["gaussian", "regular"])
@pytest.mark.parametrize("form,mode,correct_sh", [
    ("vrt", "reference", None), ("vrt", "standard", None),
    ("psi", "reference", True), ("psi", "standard", False)])
def test_barotropic_matches_reference_oracle(form, mode, correct_sh,
                                             grid_kind, fold):
    grid, T = _oracle_grid(grid_kind)
    z0 = _oracle_z(grid, T)
    args = (z0, T, DT, grid.lat, grid.quad_weights, grid.radius)
    kw = dict(damping_coefficient=5e-6, spectral_mode=mode,
              dtype=torch.float64, fold=fold, device="cpu")
    if form == "vrt":
        oracle = RefBarotropicVrt(*args, damping_coefficient=5e-6, mode=mode)
        model = BarotropicModel(grid, T, dt=DT, **kw)
    else:
        oracle = RefBarotropicPsi(*args, damping_coefficient=5e-6, mode=mode,
                                  correct_sh=correct_sh)
        model = BarotropicModelPsi(grid, T, dt=DT, correct_sh=correct_sh,
                                   **kw)
    state = model.run(model.from_z(z0), N_STEPS)
    for _ in range(N_STEPS):
        oracle.step_forward()
    np.testing.assert_allclose(model.sh.pack(state.vrt_spec).numpy(),
                               oracle.vrt_spec, rtol=1e-8, atol=1e-16)
    z_oracle = oracle.z()
    np.testing.assert_allclose(model.z_grid(state).numpy(), z_oracle,
                               rtol=0, atol=1e-5)
    assert np.abs(z_oracle - z0).max() > 1.0


def _init_z(nlat, nlon, seed=0):
    lat = np.linspace(90.0, -90.0, nlat)
    lon = np.linspace(0.0, 360.0, nlon, endpoint=False)
    LON, LAT = np.meshgrid(lon, lat)
    rng = np.random.RandomState(seed)
    return (5500.0 + 200.0 * np.cos(np.radians(LAT)) ** 2
            + 30.0 * np.cos(np.radians(LAT)) ** 2 * np.sin(np.radians(3 * LON))
            + rng.randn(nlat, nlon))


@pytest.mark.parametrize("form", ["vrt", "psi"])
def test_barotropic_fold_matches_unfolded(form):
    """fold=True integrates the unfolded trajectory, on the plain engine
    and through ``step_impl='kernel'`` (whose step tables are the unfolded
    P, G and H); on the CPU the kernel's plain version runs."""
    g = LatLonGrid.regular(19, 36)
    cls = BarotropicModel if form == "vrt" else BarotropicModelPsi
    z0 = _init_z(19, 36, seed=3)
    runs = {}
    for fold in (False, True):
        for impl, dtype in (("plain", torch.float64),
                            ("kernel", torch.float32)):
            m = cls(g, 12, dt=1800.0, dtype=dtype, fold=fold,
                    step_impl=impl, device="cpu")
            runs[fold, impl] = m.run(m.from_z(z0), 12).vrt_spec.numpy()
    _close(runs[True, "plain"], runs[False, "plain"])
    _close(runs[True, "kernel"], runs[False, "kernel"], tol=1e-5)
    _close(runs[True, "kernel"], runs[True, "plain"], tol=1e-4)

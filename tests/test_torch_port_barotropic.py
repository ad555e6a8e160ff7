"""The port's barotropic cores against the JAX package's, on the CPU.

- The plain engine in float64 follows JAX ``run`` over 40 steps to
  1e-10 x the scale (only the order of sums differs; the leapfrog barely
  grows round-off over 40 steps) and reproduces the golden fixtures at the
  1e-8 of ``tests/test_golden.py``.
- The fused step's tables equal the JAX ones exactly in float32 (same
  float64 numpy composition of the same float32-rounded tables).
- The fused step's plain PyTorch version (what ``step_impl='kernel'`` runs
  on CPU tensors) follows the JAX Pallas kernel, run in interpret mode as
  ``tests/test_pallas_step.py`` runs it, to the 1e-5 relative bound that
  test holds the Pallas kernel to against the XLA scan (float32, 20 steps).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlwp_tpu import barotropic as jax_baro
from dlwp_tpu.grid import LatLonGrid as JaxGrid

import dlwp_torch.barotropic.fused_step as fused_step
from dlwp_torch import LatLonGrid, barotropic_state_from_numpy
from dlwp_torch import barotropic as port_baro
from dlwp_torch.barotropic.fused_step import (
    build_psi_step_tables,
    build_vrt_step_tables,
)
from dlwp_torch.kernels import barotropic_step, barotropic_step_plain, launch_counts

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden.npz")
TOL_F64 = 1e-10  # x scale: float64, sum order only
TOL_KERNEL = 1e-5  # relative max |dz|: float32, the JAX Pallas-vs-XLA bar
NLAT, NLON, T = 37, 72, 24

# (class, kwargs) of every variant: both forms, both spectral modes and,
# for the psi form, both hemisphere sign settings.
VARIANTS = [
    ("BarotropicModelPsi", {"spectral_mode": "reference", "correct_sh": True}),
    ("BarotropicModelPsi", {"spectral_mode": "reference", "correct_sh": False}),
    ("BarotropicModelPsi", {"spectral_mode": "standard", "correct_sh": True}),
    ("BarotropicModelPsi", {"spectral_mode": "standard", "correct_sh": False}),
    ("BarotropicModel", {"spectral_mode": "reference"}),
    ("BarotropicModel", {"spectral_mode": "standard"}),
]
KERNEL_FORMS = [
    ("BarotropicModelPsi", {"correct_sh": True}),
    ("BarotropicModelPsi", {"correct_sh": False}),
    ("BarotropicModel", {}),
]


def _ids(variant):
    cls, kw = variant
    return cls + "-" + "-".join(f"{k}={v}" for k, v in kw.items())


def _z0(seed=1, lead=()):
    return 100.0 * np.random.RandomState(seed).randn(*lead, NLAT, NLON)


def _pair(cls, kw, dtype64=True, impl=None, grid="regular", **extra):
    """The same model in both packages. ``impl`` picks the fused step
    (JAX 'pallas', port 'kernel'); float32 then."""
    jkw, pkw = dict(kw, **extra), dict(kw, **extra)
    if impl:
        jkw["step_impl"], pkw["step_impl"] = "pallas", "kernel"
    jdt = jnp.float64 if dtype64 else jnp.float32
    pdt = torch.float64 if dtype64 else torch.float32
    jm = getattr(jax_baro, cls)(getattr(JaxGrid, grid)(NLAT, NLON), T,
                                dt=1800.0, dtype=jdt, **jkw)
    pm = getattr(port_baro, cls)(getattr(LatLonGrid, grid)(NLAT, NLON), T,
                                 dt=1800.0, dtype=pdt, device="cpu", **pkw)
    return jm, pm


def _jax_run(jm, z0, n):
    with warnings.catch_warnings():  # Pallas interpret-mode notice
        warnings.simplefilter("ignore")
        return jm.run(jm.from_z(jnp.asarray(z0, jm.sh.dtype)), n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _assert_scaled(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_plain_trajectory_matches_jax_float64(variant):
    jm, pm = _pair(*variant)
    js = _jax_run(jm, _z0(), 40)
    ps = pm.run(pm.from_z(_z0()), 40)
    assert ps.step == int(js.step) == 40
    _assert_scaled(ps.vrt_spec.numpy(), js.vrt_spec, TOL_F64)
    _assert_scaled(ps.vrt_spec_prev.numpy(), js.vrt_spec_prev, TOL_F64)
    _assert_scaled(pm.z_grid(ps).numpy(), jm.z_grid(js), TOL_F64)


@pytest.mark.parametrize("fourier", ["fft", "matmul"])
@pytest.mark.parametrize("cls", ["BarotropicModelPsi", "BarotropicModel"])
def test_gaussian_grid_trajectory_matches_jax(cls, fourier):
    jm, pm = _pair(cls, {}, grid="gaussian", fourier=fourier)
    js = _jax_run(jm, _z0(), 20)
    ps = pm.run(pm.from_z(_z0()), 20)
    _assert_scaled(pm.z_grid(ps).numpy(), jm.z_grid(js), TOL_F64)
    for got, want in zip(pm.uv_grid(ps), jm.uv_grid(js)):
        _assert_scaled(got.numpy(), want, TOL_F64)
    _assert_scaled(pm.vrt_grid(ps).numpy(), jm.vrt_grid(js), TOL_F64)


@pytest.mark.parametrize(
    "key,cls,mode",
    [
        ("vrt_ref_z", "BarotropicModel", "reference"),
        ("vrt_std_z", "BarotropicModel", "standard"),
        ("psi_ref_z", "BarotropicModelPsi", "reference"),
    ],
)
def test_golden_40_step_trajectory(key, cls, mode):
    golden = np.load(GOLDEN)
    m = getattr(port_baro, cls)(LatLonGrid.regular(37, 72), 24, dt=1800.0,
                                damping_coefficient=5e-6, spectral_mode=mode,
                                dtype=torch.float64, device="cpu")
    st = m.run(m.from_z(golden["z0"]), 40)
    np.testing.assert_allclose(m.z_grid(st).numpy(), golden[key], rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("variant", KERNEL_FORMS + [
    ("BarotropicModelPsi", {"spectral_mode": "standard"}),
], ids=_ids)
def test_step_tables_equal_jax(variant):
    jm, pm = _pair(*variant, dtype64=False, impl=True)
    assert set(pm._kernel_tables) == set(jm._pallas_tables)
    for name, want in jm._pallas_tables.items():
        got = pm._kernel_tables[name]
        assert got.dtype == torch.float32 and got.is_contiguous(), name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    build = (build_psi_step_tables if variant[0] == "BarotropicModelPsi"
             else build_vrt_step_tables)
    again = build(pm)
    for name, t in again.items():
        assert torch.equal(t, pm._kernel_tables[name]), name


@pytest.mark.parametrize("variant", KERNEL_FORMS, ids=_ids)
def test_kernel_plain_version_matches_jax_pallas(variant):
    """20 float32 steps at T24 on 37x72: the port's fused step on the CPU
    (the kernel's plain version) against the JAX Pallas kernel."""
    jm, pm = _pair(*variant, dtype64=False, impl=True)
    counts = launch_counts()
    js = _jax_run(jm, _z0(), 20)
    ps = pm.run(pm.from_z(_z0().astype(np.float32)), 20)
    assert launch_counts() == counts  # CPU tensors never launch
    assert ps.step == 20 and ps.vrt_spec.dtype == torch.complex64
    assert _rel(pm.z_grid(ps), jm.z_grid(js)) <= TOL_KERNEL
    assert _rel(ps.vrt_spec.numpy(), js.vrt_spec) <= TOL_KERNEL


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("cls", ["BarotropicModelPsi", "BarotropicModel"])
def test_resume_is_bit_equal(cls, impl):
    """7 + 13 steps == 20 steps exactly: the Euler first step fires only at
    global step 0, threaded through the state's counter."""
    m = getattr(port_baro, cls)(LatLonGrid.regular(NLAT, NLON), T, dt=1800.0,
                                step_impl=impl, device="cpu")
    s0 = m.from_z(_z0())
    s20 = m.run(s0, 20)
    s2 = m.run(m.run(s0, 7), 13)
    assert s2.step == s20.step == 20
    assert torch.equal(s2.vrt_spec, s20.vrt_spec)
    assert torch.equal(s2.vrt_spec_prev, s20.vrt_spec_prev)
    assert torch.equal(s2.t, s20.t)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_run_with_snapshots_times_equal_jax(impl):
    # dt not exactly representable in float32: the times are n sequential
    # float32 additions in both packages and in both engines.
    dt = 1000.0 / 3.0
    jm = jax_baro.BarotropicModelPsi(JaxGrid.regular(NLAT, NLON), T, dt=dt)
    pm = port_baro.BarotropicModelPsi(LatLonGrid.regular(NLAT, NLON), T,
                                      dt=dt, step_impl=impl, device="cpu")
    _, tj, zj = jm.run_with_snapshots(
        jm.from_z(jnp.asarray(_z0(), jnp.float32)), 3, 4)
    state, tp, zp = pm.run_with_snapshots(pm.from_z(_z0()), 3, 4)
    assert tp.dtype == torch.float32 and tp.device.type == "cpu"
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    assert zp.shape == (3, NLAT, NLON) and state.step == 12
    assert _rel(zp, zj) <= TOL_KERNEL


def test_batched_state_runs_plain_engine(monkeypatch):
    """Leading batch dims take the plain engine even with
    step_impl='kernel', and each member matches its own single run."""
    m = port_baro.BarotropicModelPsi(LatLonGrid.regular(NLAT, NLON), T,
                                     dt=1800.0, step_impl="kernel",
                                     device="cpu")
    plain = port_baro.BarotropicModelPsi(LatLonGrid.regular(NLAT, NLON), T,
                                         dt=1800.0, device="cpu")
    solo = m.run(m.from_z(_z0(2)), 5)  # single member: the fused step

    def refuse(*args, **kwargs):
        raise AssertionError("batched state reached the fused step")

    monkeypatch.setattr(fused_step, "run_fused", refuse)
    out = m.run(m.from_z(np.stack([_z0(1), _z0(2)])), 5)
    assert out.vrt_spec.shape == (2, T + 1, T + 1)
    ref = plain.run(plain.from_z(_z0(2)), 5).vrt_spec.numpy()
    _assert_scaled(out.vrt_spec[1].numpy(), ref, 1e-6)
    _assert_scaled(solo.vrt_spec.numpy(), ref, TOL_KERNEL)


@pytest.mark.parametrize("cls,impl", [("BarotropicModelPsi", None),
                                      ("BarotropicModel", None),
                                      ("BarotropicModelPsi", True)])
def test_jax_state_resumes_in_port(cls, impl):
    """A JAX state after 7 steps, taken out as numpy, runs 13 more steps in
    the port and lands on JAX's 20."""
    jm, pm = _pair(cls, {}, dtype64=impl is None, impl=impl)
    js7 = _jax_run(jm, _z0(), 7)
    js20 = _jax_run(jm, _z0(), 20)
    state = barotropic_state_from_numpy(
        np.asarray(js7.vrt_spec), np.asarray(js7.vrt_spec_prev),
        np.asarray(js7.step), np.asarray(js7.t), device="cpu")
    assert state.step == 7 and float(state.t) == 7 * 1800.0
    ps = pm.run(state, 13)
    assert ps.step == 20 and float(ps.t) == float(js20.t)
    if impl is None:
        _assert_scaled(ps.vrt_spec.numpy(), js20.vrt_spec, TOL_F64)
    else:
        assert _rel(ps.vrt_spec.numpy(), js20.vrt_spec) <= TOL_KERNEL


def test_state_bridge_rejects_mismatched_spectra():
    a = np.zeros((3, 3), np.complex64)
    with pytest.raises(ValueError):
        barotropic_state_from_numpy(a, a.astype(np.complex128), 0, 0.0,
                                    device="cpu")
    with pytest.raises(ValueError):
        barotropic_state_from_numpy(a.real, a.real, 0, 0.0, device="cpu")


def test_step_impl_names_and_dtype_rules():
    grid = LatLonGrid.regular(NLAT, NLON)
    for bad in ("xla", "pallas", "fused"):
        with pytest.raises(ValueError):
            port_baro.BarotropicModelPsi(grid, T, dt=1800.0, step_impl=bad,
                                         device="cpu")
    with pytest.raises(ValueError):
        port_baro.BarotropicModel(grid, T, dt=1800.0, dtype=torch.float64,
                                  step_impl="kernel", device="cpu")
    with pytest.raises(NotImplementedError):
        port_baro.BarotropicModel(grid, T, dt=1800.0, fold=True, device="cpu")


def test_wrapper_checks_operands():
    m = port_baro.BarotropicModel(LatLonGrid.regular(NLAT, NLON), T,
                                  dt=1800.0, step_impl="kernel", device="cpu")
    s = m.from_z(_z0())
    parts = [s.vrt_spec.real.contiguous(), s.vrt_spec.imag.contiguous()] * 2
    args = (0, 1, m.dt, m.robert_coefficient)
    with pytest.raises(ValueError):
        barotropic_step("spectral", m._kernel_tables, *parts, *args)
    tabs = dict(m._kernel_tables)
    tabs["Au"] = tabs["Au"][:, :, :-1]
    with pytest.raises(ValueError, match="Au"):
        barotropic_step_plain("vrt", tabs, *parts, *args)
    del tabs["Av"]
    with pytest.raises(KeyError):
        barotropic_step_plain("vrt", tabs, *parts, *args)
    with pytest.raises(ValueError):
        barotropic_step("vrt", m._kernel_tables, *parts[:3],
                        parts[3].double(), *args)

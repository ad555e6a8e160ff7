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
from dlwp_torch.spectral import dft_tables
from dlwp_torch.kernels.barotropic_step import (
    ANA_TABLES,
    LAYOUT_FIELDS,
    NF,
    NP,
    SPLIT,
    SYN_TABLES,
    _launch,
    _layout_arg,
    layout,
    pack_tables,
    pair_entries,
)

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
    # fold=True (ported since) reaches the engine; its parity tests are in
    # tests/test_torch_port_fold.py.
    assert port_baro.BarotropicModel(grid, T, dt=1800.0, fold=True,
                                     device="cpu").sh.fold


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


def _chunks(n):
    """The kernel's kSplit chunks of a contraction of length ``n``."""
    ch = -(-n // SPLIT)
    return [range(s * ch, min(n, (s + 1) * ch)) for s in range(SPLIT)]


def _emulate_kernel(form, tables, packed, state, step0, n_steps, dt, r):
    """The redesigned kernel's indexing and summation order in numpy float64:
    row pairs (m, M-1-m) over the packed n >= m entries (in ``a_split``
    chunks of the pair's entries), per-output sequential sums over
    ``_chunks`` added in chunk order, twiddles at (m*l) mod L with the
    pairs l, L-l, the weights applied to each synthesised mode, the forward
    sums scaled by 1/L at the end. Vectorised only over outputs, never over
    a sum."""
    tab, tw, wts = (packed[k].numpy() for k in ("tab", "tw", "wts"))
    damp, dden = tables["damp"].numpy(), tables["dden"].numpy()
    vr, vi, pr, pi = (s.numpy().copy() for s in state)
    M = vr.shape[0]
    L = tables["dinv"].shape[0]
    J = tables[SYN_TABLES[form][0]].shape[1]
    K1, nl, P = M + 1, L // 2 + 1, (M + 1) // 2
    ns, nf, npp = len(SYN_TABLES[form]), NF[form], NP[form]
    slab = K1 * J
    ls, ms = np.arange(nl), np.arange(M)
    paired = (ls > 0) & (2 * ls != L)

    def rows(b):
        entries, c1 = pair_entries(M, b)
        segs = [(0, c1, b)]
        if M - 1 - b != b:
            segs.append((c1, K1, M - 1 - b))
        return entries, segs

    def synthesise():
        syn = np.zeros((J, M, 2 * nf))
        sa = SPLIT
        for b in range(P):
            entries, segs = rows(b)
            if form == "psi":
                inv = tables["invF"].numpy()
                xs = np.array([[vr[m, n] * inv[m, n], vi[m, n] * inv[m, n],
                                vr[m, n], vi[m, n]] if m >= 0 else [0.0] * 4
                               for m, n in entries])
            else:
                xs = np.array([[vr[m, n], vi[m, n]] if m >= 0 else [0.0] * 2
                               for m, n in entries])
            kend = segs[-1][1]
            ch = -(-kend // sa)
            for t in range(ns):
                T = tab[b, t, :slab].reshape(K1, J)
                for k0, k1, m in segs:
                    # Chunk s of the pair's entries, this row's part of it.
                    parts = []
                    for s in range(sa):
                        a = np.zeros((J, xs.shape[1]))
                        for k in range(max(k0, s * ch),
                                       min(k1, (s + 1) * ch)):
                            a = a + T[k][:, None] * xs[k][None, :]
                        parts.append(a)
                    a = parts[0]
                    for part in parts[1:]:
                        a = a + part
                    if form == "psi":
                        f = ([-a[:, 1], a[:, 0], -a[:, 3], a[:, 2]] if t == 0
                             else [a[:, 0], a[:, 1], a[:, 2], a[:, 3]])
                    else:
                        f = [[a[:, 0], a[:, 1]], [-a[:, 0], -a[:, 1]],
                             [-a[:, 1], a[:, 0]]][t]
                    base = 4 * t if form == "psi" else 2 * t
                    for i, v in enumerate(f):
                        syn[:, m, base + i] = v * wts[i % 2, m]
        return syn

    def columns(syn):
        # Inverse DFT partials (j, s, l, field, C|S), then their sum.
        part = np.zeros((J, SPLIT, nl, nf, 2))
        for s, chunk in enumerate(_chunks(M)):
            for m in chunk:
                idx = (m * ls) % L
                for f in range(nf):
                    part[:, s, :, f, 0] += syn[:, m, 2 * f, None] * tw[idx, 0]
                    part[:, s, :, f, 1] += (syn[:, m, 2 * f + 1, None]
                                            * tw[idx, 1])
        cs = part[:, 0]
        for s in range(1, SPLIT):
            cs = cs + part[:, s]
        g_l, g_r = cs[..., 0] + cs[..., 1], cs[..., 0] - cs[..., 1]
        if form == "psi":
            prods = [[g[..., 0] * g[..., 3] - g[..., 2] * g[..., 1]]
                     for g in (g_l, g_r)]
        else:
            f_row = tables["f_row"].numpy()[0][:, None]
            prods = [[-(f_row + g[..., 0]) * g[..., 2],
                      (f_row + g[..., 0]) * g[..., 1]] for g in (g_l, g_r)]
        psum = [np.where(paired, a + c, a) for a, c in zip(*prods)]
        pdif = [np.where(paired, a - c, a) for a, c in zip(*prods)]
        fpart = np.zeros((J, SPLIT, M, npp, 2))
        for s, chunk in enumerate(_chunks(nl)):
            for l in chunk:
                idx = (ms * l) % L
                for q in range(npp):
                    fpart[:, s, :, q, 0] += tw[idx, 0] * psum[q][:, l, None]
                    fpart[:, s, :, q, 1] += tw[idx, 1] * pdif[q][:, l, None]
        out = fpart[:, 0]
        for s in range(1, SPLIT):
            out = out + fpart[:, s]
        # cos/L and -sin/L: the sums scaled by the table's 1/L.
        out = out * np.array([tw[0, 2], -tw[0, 2]])
        return out.transpose(1, 0, 2, 3)  # (M, J, NP, 2)

    def analyse_and_step(fwd, first):
        for b in range(P):
            entries, segs = rows(b)
            kend = segs[-1][1]
            A = tab[b, ns:, :K1 * J].reshape(-1, J, K1)
            row_of = np.array([0 if k < segs[0][1] else 1
                               for k in range(kend)])
            fc = np.stack([fwd[m].reshape(J, -1) for _, _, m in segs])
            part = np.zeros((SPLIT, kend, 2 if form == "psi" else 4))
            for s, chunk in enumerate(_chunks(J)):
                for j in chunk:
                    v = fc[row_of, j]  # (kend, 2 NP)
                    a = A[:, j, :kend]
                    if form == "psi":
                        part[s] += a[0][:, None] * v
                    else:
                        part[s] += np.stack([a[0] * v[:, 0], a[1] * v[:, 3],
                                             a[0] * v[:, 1], a[1] * v[:, 2]],
                                            axis=1)
            tot = part[0]
            for s in range(1, SPLIT):
                tot = tot + part[s]
            if form == "psi":
                tend = tot
            else:
                tend = np.stack([tot[:, 0] - tot[:, 1], tot[:, 2] + tot[:, 3]],
                                axis=1)
            for r_, (k0, k1, m) in enumerate(segs):
                tr, ti = np.zeros(M), np.zeros(M)
                tr[m:], ti[m:] = tend[k0:k1, 0], tend[k0:k1, 1]
                dzr = (tr - damp[m] * pr[m]) * dden[m]
                dzi = (ti - damp[m] * pi[m]) * dden[m]
                if first:
                    nr, ni = vr[m] + dt * dzr, vi[m] + dt * dzi
                    pr[m], pi[m] = vr[m] + r * (nr - vr[m]), vi[m] + r * (
                        ni - vi[m])
                else:
                    nr, ni = pr[m] + 2 * dt * dzr, pi[m] + 2 * dt * dzi
                    pr[m] = vr[m] + r * (pr[m] - 2 * vr[m]) + r * nr
                    pi[m] = vi[m] + r * (pi[m] - 2 * vi[m]) + r * ni
                vr[m], vi[m] = nr, ni

    for i in range(n_steps):
        analyse_and_step(columns(synthesise()), step0 + i == 0)
    return vr, vi, pr, pi


@pytest.mark.parametrize("variant", KERNEL_FORMS, ids=_ids)
def test_kernel_emulation_matches_plain_float64(variant):
    """The packed layout, row pairs, n >= m skipping, twiddles and summation
    order of csrc/barotropic_step.cu, emulated in float64, reproduce the
    plain version on the same (float32-rounded) tables to 1e-12."""
    cls, kw = variant
    m = getattr(port_baro, cls)(LatLonGrid.regular(NLAT, NLON), T, dt=1800.0,
                                damping_coefficient=5e-6, step_impl="kernel",
                                device="cpu", **kw)
    # The Legendre tables as the card holds them (float32-rounded); the DFT
    # matrices in float64, as the kernel's twiddles are computed.
    tabs = {k: v.double() for k, v in m._kernel_tables.items()}
    fwd, inv = dft_tables(NLON, T + 1)
    tabs.update(dinv=torch.from_numpy(inv.T.copy()),
                dfwd_re=torch.from_numpy(fwd[:, :T + 1].T.copy()),
                dfwd_im=torch.from_numpy(fwd[:, T + 1:].T.copy()))
    packed = pack_tables(m._kernel_form, tabs)
    s0 = m.from_z(_z0())
    state = [x.double().contiguous() for x in (
        s0.vrt_spec.real, s0.vrt_spec.imag, s0.vrt_spec.real,
        s0.vrt_spec.imag)]
    args = (0, 6, m.dt, m.robert_coefficient)
    want = barotropic_step_plain(m._kernel_form, tabs, *state, *args)
    got = _emulate_kernel(m._kernel_form, tabs, packed, state, *args)
    for g, w in zip(got, want):
        assert _rel(g, w.numpy()) <= 1e-12
    # The float32 packing is the float64 one rounded.
    for k, v in m._kernel_tables.packed.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(),
                                      packed[k].numpy().astype(np.float32))


@pytest.mark.parametrize("M", [2, 3, 25, 26, 73, 74])
def test_row_pairs_cover_each_entry_once(M):
    """Row pairs (m, M-1-m): every (m, n >= m) once, M+1 entries a pair,
    padding only after the middle row of odd M."""
    seen = []
    for b in range((M + 1) // 2):
        entries, c1 = pair_entries(M, b)
        assert len(entries) == M + 1 and c1 == M - b
        assert all(e == (b, b + k) for k, e in enumerate(entries[:c1]))
        pad = [e for e in entries if e == (-1, -1)]
        assert len(pad) == ((M + 1) // 2 if 2 * b == M - 1 else 0)
        seen += [e for e in entries if e != (-1, -1)]
    assert sorted(seen) == [(m, n) for m in range(M) for n in range(m, M)]


@pytest.mark.parametrize("form,M,J,L,kb", [("psi", 73, 73, 144, 138),
                                           ("vrt", 73, 73, 144, 173),
                                           ("psi", 25, 37, 72, 34),
                                           ("vrt", 25, 37, 72, 38)])
def test_kernel_layout_fits(form, M, J, L, kb):
    """The shared-memory layout: 16-byte aligned regions, tables resident
    within Hopper's 227 KB at T72 on 73x144, passed to the kernel field by
    field as it is; larger grids are refused before launch."""
    lay = layout(form, M, J, L)
    assert all(v % 4 == 0 for k, v in lay.items()
               if k not in ("bytes", "nlp"))
    assert lay["bytes"] // 1024 == kb and lay["bytes"] <= 227 * 1024
    nt = len(SYN_TABLES[form]) + len(ANA_TABLES[form])
    assert lay["twm"] - lay["tab"] == nt * lay["slab"]
    assert lay["nlp"] % 2 == 1 and lay["nlp"] >= L // 2 + 1
    assert list(_layout_arg(form, M, J, L)) == [lay[k] for k in LAYOUT_FIELDS]
    assert list(LAYOUT_FIELDS) == ["slab", "nlp"] + [
        k for k in lay if k not in ("slab", "nlp")]
    with pytest.raises(ValueError, match="step_impl='plain'"):
        _layout_arg(form, 129, 128, 256)  # T128 on 128x256: over 227 KB


def test_packing_refuses_tables_not_zero_below_the_diagonal():
    m = port_baro.BarotropicModel(LatLonGrid.regular(NLAT, NLON), T,
                                  dt=1800.0, step_impl="kernel", device="cpu")
    tabs = dict(m._kernel_tables)
    tabs["Au"] = tabs["Au"].clone()
    tabs["Au"][3, 1, 0] = 1.0
    with pytest.raises(ValueError, match="Au"):
        pack_tables("vrt", tabs)


def test_kernel_launch_refuses_tables_that_are_not_packed():
    """The kernel reads tables packed once (StepTables); a plain dict is
    refused before any launch, not packed again at each one."""
    m = port_baro.BarotropicModel(LatLonGrid.regular(NLAT, NLON), T,
                                  dt=1800.0, step_impl="kernel", device="cpu")
    state = [torch.zeros(T + 1, T + 1) for _ in range(4)]
    with pytest.raises(ValueError, match=r"StepTables\(form, tables\)"):
        _launch("vrt", dict(m._kernel_tables), state, 0, 1, m.dt, 0.01)

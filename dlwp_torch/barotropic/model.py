"""Barotropic vorticity equation dynamical cores (port of
``dlwp_tpu.barotropic.model``).

The reference's barotropic models (``DLWP/barotropic/model.py:26-199``
vorticity form, ``:202-346`` streamfunction form) with the JAX package's
numerics:

- forward-Euler first step, then leapfrog, with the Robert-Asselin filter
  applied in the reference's exact interleave (model.py:137-153);
- implicit del^(2*damping_order) hyperdiffusion
  (``coeffs = 1/(1 + damping*dt)``, model.py:135-136);
- ``spectral_mode='reference'`` (default) reproduces the reference's
  ``(m + n)(m + n + 1)`` damping wavenumber and ``-(n+1)(n+2)/a^2``
  height inversion; ``'standard'`` uses the textbook n(n+1) forms.

States may carry leading batch dimensions (ensemble members, init times).

Engines (``step_impl``; the JAX package's names in brackets):

- ``'plain'`` (``'xla'``, the default): ``step_forward`` in a Python loop,
  PyTorch tensor ops (FFT or DFT products and Legendre contractions).
- ``'kernel'`` (``'pallas'``): for a single-member (unbatched) float32
  state, ``run(state, n)`` is one launch of the cooperative CUDA kernel
  ``csrc/barotropic_step.cu`` on the card (the port of the fused Pallas
  step), through :func:`dlwp_torch.kernels.barotropic_step`; on CPU
  tensors that wrapper takes its plain PyTorch version. Batched states run
  the plain engine, as the JAX package does for ensembles. A build or
  launch error raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dlwp_torch.grid.latlon import GRAVITY, OMEGA, LatLonGrid
from dlwp_torch.spectral.transforms import (
    SphericalHarmonics,
    real_dtype,
    to_numpy,
)

STEP_IMPLS = ("plain", "kernel")


@dataclasses.dataclass(frozen=True)
class BarotropicState:
    """Prognostic state: spectral vorticity at current and previous step.

    ``vrt_spec``/``vrt_spec_prev`` are complex tensors of shape
    (..., T+1, T+1) on the model's device; ``step`` is the step counter
    (0 before the first step, which is forward Euler); ``t`` is model time
    in seconds, a 0-d tensor in the model's real dtype kept on the host so
    that advancing it never waits on the card.
    """

    vrt_spec: torch.Tensor
    vrt_spec_prev: torch.Tensor
    step: int
    t: torch.Tensor


def advance_time(t: torch.Tensor, dt: float, n: int) -> torch.Tensor:
    """``t`` after ``n`` sequential additions of ``dt`` in ``t``'s dtype: the
    rounding of a scan of ``t + dt``, so snapshot times do not depend on
    the engine or on how the steps are split into calls."""
    ty = np.float32 if t.dtype == torch.float32 else np.float64
    acc, inc = ty(t.item()), ty(dt)
    for _ in range(n):
        acc = acc + inc
    return torch.tensor(acc, dtype=t.dtype)


def _hyperdiffusion(
    sh: SphericalHarmonics,
    damping_coefficient: float,
    damping_order: int,
    truncation: int,
    mode: str,
) -> np.ndarray:
    """Per-mode damping coefficients (dense [m, n] layout)."""
    n = to_numpy(sh.n_total)
    m = np.arange(truncation + 1, dtype=np.float64)[:, None]
    a2 = sh.grid.radius**2
    if mode == "reference":
        # Reference model.py:69-71: el = (m + n)(m + n + 1)/a^2 with n the
        # total degree; normalized by the packed-index-T element = (m=0, n=T).
        el = (m + n) * (m + n + 1.0) / a2
        el_t = truncation * (truncation + 1.0) / a2
    elif mode == "standard":
        el = n * (n + 1.0) / a2
        el_t = truncation * (truncation + 1.0) / a2
    else:
        raise ValueError("spectral_mode must be 'reference' or 'standard'")
    damp = damping_coefficient * (el / el_t) ** damping_order
    return damp * to_numpy(sh.mask)


def _z_vrt_factor(sh: SphericalHarmonics, mode: str) -> np.ndarray:
    """Spectral factor F with vrt = F * z (dense [m, n]).

    'reference': F = -(n+1)(n+2)/a^2 (reference model.py:189-199 uses
    degree+1 in the n(n+1) formula). 'standard': the true Laplacian
    eigenvalue -n(n+1)/a^2 (zero mode annihilated on inversion).
    """
    n = to_numpy(sh.n_total)
    a2 = sh.grid.radius**2
    if mode == "reference":
        f = -(n + 1.0) * (n + 2.0) / a2
    else:
        f = -n * (n + 1.0) / a2
    return f * to_numpy(sh.mask)


class _BarotropicBase:
    """Shared scheme: Robert-filtered leapfrog + implicit hyperdiffusion."""

    def __init__(
        self,
        grid: LatLonGrid,
        truncation: int,
        dt: float,
        robert_coefficient: float = 0.04,
        damping_coefficient: float = 1e-4,
        damping_order: int = 4,
        spectral_mode: str = "reference",
        dtype=torch.float32,
        fourier: str = "fft",
        fold: bool = False,
        step_impl: str = "plain",
        device=None,
    ):
        if step_impl not in STEP_IMPLS:
            raise ValueError(f"step_impl must be one of {STEP_IMPLS}")
        dtype = real_dtype(dtype)
        if step_impl == "kernel" and dtype != torch.float32:
            raise ValueError("step_impl='kernel' supports float32 only")
        self.step_impl = step_impl
        self.grid = grid
        self.truncation = int(truncation)
        self.dt = float(dt)
        self.robert_coefficient = float(robert_coefficient)
        self.spectral_mode = spectral_mode
        self.sh = SphericalHarmonics.build(
            grid, truncation, dtype=dtype, fourier=fourier, fold=fold,
            device=device,
        )
        self.device = self.sh.device
        self.dtype = dtype

        def tensor(x):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        self.damping = tensor(_hyperdiffusion(
            self.sh, damping_coefficient, damping_order, self.truncation,
            spectral_mode,
        ))
        self.z_vrt_factor = tensor(_z_vrt_factor(self.sh, spectral_mode))
        with np.errstate(divide="ignore"):
            inv = 1.0 / to_numpy(self.z_vrt_factor)
        inv = np.where(np.isfinite(inv) & to_numpy(self.sh.mask).astype(bool),
                       inv, 0.0)
        self.inv_z_vrt_factor = tensor(inv)
        # Coriolis parameter on the grid, (nlat, 1) for broadcasting.
        self.f_grid = tensor(grid.coriolis[:, None])

    # ---- tendency is supplied by subclasses -------------------------------
    def _tendency(self, vrt_spec: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _state(self, vrt_spec: torch.Tensor) -> BarotropicState:
        return BarotropicState(vrt_spec=vrt_spec, vrt_spec_prev=vrt_spec,
                               step=0, t=torch.tensor(0.0, dtype=self.dtype))

    def _grid_input(self, z) -> torch.Tensor:
        return torch.as_tensor(z, dtype=self.dtype, device=self.device)

    def from_vorticity_spec(self, vrt_spec) -> BarotropicState:
        """Initialize directly from spectral vorticity (e.g. analytic tests)."""
        return self._state(torch.as_tensor(vrt_spec, dtype=self.sh.cdtype,
                                           device=self.device))

    # ---- time stepping ----------------------------------------------------
    def step_forward(self, state: BarotropicState) -> BarotropicState:
        """One Robert-filtered (leapfrog | first-step Euler) step.

        Functional transliteration of the reference's in-place interleave
        (model.py:126-159): after the step, ``vrt_spec`` holds the
        *unfiltered* new value and ``vrt_spec_prev`` the *filtered* old
        current value.
        """
        r = self.robert_coefficient
        cur, prev = state.vrt_spec, state.vrt_spec_prev
        dzdt = self._tendency(cur)
        # Implicit hyperdiffusion against the lagged state (model.py:135-136).
        dzdt = (dzdt - self.damping * prev) / (1.0 + self.damping * self.dt)
        if state.step == 0:
            new = cur + self.dt * dzdt
            filtered = cur + r * (new - cur)
        else:
            filtered_cur = cur + r * (prev - 2.0 * cur)
            new = prev + 2.0 * self.dt * dzdt
            filtered = filtered_cur + r * new
        return BarotropicState(vrt_spec=new, vrt_spec_prev=filtered,
                               step=state.step + 1,
                               t=advance_time(state.t, self.dt, 1))

    def _use_kernel(self, state: BarotropicState) -> bool:
        """The fused kernel serves opted-in single-member states; batched
        (ensemble) states run the plain engine."""
        return self.step_impl == "kernel" and state.vrt_spec.ndim == 2

    def _advance(self, state: BarotropicState, k: int) -> BarotropicState:
        """Advance ``k`` steps with the configured engine."""
        if self._use_kernel(state):
            from dlwp_torch.barotropic.fused_step import run_fused

            return run_fused(self, state, k)
        for _ in range(k):
            state = self.step_forward(state)
        return state

    @torch.no_grad()
    def run(self, state: BarotropicState, n_steps: int) -> BarotropicState:
        """Integrate ``n_steps`` (with ``step_impl='kernel'`` and a single
        member: one kernel launch)."""
        return self._advance(state, int(n_steps))

    @torch.no_grad()
    def run_with_snapshots(
        self, state: BarotropicState, n_snapshots: int, snapshot_every: int
    ):
        """Integrate, returning height-field snapshots.

        Equivalent of the reference generator ``run_with_snapshots``
        (model.py:161-187): ``(state, times (n_snapshots,), z (n_snapshots,
        ..., nlat, nlon))``, times on the host, heights on the device. Each
        snapshot is one ``_advance`` (one kernel launch with
        ``step_impl='kernel'``).
        """
        times, zs = [], []
        for _ in range(int(n_snapshots)):
            state = self._advance(state, int(snapshot_every))
            times.append(state.t)
            zs.append(self.z_grid(state))
        return state, torch.stack(times), torch.stack(zs)

    # ---- diagnostics ------------------------------------------------------
    def vrt_grid(self, state: BarotropicState) -> torch.Tensor:
        return self.sh.synthesize(state.vrt_spec)

    def uv_grid(self, state: BarotropicState):
        return self.sh.uv_from_vrtdiv(
            state.vrt_spec, torch.zeros_like(state.vrt_spec)
        )

    def z_grid(self, state: BarotropicState) -> torch.Tensor:
        raise NotImplementedError


class BarotropicModel(_BarotropicBase):
    """Vorticity-form core (reference ``BarotropicModel``, model.py:26-199).

    Advects absolute vorticity with the nondivergent wind: d(zeta)/dt from
    the curl of (-(f+zeta)v, (f+zeta)u) through the vector spherical-harmonic
    analysis. Height is diagnosed from vorticity via the (mode-dependent)
    spectral inversion factor.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.step_impl == "kernel":
            from dlwp_torch.barotropic.fused_step import build_vrt_step_tables

            self._kernel_form = "vrt"
            self._kernel_tables = build_vrt_step_tables(self)
        # Stacked synthesis table: vrt, u and v are all linear in
        # psi = inv_lap(vrt), so one (m, 3J, n) contraction gives all three
        # Fourier-mode sets:
        #   rows [0, J):   P * lap_eig   -> vrt
        #   rows [J, 2J):  -H / a        -> u  (chi = 0)
        #   rows [2J, 3J): G / a         -> v  (times i*m afterwards)
        sh = self.sh
        a = self.grid.radius
        P_lap = sh.P * sh.laplacian_eig[:, None, :]
        self._syn_table = torch.cat([P_lap, -sh.H / a, sh.G / a], dim=1)

    def from_z(self, z) -> BarotropicState:
        """Initialize from a height field (reference set_state, model.py:99):
        vrt = F * analyze(z); prev = current so the implicit damping sees a
        consistent lagged state."""
        z = self._grid_input(z)
        return self._state(self.z_vrt_factor * self.sh.analyze(z))

    def _tendency(self, vrt_spec: torch.Tensor) -> torch.Tensor:
        sh = self.sh
        J = self.grid.nlat
        psi = (vrt_spec * sh.inv_laplacian_eig).to(sh.cdtype)
        # vrt loses its n=0 mode through inv_lap/lap; restore it exactly.
        n0 = vrt_spec[..., :, 0:1]
        modes = sh._legendre_syn(self._syn_table, psi)  # (..., m, 3J)
        im = (1j * sh.m_vals).to(sh.cdtype)[:, None]
        stacked = torch.stack([
            modes[..., :J] + sh._legendre_syn(sh.P[:, :, 0:1], n0),  # vrt
            modes[..., J:2 * J],  # u
            im * modes[..., 2 * J:],  # v
        ])
        vrt, u, v = sh._inv_fourier(stacked)  # one batched inverse
        abs_vrt = self.f_grid + vrt
        dzdt, _ = sh.vrtdiv_from_uv(-abs_vrt * v, abs_vrt * u)
        return dzdt

    def z_grid(self, state: BarotropicState) -> torch.Tensor:
        """Diagnose height from vorticity (reference get_z, model.py:189)."""
        vrt = self.sh.synthesize(state.vrt_spec)
        z_spec = self.sh.analyze(vrt) * self.inv_z_vrt_factor
        return self.sh.synthesize(z_spec)


class BarotropicModelPsi(_BarotropicBase):
    """Streamfunction-form core (reference ``BarotropicModelPsi``,
    model.py:202-346): psi = g z / f0, advection via the spectral Jacobian
    J(psi, zeta), optional southern-hemisphere sign correction."""

    def __init__(self, *args, f0: float = 2 * OMEGA, correct_sh: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.f0 = float(f0)
        self.correct_sh = bool(correct_sh)
        if self.correct_sh:
            # The reference flips the tendency sign in the southern
            # hemisphere via a grid round trip (model.py:298-301). The
            # multiplier is latitude-only, so the round trip collapses to a
            # precomputed spectral operator.
            sign = np.where(self.grid.lat < 0, -1.0, 1.0)
            self._sign_op = self.sh.mu_multiplier_operator(sign)
        if self.step_impl == "kernel":
            from dlwp_torch.barotropic.fused_step import build_psi_step_tables

            self._kernel_form = "psi"
            self._kernel_tables = build_psi_step_tables(self)

    def from_z(self, z) -> BarotropicState:
        psi = GRAVITY * self._grid_input(z) / self.f0
        return self._state(self.z_vrt_factor * self.sh.analyze(psi))

    def _tendency(self, vrt_spec: torch.Tensor) -> torch.Tensor:
        psi_spec = vrt_spec * self.inv_z_vrt_factor
        # One stacked gradients call for (psi, vrt).
        dx, dy = self.sh.gradients(torch.stack([psi_spec, vrt_spec]))
        jac = dx[0] * dy[1] - dy[0] * dx[1]
        dzdt = -self.sh.analyze(jac)
        if self.correct_sh:
            dzdt = self.sh.apply_mu_multiplier(self._sign_op, dzdt)
        return dzdt

    def psi_grid(self, state: BarotropicState) -> torch.Tensor:
        return self.sh.synthesize(state.vrt_spec * self.inv_z_vrt_factor)

    def z_grid(self, state: BarotropicState) -> torch.Tensor:
        return self.f0 * self.psi_grid(state) / GRAVITY

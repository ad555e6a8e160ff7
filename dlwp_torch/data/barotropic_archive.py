"""Barotropic-generated training archives (port of
``dlwp_tpu.data.barotropic_archive``).

A :class:`DataSource` serving a perturbed-restart HGT/500 + VRT/500 series
of chaotic barotropic dynamics, the data of the repo's "paper run"
(``examples/make_barotropic_archive.py``):

- **Perturbed restarts.** K independent ``segment_days`` trajectories from
  perturbed initial states (solid-body superrotation, a ``sin^2`` jet with
  a jittered amplitude and random planetary waves with an n^-1.5 slope),
  integrated as one batched state on the plain engine, as the JAX package
  integrates ensembles.
- **Boundary markers.** One all-NaN row between segments, so the samplers'
  NaN-window removal and the NaN-aware scaler statistics drop exactly the
  windows that span a restart.
- **Two-truth mode** (``truth_truncation``): the dynamics run at a higher
  truncation and each snapshot is band-limited to ``truncation`` on the
  archive grid, so a baseline core at ``truncation`` carries model error.
- **Unmodeled physics** (``zonal_relaxation_days``, ``wave_drag_days``):
  terms added to the model's tendency on the instance, which the plain
  engine's step calls; the fused kernel bakes the unforced tendency, so
  they refuse ``step_impl='kernel'``.

The snapshot loop writes into one preallocated (n_snap, K, H, W) tensor per
field on the model's device and copies it to the host once at the end.
Randomness is ``np.random.RandomState(seed + k)`` for segment k, drawn as
the JAX package draws it.
"""

from __future__ import annotations

import numpy as np
import torch

from dlwp_torch.device import resolve_device
from dlwp_torch.grid.latlon import GRAVITY, OMEGA, LatLonGrid
from dlwp_torch.spectral.transforms import SphericalHarmonics, to_numpy


class BarotropicArchiveSource:
    """DataSource serving a perturbed-restart barotropic HGT/VRT archive.

    Arguments as in the JAX package: ``n_samples`` rows (NaN markers
    included) on a regular ``nlat`` x ``nlon`` grid at ``truncation``,
    step ``dt`` [s], a snapshot every ``snapshot_hours``, segments of
    ``segment_days`` after ``spinup_days``, del-8 ``damping_coefficient``,
    waves of rms height ``wave_rms`` up to degree ``wave_n_max``, the
    ``superrotation_ms`` and ``jet_amp`` base state, ``form`` 'vrt' or
    'psi', ``seed``, the two-truth and unmodeled-physics options; the
    engine names are the port's (``step_impl`` 'plain' or 'kernel') and
    ``device`` (None -> ``cuda``) is where the archive is integrated.
    """

    def __init__(
        self,
        n_samples: int = 5888,
        nlat: int = 73,
        nlon: int = 144,
        truncation: int = 72,
        dt: float = 1800.0,
        snapshot_hours: int = 6,
        segment_days: int = 92,
        spinup_days: float = 2.0,
        damping_coefficient: float = 5e-6,
        wave_rms: float = 120.0,
        wave_n_max: int | None = None,
        superrotation_ms: float = 15.0,
        jet_amp: float = 120.0,
        form: str = "vrt",
        seed: int = 0,
        start: str = "2000-01-01",
        step_impl: str = "plain",
        dtype=np.float32,
        truth_truncation: int | None = None,
        truth_nlat: int | None = None,
        truth_nlon: int | None = None,
        zonal_relaxation_days: float = 0.0,
        relax_n: int = 20,
        wave_drag_days: float = 0.0,
        wave_drag_n_min: int = 15,
        device=None,
    ):
        self.nlat, self.nlon = int(nlat), int(nlon)
        self.truncation = int(truncation)
        self.dt = float(dt)
        self.snapshot_hours = int(snapshot_hours)
        self.segment_days = int(segment_days)
        self.spinup_days = float(spinup_days)
        self.damping_coefficient = float(damping_coefficient)
        self.wave_rms = float(wave_rms)
        self.superrotation_ms = float(superrotation_ms)
        self.jet_amp = float(jet_amp)
        # With a -1.5 slope, modes near a high truncation carry enough
        # vorticity to destabilize the integration: planetary and synoptic
        # scales only.
        self.wave_n_max = (int(wave_n_max) if wave_n_max is not None
                           else min(20, max(8, self.truncation // 2)))
        if form not in ("vrt", "psi"):
            raise ValueError("form must be 'vrt' or 'psi'")
        self.form = form
        self.seed = int(seed)
        self.step_impl = step_impl
        self.dtype = dtype
        self.device = resolve_device(device)
        self._n = int(n_samples)
        self.times = (
            np.datetime64(start)
            + np.arange(self._n) * np.timedelta64(self.snapshot_hours, "h")
        ).astype("datetime64[ns]")
        self.grid = LatLonGrid.regular(self.nlat, self.nlon)
        self.lat = np.asarray(self.grid.lat)
        self.lon = np.asarray(self.grid.lon)
        self.truth_truncation = (int(truth_truncation)
                                 if truth_truncation is not None else None)
        if self.truth_truncation is not None:
            if self.truth_truncation <= self.truncation:
                raise ValueError(
                    "truth_truncation must exceed the archive truncation")
            # Default truth grid: the next halving of the grid spacing.
            t_nlat = truth_nlat or (2 * (self.nlat - 1) + 1)
            t_nlon = truth_nlon or (2 * self.nlon)
            if (t_nlat - 1 < self.truth_truncation
                    or t_nlon // 2 < self.truth_truncation):
                raise ValueError(f"truth grid {t_nlat}x{t_nlon} cannot "
                                 f"support T{self.truth_truncation}")
            self._run_grid = LatLonGrid.regular(t_nlat, t_nlon)
            self._run_truncation = self.truth_truncation
        else:
            self._run_grid = self.grid
            self._run_truncation = self.truncation
        # Relaxation of the zonal-mean vorticity (m = 0, n <= relax_n)
        # toward a fixed jet, and a Rayleigh drag on the cascade band (all
        # m, n >= wave_drag_n_min): terms a plain core scored as a baseline
        # does not know.
        self.zonal_relaxation_days = float(zonal_relaxation_days)
        self.relax_n = int(relax_n)
        self.wave_drag_days = float(wave_drag_days)
        self.wave_drag_n_min = int(wave_drag_n_min)
        self._fields: dict[str, np.ndarray] | None = None

    # ------------------------------------------------------------ generation
    @property
    def per_segment(self) -> int:
        return self.segment_days * 24 // self.snapshot_hours

    @property
    def n_segments(self) -> int:
        # Each segment gives per_segment rows and one NaN marker row (none
        # after the last).
        per = self.per_segment + 1
        return max(1, -(-(self._n + 1) // per))

    def _solid_body(self) -> float:
        """z amplitude of an equatorial solid-body wind under the psi-form
        convention psi = g z / f0."""
        return self.superrotation_ms * 2 * OMEGA * self.grid.radius / GRAVITY

    def _initial_z(self) -> np.ndarray:
        """(K, H, W) float32 perturbed initial heights on the run grid: the
        superrotation, a ``sin^2`` jet of amplitude ``jet_amp`` x U(0.8,
        1.2) and random harmonics of degree 4..``wave_n_max`` (m >= 1) with
        an n^-1.5 amplitude slope, normalized to ``wave_rms``."""
        K, T = self.n_segments, self._run_truncation
        sh = SphericalHarmonics.build(self._run_grid, T, dtype=torch.float32,
                                      device=self.device)
        mask = to_numpy(sh.mask).astype(np.float64)
        m_idx = np.arange(T + 1)[:, None]
        n_idx = np.arange(T + 1)[None, :]
        band = (n_idx >= 4) & (n_idx <= self.wave_n_max) & (m_idx >= 1)
        amp = np.where(band, (1.0 + n_idx) ** -1.5, 0.0) * mask
        lat = np.radians(np.asarray(self._run_grid.lat))[:, None]
        a_sb = self._solid_body()
        zs = []
        for k in range(K):
            rng = np.random.RandomState(self.seed + k)
            jet = (5500.0 - a_sb * np.sin(lat)
                   - self.jet_amp * (0.8 + 0.4 * rng.rand()) * np.sin(lat) ** 2)
            coef = amp * (rng.randn(T + 1, T + 1)
                          + 1j * rng.randn(T + 1, T + 1))
            spec = torch.complex(
                torch.as_tensor(coef.real, dtype=torch.float32),
                torch.as_tensor(coef.imag, dtype=torch.float32))
            wave = to_numpy(sh.synthesize(spec.to(self.device)))
            rms = float(np.sqrt(np.mean(wave ** 2))) or 1.0
            zs.append(jet + wave * (self.wave_rms / rms))
        return np.stack(zs).astype(np.float32)

    def _model(self):
        """The generating model, with the unmodeled-physics terms added to
        its tendency on the instance."""
        from dlwp_torch.barotropic import BarotropicModel, BarotropicModelPsi

        cls = BarotropicModel if self.form == "vrt" else BarotropicModelPsi
        model = cls(self._run_grid, self._run_truncation, dt=self.dt,
                    damping_coefficient=self.damping_coefficient,
                    dtype=torch.float32, step_impl=self.step_impl,
                    device=self.device)
        forced = self.zonal_relaxation_days > 0 or self.wave_drag_days > 0
        if forced and self.step_impl == "kernel":
            raise ValueError(
                "unmodeled-physics terms require step_impl='plain' (the "
                "fused kernel bakes the unforced tendency)")
        T = self._run_truncation
        sh_mask = to_numpy(model.sh.mask)
        n_idx = np.arange(T + 1)[None, :]
        m_idx = np.arange(T + 1)[:, None]

        def tensor(a):
            return torch.as_tensor(a.astype(np.float32), device=self.device)

        if self.wave_drag_days > 0:
            tau_d = self.wave_drag_days * 86400.0
            band = (n_idx >= self.wave_drag_n_min) * np.ones((T + 1, 1))
            drag_mask = tensor(band.astype(np.float32) * sh_mask / tau_d)
            base_d = model._tendency

            def dragged_tendency(vrt_spec):
                return base_d(vrt_spec) - (vrt_spec * drag_mask).to(
                    vrt_spec.dtype)

            model._tendency = dragged_tendency
        if self.zonal_relaxation_days > 0:
            tau = self.zonal_relaxation_days * 86400.0
            relax = (m_idx == 0) & (n_idx >= 1) & (n_idx <= self.relax_n)
            relax_mask = tensor(relax.astype(np.float32) * sh_mask)
            lat = np.radians(np.asarray(self._run_grid.lat))[:, None]
            target_z = (5500.0 - self._solid_body() * np.sin(lat)
                        - self.jet_amp * np.sin(lat) ** 2) * np.ones(
                            (1, self._run_grid.nlon))
            target_spec = model.from_z(
                target_z.astype(np.float32)).vrt_spec * relax_mask
            base_r = model._tendency

            def forced_tendency(vrt_spec):
                relax_term = (target_spec - vrt_spec * relax_mask) / tau
                return base_r(vrt_spec) + relax_term.to(vrt_spec.dtype)

            model._tendency = forced_tendency
        return model

    @torch.no_grad()
    def _generate(self) -> dict[str, np.ndarray]:
        model = self._model()
        state = model.from_z(self._initial_z())
        spinup = int(round(self.spinup_days * 86400.0 / self.dt))
        if spinup:
            state = model.run(state, spinup)
        every = int(round(self.snapshot_hours * 3600.0 / self.dt))
        n_snap = self.per_segment

        if self.truth_truncation is not None:
            # Each truth-grid snapshot analysed at the archive truncation
            # and synthesized on the archive grid: only band-limited
            # archive-grid fields are kept.
            sh_a = SphericalHarmonics.build(self._run_grid, self.truncation,
                                            dtype=torch.float32,
                                            device=self.device)
            sh_s = SphericalHarmonics.build(self.grid, self.truncation,
                                            dtype=torch.float32,
                                            device=self.device)

            def coarsen(f):
                return sh_s.synthesize(sh_a.analyze(f))
        else:
            def coarsen(f):
                return f

        K, H, W = self.n_segments, self.nlat, self.nlon
        zs = torch.empty((n_snap, K, H, W), dtype=torch.float32,
                         device=self.device)
        vs = torch.empty_like(zs)
        for i in range(n_snap):
            state = model._advance(state, every)
            zs[i] = coarsen(model.z_grid(state))
            vs[i] = coarsen(model.vrt_grid(state))
        out = {}
        for name, arr in (("HGT", zs.cpu().numpy()), ("VRT", vs.cpu().numpy())):
            arr = arr.astype(self.dtype)
            rows = np.full((self._n, H, W), np.nan, dtype=self.dtype)
            pos = 0
            for k in range(K):
                if pos >= self._n:
                    break
                take = min(n_snap, self._n - pos)
                rows[pos:pos + take] = arr[:take, k]
                pos += take + 1  # skip one row: the NaN boundary marker
            out[name] = rows
        return out

    # -------------------------------------------------------------- protocol
    def field(self, variable: str, level) -> np.ndarray:
        if self._fields is None:
            self._fields = self._generate()
        try:
            return self._fields[variable]
        except KeyError:
            raise KeyError(
                f"BarotropicArchiveSource serves HGT/VRT, not {variable!r}"
            ) from None

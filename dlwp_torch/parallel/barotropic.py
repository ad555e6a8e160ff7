"""Domain-decomposed barotropic dynamical core (port of
``dlwp_tpu.parallel.barotropic``).

The vorticity-form step -- spectral synthesis of winds and vorticity, the
grid-space tendency products, the vector analysis, implicit damping and
the Robert-filtered leapfrog -- composed from the ``local_*`` stages of
:class:`~dlwp_torch.parallel.spectral.ShardedSphericalHarmonics`: the state
lives as m-band shards over the mesh's ``lat`` axis, each shard owning
(T+1) / n zonal wavenumbers and nlat / n grid rows, with the two
transposes of each transform between them. Where the lat axis spans
processes, each process steps its own shards, and the transposes are
``all_to_all`` across the processes.
"""

from __future__ import annotations

import torch

from dlwp_torch.barotropic.model import (
    BarotropicModel,
    BarotropicState,
    advance_time,
)
from dlwp_torch.parallel.spectral import ShardedSphericalHarmonics


class ShardedBarotropicModel(BarotropicModel):
    """Vorticity-form core with the step sharded over the ``lat`` mesh axis.

    The constructor and state semantics of :class:`BarotropicModel`, plus
    ``mesh=`` (a :class:`~dlwp_torch.parallel.mesh.Mesh`, whose entries may
    repeat one device); :meth:`run_sharded` and :meth:`step_sharded`
    integrate on m-band shards. The tendency is the single-device one up to
    summation order.
    """

    def __init__(self, *args, mesh, lat_axis_name: str = "lat", **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh
        self.axis = lat_axis_name
        self.ssh = ShardedSphericalHarmonics(self.sh, mesh, lat_axis_name)

    # ---------------------------------------------------------------- local
    def _local_tendency(self, vrt: list[torch.Tensor]) -> list[torch.Tensor]:
        """The tendency of m-band shards, through the stacked synthesis
        table (the single-device ``_tendency``'s algebra on each shard's m
        band)."""
        ssh, sh = self.ssh, self.sh
        J = self.grid.nlat
        stacked = []
        for l, v in zip(ssh.mine, vrt):
            e = ssh.engines[l]
            psi = (v * ssh.mslice(l, "inv_laplacian_eig")).to(sh.cdtype)
            modes = e._legendre_syn(
                ssh.mslice(l, "_syn_table", self._syn_table.to(e.device)),
                psi)
            n0_modes = e._legendre_syn(
                ssh.mslice(l, "P0", e.P[:, :, 0:1]), v[..., :, 0:1])
            im = (1j * ssh.m_vals(l)).to(sh.cdtype)[:, None]
            stacked.append(torch.stack([
                modes[..., :J] + n0_modes,  # vrt
                modes[..., J:2 * J],  # u
                im * modes[..., 2 * J:],  # v
            ]))
        grids = ssh.local_inv_fourier(ssh._transpose_to_grid(stacked))
        jp = ssh.j_per
        dudt, dvdt = [], []
        for l, g in zip(ssh.mine, grids):
            f_loc = self.f_grid[l * jp:(l + 1) * jp].to(g.device)
            abs_vrt = f_loc + g[0]
            dudt.append(-abs_vrt * g[2])
            dvdt.append(abs_vrt * g[1])
        return ssh.local_vrtdiv_from_uv(dudt, dvdt)[0]

    def _local_step(self, vrt, prev, step: int):
        """One Robert/leapfrog step of m-band shards: (new, filtered)."""
        r, dt = self.robert_coefficient, self.dt
        dzdt = self._local_tendency(vrt)
        new, filtered = [], []
        for l, cur, old, dz in zip(self.ssh.mine, vrt, prev, dzdt):
            damping = self.ssh.mslice(l, "damping", self.damping)
            dz = (dz - damping * old) / (1.0 + damping * dt)
            if step == 0:
                n = cur + dt * dz
                f = cur + r * (n - cur)
            else:
                c = cur + r * (old - 2.0 * cur)
                n = old + 2.0 * dt * dz
                f = c + r * n
            new.append(n)
            filtered.append(f)
        return new, filtered

    # ----------------------------------------------------------------- API
    @torch.no_grad()
    def run_sharded(self, state: BarotropicState,
                    n_steps: int) -> BarotropicState:
        """Integrate ``n_steps`` on m-band shards of the state; the result
        is joined on the state's device."""
        dev = state.vrt_spec.device
        vrt = self.ssh.split(state.vrt_spec)
        prev = self.ssh.split(state.vrt_spec_prev)
        for k in range(int(n_steps)):
            vrt, prev = self._local_step(vrt, prev, state.step + k)
        return BarotropicState(
            vrt_spec=self.ssh.join(vrt, dev),
            vrt_spec_prev=self.ssh.join(prev, dev),
            step=state.step + int(n_steps),
            t=advance_time(state.t, self.dt, int(n_steps)))

    def step_sharded(self, state: BarotropicState) -> BarotropicState:
        """One sharded step (``step_forward``'s counterpart)."""
        return self.run_sharded(state, 1)

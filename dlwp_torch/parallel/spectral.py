"""Sharded spherical-harmonic transforms (port of
``dlwp_tpu.parallel.spectral``).

Grid fields are sharded in latitude bands over the ``lat`` mesh axis and
spectral coefficients in zonal-wavenumber (m) bands over the same axis.
Between the two lies a transpose: each shard trades its (all m, local lat)
Fourier modes for (local m, all lat), contracts its m band against its
slice of the Legendre tables, and the inverse path mirrors it. The JAX
package does this with ``lax.all_to_all`` inside ``shard_map``; here one
program holds the list of shards (one per ``lat`` entry of the mesh, which
may repeat one device) and the transposes are explicit splits and joins of
that list, each block moved with ``.to(device)`` to the shard that takes
it. Folded engines (``fold=True``) run their Legendre stages through the
m-band slices of the packed tables.

Layout: nlat and T+1 must both divide by the ``lat`` axis size. Longitude
is never sharded. The ``local_*`` methods take and give shard lists; the
public methods take and give global tensors on the caller's device.

On a mesh whose ``lat`` axis spans processes (``Mesh.ranks``), a process
holds and computes only its own lat and m bands (``mine``, the lat
indices it owns; the shard lists hold those alone), and each transpose
trades the blocks bound for other processes in one
``dist.all_to_all_single`` (gloo on the CPU, NCCL on cards; complex
blocks travel as their real views), the moves within a process staying
as they are: the port of JAX's ``lax.all_to_all`` across hosts. The
public methods' join gives every process the global tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dlwp_torch.parallel.distributed import process_group, wire_device
from dlwp_torch.spectral.transforms import SphericalHarmonics


def split_dim(x: torch.Tensor, devices, dim: int) -> list[torch.Tensor]:
    """``x`` cut into ``len(devices)`` equal blocks along ``dim``, block l
    on ``devices[l]``."""
    return [b.to(d) for b, d in zip(torch.chunk(x, len(devices), dim=dim),
                                    devices)]


def join_dim(shards: list[torch.Tensor], device, dim: int) -> torch.Tensor:
    return torch.cat([s.to(device) for s in shards], dim=dim)


class ShardedSphericalHarmonics:
    """Spectral engine over the ``lat`` axis of a mesh.

    Grid shards: (..., nlat / n, nlon), latitude band l on lat entry l.
    Spectral shards: (..., (T+1) / n, T+1), m band l on lat entry l.
    The shard lists hold the bands of ``mine``, the lat entries this
    process owns (all of them on a one-process mesh), in order.
    Results equal the single-device engine's up to summation order.
    """

    def __init__(self, sh: SphericalHarmonics, mesh,
                 lat_axis_name: str = "lat"):
        self.sh = sh
        self.mesh = mesh
        self.axis = lat_axis_name
        n = mesh.shape[lat_axis_name]
        M, J = sh.truncation + 1, sh.grid.nlat
        if M % n or J % n:
            raise ValueError(
                f"T+1 ({M}) and nlat ({J}) must divide the "
                f"'{lat_axis_name}' axis size ({n})")
        self.n_shards = n
        self.m_per, self.j_per = M // n, J // n
        self.devices = [mesh.device_at(**{lat_axis_name: i})
                        for i in range(n)]
        # Across processes where the lat axis spans them; else this
        # process computes every band.
        self.across = mesh.spans_processes(lat_axis_name)
        self.owners = [mesh.owner(**{lat_axis_name: i}) if self.across
                       else mesh.process_index for i in range(n)]
        self.mine = [i for i in range(n)
                     if self.owners[i] == mesh.process_index]
        self.group = process_group(self.owners) if self.across else None
        engines = {}
        # lat index -> engine, for this process's entries
        self.engines = {l: engines.setdefault(str(self.devices[l]),
                                              sh.to(self.devices[l]))
                        for l in self.mine}
        self._slices: dict = {}

    # ------------------------------------------------------- m-band tables
    def mslice(self, l: int, name: str, table=None) -> torch.Tensor:
        """Shard ``l``'s m-band slice of the engine table ``name`` (or of
        ``table``, an [m, ...] tensor of the engine), on its device,
        cached."""
        key = (l, name)
        if key not in self._slices:
            t = getattr(self.engines[l], name) if table is None else table
            self._slices[key] = t[l * self.m_per:(l + 1) * self.m_per].to(
                self.devices[l])
        return self._slices[key]

    def _fold_args(self, l: int, name: str):
        """Shard ``l``'s m-band slice of a packed hemisphere-parity table
        and of the even-m selector."""
        key = (l, "fold", name)
        if key not in self._slices:
            Tsym, Tanti, p = self.engines[l].fold_tabs[name]
            lo, hi = l * self.m_per, (l + 1) * self.m_per
            self._slices[key] = ((Tsym[lo:hi], Tanti[lo:hi], p),
                                 self.engines[l].even_m[lo:hi])
        return self._slices[key]

    def m_vals(self, l: int) -> torch.Tensor:
        return self.mslice(l, "m_vals")

    # ----------------------------------------------------------- transposes
    def _trade(self, F: list[torch.Tensor], block) -> dict:
        """Every block a transpose needs: ``block(f, t, s)`` cuts source
        ``s``'s shard ``f`` for target ``t``. Returns ``{(t, s): block}``
        for each target t here and every source s, on t's device; the
        blocks between processes go in one ``all_to_all_single``."""
        got = {(t, s): block(f, t, s).to(self.devices[t])
               for t in self.mine for s, f in zip(self.mine, F)}
        if not self.across:
            return got
        like = block(F[0], self.mine[0], self.mine[0])
        peers = sorted(set(self.owners))
        wire = wire_device(like.device)

        def flat(t):
            t = torch.view_as_real(t) if t.is_complex() else t
            return t.reshape(-1).to(wire)

        send = [[block(f, t, s) for t in range(self.n_shards)
                 if self.owners[t] == r for s, f in zip(self.mine, F)]
                if r != self.mesh.process_index else [] for r in peers]
        ins = [flat(b) for blocks in send for b in blocks]
        size = flat(like).numel()
        keys = [[(t, s) for t in self.mine for s in range(self.n_shards)
                 if self.owners[s] == r]
                if r != self.mesh.process_index else [] for r in peers]
        out = torch.empty(size * sum(map(len, keys)), dtype=ins[0].dtype,
                          device=wire)
        dist.all_to_all_single(
            out, torch.cat(ins), [size * len(b) for b in send],
            [size * len(k) for k in keys], group=self.group)
        at = 0
        for key in (k for ks in keys for k in ks):
            b = out[at:at + size]
            at += size
            if like.is_complex():
                b = torch.view_as_complex(b.reshape(like.shape + (2,)))
            got[key] = b.reshape(like.shape).to(self.devices[key[0]])
        return got

    def _transpose_to_spec(self, F: list[torch.Tensor]) -> list[torch.Tensor]:
        """(.., m_all, j_local) shards -> (.., m_local, j_all) shards."""
        mp = self.m_per
        got = self._trade(F, lambda f, t, s: f[..., t * mp:(t + 1) * mp, :])
        return [torch.cat([got[(t, s)] for s in range(self.n_shards)],
                          dim=-1) for t in self.mine]

    def _transpose_to_grid(self, F: list[torch.Tensor]) -> list[torch.Tensor]:
        """(.., m_local, j_all) shards -> (.., m_all, j_local) shards."""
        jp = self.j_per
        got = self._trade(F, lambda f, t, s: f[..., t * jp:(t + 1) * jp])
        return [torch.cat([got[(t, s)] for s in range(self.n_shards)],
                          dim=-2) for t in self.mine]

    # ------------------------------------------------------ local building
    def local_fourier(self, x: list[torch.Tensor]) -> list[torch.Tensor]:
        """Grid shards -> (.., m_all, j_local) one-sided Fourier modes: the
        longitude stage is unsharded, so the engine's applies to any band."""
        return [self.engines[l]._fourier(s.to(self.engines[l].dtype))
                for l, s in zip(self.mine, x)]

    def local_inv_fourier(self, F: list[torch.Tensor]) -> list[torch.Tensor]:
        return [self.engines[l]._inv_fourier(f)
                for l, f in zip(self.mine, F)]

    def _syn(self, l: int, name: str, spec: torch.Tensor) -> torch.Tensor:
        """Shard ``l``'s m-band Legendre synthesis through table ``name``
        (dense or folded, as the engine is built)."""
        e = self.engines[l]
        if e.fold:
            tabs, em = self._fold_args(l, name)
            return e._legendre_syn_folded(name, spec, tabs=tabs, even_m=em)
        return e._legendre_syn(self.mslice(l, name), spec)

    def _ana(self, l: int, name: str, Fm: torch.Tensor) -> torch.Tensor:
        e = self.engines[l]
        if e.fold:
            tabs, em = self._fold_args(l, name)
            return e._legendre_ana_folded(name, Fm, tabs=tabs, even_m=em)
        return e._legendre_ana(self.mslice(l, name), Fm)

    def local_analyze(self, x: list[torch.Tensor]) -> list[torch.Tensor]:
        F = self._transpose_to_spec(self.local_fourier(x))
        return [self._ana(l, "A", f) for l, f in zip(self.mine, F)]

    def local_synthesize(self, spec: list[torch.Tensor]) -> list[torch.Tensor]:
        cd = self.sh.cdtype
        F = [self._syn(l, "P", s.to(cd)) for l, s in zip(self.mine, spec)]
        return self.local_inv_fourier(self._transpose_to_grid(F))

    def _im_over_a(self, l: int) -> torch.Tensor:
        return (1j * self.m_vals(l) / self.sh.grid.radius).to(
            self.sh.cdtype)[:, None]

    def local_uv_from_vrtdiv(self, vrt: list[torch.Tensor],
                             div: list[torch.Tensor]):
        a, cd = self.sh.grid.radius, self.sh.cdtype
        u_m, v_m = [], []
        for l, vs, ds in zip(self.mine, vrt, div):
            inv = self.mslice(l, "inv_laplacian_eig")
            psi, chi = (vs * inv).to(cd), (ds * inv).to(cd)
            im = self._im_over_a(l)
            u_m.append(-self._syn(l, "H", psi) / a + im * self._syn(l, "G", chi))
            v_m.append(im * self._syn(l, "G", psi) + self._syn(l, "H", chi) / a)
        return (self.local_inv_fourier(self._transpose_to_grid(u_m)),
                self.local_inv_fourier(self._transpose_to_grid(v_m)))

    def local_vrtdiv_from_uv(self, u: list[torch.Tensor],
                             v: list[torch.Tensor]):
        u_m = self._transpose_to_spec(self.local_fourier(u))
        v_m = self._transpose_to_spec(self.local_fourier(v))
        vrt, div = [], []
        for l, um, vm in zip(self.mine, u_m, v_m):
            psi = self._ana(l, "AuPsi", um) + 1j * self._ana(l, "AvPsi", vm)
            chi = 1j * self._ana(l, "AuChi", um) + self._ana(l, "AvChi", vm)
            lap = self.mslice(l, "laplacian_eig")
            vrt.append(psi * lap)
            div.append(chi * lap)
        return vrt, div

    # ----------------------------------------------------------- public API
    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """A global grid (..., nlat, nlon) or spectrum (..., m, n) cut into
        this process's shards (axis -2)."""
        blocks = torch.chunk(x, self.n_shards, dim=-2)
        return [blocks[l].to(self.devices[l]) for l in self.mine]

    def join(self, shards: list[torch.Tensor], device=None) -> torch.Tensor:
        """The global tensor of grid or spectral shards on ``device``
        (default: the first shard's); across processes every process
        sends its shards to the others (one broadcast a shard)."""
        device = device or shards[0].device
        if not self.across:
            return join_dim(shards, device, -2)
        like = shards[0]
        wire = wire_device(like.device)
        real = (lambda t: torch.view_as_real(t)) if like.is_complex() else (
            lambda t: t)
        mine = dict(zip(self.mine, shards))
        out = []
        for l in range(self.n_shards):
            buf = (real(mine[l]).to(wire).contiguous() if l in mine else
                   torch.empty(real(like).shape, dtype=real(like).dtype,
                               device=wire))
            dist.broadcast(buf, src=self.owners[l], group=self.group)
            out.append(torch.view_as_complex(buf) if like.is_complex()
                       else buf)
        return join_dim(out, device, -2)

    def analyze(self, field: torch.Tensor) -> torch.Tensor:
        return self.join(self.local_analyze(self.split(field)), field.device)

    def synthesize(self, spec: torch.Tensor) -> torch.Tensor:
        return self.join(self.local_synthesize(self.split(spec)), spec.device)

    def uv_from_vrtdiv(self, vrt: torch.Tensor, div: torch.Tensor):
        u, v = self.local_uv_from_vrtdiv(self.split(vrt), self.split(div))
        return self.join(u, vrt.device), self.join(v, vrt.device)

    def vrtdiv_from_uv(self, u: torch.Tensor, v: torch.Tensor):
        vrt, div = self.local_vrtdiv_from_uv(self.split(u), self.split(v))
        return self.join(vrt, u.device), self.join(div, u.device)

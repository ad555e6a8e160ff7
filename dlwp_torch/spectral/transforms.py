"""Spherical-harmonic transforms (port of ``dlwp_tpu.spectral.transforms``).

The tables are built on the host in float64 numpy exactly as the JAX package
builds them (same Legendre recurrences, same ``np.linalg.pinv`` with
``rcond=1e-12`` for the weighted-least-squares analysis operators), so they
are its tables bit for bit; they then become tensors in the engine's dtype on
an explicit device.

- Longitude direction: ``torch.fft.rfft``/``irfft`` (``fourier='fft'``) or
  precomputed real DFT matrices (``fourier='matmul'``).
- Latitude direction: dense associated-Legendre contractions ``[m, j, n]``
  as ``torch.einsum`` over stacked real and imaginary parts (the tables are
  real). The JAX package leaves these products to XLA; here they are plain
  library products.
- Vector transforms use the pole-regular tables G = P/cos(lat) and
  H = cos(lat) * dP/dmu, so winds are evaluated directly at pole rows.

Coefficient layout: dense complex ``[..., m, n]`` of shape (T+1, T+1) with
zeros for n < m; ``m`` is the one-sided (rfft) zonal wavenumber, ``n`` the
total degree.

``fold=True``, the hemisphere-parity fold: associated Legendre functions
satisfy P(m, n, -mu) = (-1)^(n+m) P(m, n, mu), so on an equatorially
symmetric grid each scalar and vector Legendre stage splits into a
latitude-symmetric and an antisymmetric half over half the rows and half
the degrees. The packed north-half tables are built on the host in float64
from the unfolded ones, after a guard that every table carries the declared
parity (:func:`fold_tables`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from dlwp_torch.device import resolve_device
from dlwp_torch.grid.latlon import LatLonGrid
from dlwp_torch.spectral.legendre import legendre_tables


def real_dtype(dtype) -> torch.dtype:
    """``dtype`` checked to be ``torch.float32`` or ``torch.float64``."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype!r}")
    return dtype


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def dft_weights(nlon: int, n_modes: int) -> tuple[np.ndarray, np.ndarray]:
    """The multiplicities of the one-sided modes in irfft's Hermitian-input
    convention, float64 (M,): ``c_re`` (1 for m = 0 and the Nyquist mode,
    else 2) on the real parts and ``c_im`` (0 there, else -2) on the
    imaginary parts; :func:`dft_tables` weights its inverse rows with
    them."""
    L, M = int(nlon), int(n_modes)
    if M > L // 2 + 1:
        # The FFT path fails loudly here (shape mismatch); the matmul
        # tables would silently alias m >= nlon//2+1 onto lower modes.
        raise ValueError(
            f"n_modes={M} exceeds the one-sided spectrum of nlon={L} "
            f"({L // 2 + 1} modes)"
        )
    c_re = np.full(M, 2.0)
    c_re[0] = 1.0
    c_im = np.full(M, -2.0)
    c_im[0] = 0.0
    if M - 1 == L // 2 and L % 2 == 0:
        c_re[M - 1] = 1.0
        c_im[M - 1] = 0.0
    return c_re, c_im


def dft_tables(nlon: int, n_modes: int) -> tuple[np.ndarray, np.ndarray]:
    """Real DFT matrices implementing rfft/irfft for one-sided modes.

    Returns ``(dft_fwd, dft_inv)`` float64:

    - ``dft_fwd`` (nlon, 2M) with columns ``[cos/L | -sin/L]``:
      ``field @ dft_fwd`` gives the stacked (Re, Im) one-sided modes of
      ``rfft(field)/L`` truncated to M modes.
    - ``dft_inv`` (2M, nlon) with multiplicity-weighted rows under
      irfft's Hermitian-input convention (imaginary parts of the m = 0
      and Nyquist modes are dropped, as irfft does, :func:`dft_weights`):
      ``stack([re, im]) . dft_inv`` reconstructs the grid.
    """
    c_re, c_im = dft_weights(nlon, n_modes)
    L, M = int(nlon), int(n_modes)
    m_vals = np.arange(M, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(np.arange(L), m_vals) / L  # (L, M)
    dft_fwd = np.concatenate([np.cos(ang) / L, -np.sin(ang) / L], axis=1)
    dft_inv = np.concatenate(
        [c_re[:, None] * np.cos(ang).T, c_im[:, None] * np.sin(ang).T],
        axis=0,
    )
    return dft_fwd, dft_inv


def _wls_inverse(S: np.ndarray, w: np.ndarray, mask_cols: np.ndarray) -> np.ndarray:
    """Weighted-least-squares left inverse of synthesis matrix S (J x N).

    Returns A (N x J) with A @ S = I on the masked (valid) columns wherever
    the sampled basis has full rank; rank-deficient directions fall back to
    the minimum-norm solution via the SVD pseudo-inverse. Invalid columns
    (n < m) produce zero rows.
    """
    Sm = S[:, mask_cols]
    sw = np.sqrt(w)[:, None]
    # A_valid = pinv(W^1/2 S) W^1/2: the minimum-norm WLS left inverse.
    A_valid = np.linalg.pinv(sw * Sm, rcond=1e-12) * np.sqrt(w)[None, :]
    A = np.zeros((S.shape[1], S.shape[0]))
    A[mask_cols, :] = A_valid
    return A


def host_tables(grid: LatLonGrid, T: int) -> dict[str, np.ndarray]:
    """Every table of the engine, float64 numpy, as the JAX package builds
    them (``SphericalHarmonics.build``, unfolded)."""
    tab = legendre_tables(T, grid.mu)
    J = grid.nlat
    N = M = T + 1
    w = grid.quad_weights.astype(np.float64)
    if grid.grid_type == "custom" or not np.any(w):
        # No quadrature rule: uniform weights for the WLS projection (still
        # an exact left inverse).
        w = np.full(J, 2.0 / J)

    a = grid.radius
    mask = tab.mask
    # Scalar analysis: per-m WLS inverse of P[m].
    A = np.zeros((M, N, J))
    for m in range(M):
        A[m] = _wls_inverse(tab.P[m], w, mask[m])

    # Vector analysis: per-m WLS inverse of the joint (u, v) synthesis
    #   u_m(j) = (1/a) [ -sum_n psi_n H[m,j,n] + i m sum_n chi_n G[m,j,n] ]
    #   v_m(j) = (1/a) [ i m sum_n psi_n G[m,j,n] + sum_n chi_n H[m,j,n] ]
    # whose blocks are real or purely imaginary: four real tables, the i
    # factors applied at run time.
    AuPsi = np.zeros((M, N, J))
    AvPsi = np.zeros((M, N, J))
    AuChi = np.zeros((M, N, J))
    AvChi = np.zeros((M, N, J))
    for m in range(M):
        valid = mask[m].copy()
        valid[0] = False  # n = 0 carries no wind
        nv = int(valid.sum())
        if nv == 0:
            continue
        Hm = tab.H[m][:, valid]
        Gm = tab.G[m][:, valid]
        Mm = np.zeros((2 * J, 2 * nv), dtype=np.complex128)
        Mm[:J, :nv] = -Hm / a
        Mm[:J, nv:] = 1j * m * Gm / a
        Mm[J:, :nv] = 1j * m * Gm / a
        Mm[J:, nv:] = Hm / a
        W2 = np.concatenate([w, w])
        sw2 = np.sqrt(W2)
        Ainv = np.linalg.pinv(sw2[:, None] * Mm, rcond=1e-12) * sw2[None, :]
        blk_pu = Ainv[:nv, :J]
        blk_pv = Ainv[:nv, J:]
        blk_cu = Ainv[nv:, :J]
        blk_cv = Ainv[nv:, J:]
        tol = 1e-8 * max(np.abs(Ainv).max(), 1e-300)
        assert np.abs(blk_pu.imag).max() < tol
        assert np.abs(blk_cv.imag).max() < tol
        assert np.abs(blk_pv.real).max() < tol
        assert np.abs(blk_cu.real).max() < tol
        AuPsi[m][valid, :] = blk_pu.real
        AvPsi[m][valid, :] = blk_pv.imag  # stored as x where block = i*x
        AuChi[m][valid, :] = blk_cu.imag
        AvChi[m][valid, :] = blk_cv.real

    n_tot = tab.n_total.astype(np.float64)
    lap = np.where(mask, -n_tot * (n_tot + 1.0) / a**2, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_lap = np.where(
            mask & (n_tot > 0), -(a**2) / (n_tot * (n_tot + 1.0)), 0.0
        )
    return {
        "P": tab.P, "A": A, "G": tab.G, "H": tab.H,
        "AuPsi": AuPsi, "AvPsi": AvPsi, "AuChi": AuChi, "AvChi": AvChi,
        "n_total": n_tot, "mask": mask.astype(np.float64),
        "m_vals": np.arange(M, dtype=np.float64),
        "laplacian_eig": lap, "inv_laplacian_eig": inv_lap,
    }


def check_parity(t: np.ndarray, p: int, j_axis: int, name: str) -> None:
    """Raise unless table ``t`` (``[m, j, n]`` with ``j_axis=1``, ``[m, n,
    j]`` with ``j_axis=2``) has hemisphere parity with offset ``p``: the
    entries with (n + m + p) even are latitude-symmetric, the others
    antisymmetric. The WLS inverses inherit it on symmetric grids and
    weights, since the least-squares problem decouples by parity."""
    M, N = t.shape[0], t.shape[2] if j_axis == 1 else t.shape[1]
    scale = np.abs(t).max() or 1.0
    flipped = np.flip(t, axis=j_axis)
    for m in range(0, M, max(1, M // 4)):
        for n in range(m, N):
            idx = (m, slice(None), n) if j_axis == 1 else (m, n)
            sgn = 1.0 if (n + m + p) % 2 == 0 else -1.0
            if not np.allclose(flipped[idx], sgn * t[idx],
                               atol=1e-10 * scale):
                raise ValueError(f"{name} lacks hemisphere parity (p={p}); "
                                 "fold=True is not valid on this grid")


def pack_syn(t: np.ndarray, p: int, h: int, K: int):
    """(M, J, N) synthesis table -> the north-half (M, h, K) pair (sym,
    anti): per m, the degrees n = 2k + (m + p) % 2 of the symmetric class
    and the others."""
    M, _, N = t.shape
    sym, anti = np.zeros((M, h, K)), np.zeros((M, h, K))
    for m in range(M):
        off = (m + p) % 2
        for k in range(K):
            if 2 * k + off < N:
                sym[m, :, k] = t[m, :h, 2 * k + off]
            if 2 * k + 1 - off < N:
                anti[m, :, k] = t[m, :h, 2 * k + 1 - off]
    return sym, anti


def pack_ana(t: np.ndarray, p: int, h: int, K: int):
    """(M, N, J) analysis table -> the north-half (M, K, h) pair (sym,
    anti), as :func:`pack_syn`."""
    M, N, _ = t.shape
    sym, anti = np.zeros((M, K, h)), np.zeros((M, K, h))
    for m in range(M):
        off = (m + p) % 2
        for k in range(K):
            if 2 * k + off < N:
                sym[m, k, :] = t[m, 2 * k + off, :h]
            if 2 * k + 1 - off < N:
                anti[m, k, :] = t[m, 2 * k + 1 - off, :h]
    return sym, anti


# The parity offset of each table: P and G are mu-even under (n + m)
# parity, H = cos * dP/dmu flips it; each analysis table inherits the
# parity of the synthesis block it inverts.
FOLD_SYN = (("P", 0), ("G", 0), ("H", 1))
FOLD_ANA = (("A", 0), ("AuPsi", 1), ("AvPsi", 0), ("AuChi", 0),
            ("AvChi", 1))


def fold_tables(grid: LatLonGrid, tabs: dict[str, np.ndarray]):
    """The packed hemisphere-parity tables ``{name: (sym, anti, p)}``
    (float64) of the unfolded host tables, after the parity guard."""
    mu = np.asarray(grid.mu, np.float64)
    if not np.allclose(mu, -mu[::-1], atol=1e-12):
        raise ValueError("fold=True requires an equatorially symmetric grid")
    N = tabs["P"].shape[2]
    h, K = (grid.nlat + 1) // 2, (N + 1) // 2
    out = {}
    for names, j_axis, pack in ((FOLD_SYN, 1, pack_syn),
                                (FOLD_ANA, 2, pack_ana)):
        for name, p in names:
            check_parity(tabs[name], p, j_axis, name)
            out[name] = (*pack(tabs[name], p, h, K), p)
    return out


class SphericalHarmonics:
    """Spectral transform engine for a fixed grid + triangular truncation.

    Create with :meth:`build`. The table attributes (``P``, ``A``, ``G``,
    ``H``, ``AuPsi``, ``AvPsi``, ``AuChi``, ``AvChi`` shaped ``[m, j, n]``
    or ``[m, n, j]``; ``n_total``, ``mask``, ``laplacian_eig``,
    ``inv_laplacian_eig`` shaped ``[m, n]``; ``m_vals``; ``dft_fwd``,
    ``dft_inv`` or ``None``) are tensors in ``dtype`` on ``device``.
    """

    TABLES = ("P", "A", "G", "H", "AuPsi", "AvPsi", "AuChi", "AvChi",
              "n_total", "mask", "m_vals", "laplacian_eig",
              "inv_laplacian_eig")

    def __init__(self, grid, truncation, dtype, fourier, device, tables,
                 fold_tabs=None):
        self.grid = grid
        self.truncation = int(truncation)
        self.dtype = dtype
        self.fourier = fourier
        self.device = device
        for name in self.TABLES + ("dft_fwd", "dft_inv"):
            setattr(self, name, tables.get(name))
        # Stacked tables of the fused contractions (gradients,
        # uv_from_vrtdiv, vrtdiv_from_uv), built once.
        self._GH = torch.cat([self.G, self.H], dim=1)  # (m, 2J, n)
        self._HG = torch.cat([self.H, self.G], dim=1)
        self._Au = torch.cat([self.AuPsi, self.AuChi], dim=1)  # (m, 2N, j)
        self._Av = torch.cat([self.AvPsi, self.AvChi], dim=1)
        self.fold = fold_tabs is not None
        self.fold_tabs = None if fold_tabs is None else {
            k: (torch.as_tensor(s, dtype=dtype, device=device),
                torch.as_tensor(a, dtype=dtype, device=device), p)
            for k, (s, a, p) in fold_tabs.items()}
        self.even_m = None if fold_tabs is None else torch.as_tensor(
            (np.arange(self.truncation + 1) % 2 == 0)[:, None], device=device)

    @classmethod
    def build(
        cls,
        grid: LatLonGrid,
        truncation: int | None = None,
        dtype=torch.float32,
        fourier: str = "fft",
        fold: bool = False,
        device=None,
    ) -> "SphericalHarmonics":
        """Build the tables on the host (float64) and move them to
        ``device`` (``None`` -> ``cuda``) in ``dtype``."""
        if fourier not in ("fft", "matmul"):
            raise ValueError("fourier must be 'fft' or 'matmul'")
        dtype = real_dtype(dtype)
        device = resolve_device(device)
        if truncation is None:
            truncation = grid.nlon // 3  # reference model.py:46 suggestion
        T = int(truncation)
        if T + 1 > grid.nlat:
            raise ValueError(
                f"truncation {T} needs at least {T + 1} latitudes, grid has {grid.nlat}"
            )
        if T > grid.nlon // 2:
            raise ValueError(
                f"truncation {T} exceeds the one-sided zonal spectrum of "
                f"nlon={grid.nlon} (max m = {grid.nlon // 2})"
            )
        tabs = host_tables(grid, T)
        if fourier == "matmul":
            tabs["dft_fwd"], tabs["dft_inv"] = dft_tables(grid.nlon, T + 1)
        folded = fold_tables(grid, tabs) if fold else None
        tensors = {k: torch.as_tensor(v, dtype=dtype, device=device)
                   for k, v in tabs.items()}
        return cls(grid, T, dtype, fourier, device, tensors, folded)

    def to(self, device) -> "SphericalHarmonics":
        """A copy whose tables live on ``device`` (the same engine when
        they already do): how the sharded engine gives each mesh device
        its own tables without building them again."""
        device = torch.device(device)
        if (device.type, device.index or 0) == (self.device.type,
                                                self.device.index or 0):
            return self
        out = copy.copy(self)
        out.device = device
        for name, val in vars(self).items():
            if isinstance(val, torch.Tensor):
                setattr(out, name, val.to(device))
        if self.fold:
            out.fold_tabs = {k: (s.to(device), a.to(device), p)
                             for k, (s, a, p) in self.fold_tabs.items()}
        return out

    # -------------------------------------------------------------- internals
    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64

    @property
    def nspec(self) -> int:
        """Packed coefficient count, pyspharm-compatible: (T+1)(T+2)/2."""
        T = self.truncation
        return (T + 1) * (T + 2) // 2

    def _fourier(self, field: torch.Tensor) -> torch.Tensor:
        """Real grid (..., J, nlon) -> one-sided Fourier modes (..., m, J)."""
        M = self.truncation + 1
        if self.fourier == "matmul":
            both = torch.einsum("...jl,lk->...kj", field, self.dft_fwd)
            return torch.complex(both[..., :M, :], both[..., M:, :])
        F = torch.fft.rfft(field, dim=-1) / self.grid.nlon
        return F[..., :M].transpose(-1, -2)  # (..., M, J)

    def _inv_fourier(self, Fm: torch.Tensor) -> torch.Tensor:
        """One-sided Fourier modes (..., m, J) -> real grid (..., J, nlon)."""
        if self.fourier == "matmul":
            stacked = torch.cat([Fm.real, Fm.imag], dim=-2).to(self.dtype)
            return torch.einsum("...kj,kl->...jl", stacked, self.dft_inv)
        F = Fm.transpose(-1, -2)  # (..., J, M)
        nfreq = self.grid.nlon // 2 + 1
        padded = F.new_zeros(F.shape[:-1] + (nfreq,))
        padded[..., : F.shape[-1]] = F
        return torch.fft.irfft(padded * self.grid.nlon, n=self.grid.nlon,
                               dim=-1)

    def _complex_contract(self, eq, table, x):
        """Real ``table`` against complex ``x``: the contraction splits
        exactly into one real contraction of the stacked (Re, Im) parts."""
        if not x.is_complex():
            return torch.einsum(eq, table, x)
        ri = torch.stack([x.real, x.imag]).to(self.dtype)
        lhs, out = eq.split("->")
        tab, arg = lhs.split(",")
        out = torch.einsum(f"{tab},z{arg}->z{out}", table, ri)
        return torch.complex(out[0], out[1])

    def _legendre_syn(self, table, spec):
        """(..., m, n) coeffs -> (..., m, j) Fourier modes via real table."""
        return self._complex_contract("mjn,...mn->...mj", table, spec)

    def _legendre_ana(self, table, Fm):
        """(..., m, j) Fourier modes -> (..., m, n) coeffs via real table."""
        return self._complex_contract("mnj,...mj->...mn", table, Fm)

    # ----------------------------------------------- hemisphere-parity fold
    def _fold_rows(self, x: torch.Tensor):
        """(..., J) latitude rows -> (sym, anti) half-row combinations; the
        equator row of odd J enters the symmetric part once and the
        antisymmetric part as zero."""
        J = self.grid.nlat
        h = (J + 1) // 2
        north = x[..., :h]
        tail = torch.flip(x[..., h:], dims=(-1,))
        if J % 2 == 1:
            tail = torch.nn.functional.pad(tail, (0, 1))
        return north + tail, north - tail

    def _unfold_rows(self, e: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """(sym, anti) half rows -> full (..., J) latitude rows."""
        J = self.grid.nlat
        h = (J + 1) // 2
        south = torch.flip((e - o)[..., :J - h], dims=(-1,))
        return torch.cat([e + o, south], dim=-1)

    def _sym_selector(self, p: int, even_m=None) -> torch.Tensor:
        """(M, 1) bool: does the symmetric class occupy the even-n slots?"""
        em = self.even_m if even_m is None else even_m
        return em if p == 0 else ~em

    def _legendre_syn_folded(self, name, spec, tabs=None, even_m=None):
        """Folded synthesis through packed table ``name``: (..., m, n)
        complex -> (..., m, J) complex modes. ``tabs`` / ``even_m``
        override the full-m entry with an m-band slice (the sharded
        engine's Legendre stage sees all J but only its wavenumbers)."""
        N = self.truncation + 1
        K = (N + 1) // 2
        Tsym, Tanti, p = self.fold_tabs[name] if tabs is None else tabs
        ri = torch.stack([spec.real, spec.imag]).to(self.dtype)
        xe = ri[..., 0::2]  # n even, width K
        xo = ri[..., 1::2]  # n odd, width N - K
        if xo.shape[-1] < K:
            xo = torch.nn.functional.pad(xo, (0, K - xo.shape[-1]))
        sel = self._sym_selector(p, even_m)
        xs = torch.where(sel, xe, xo)
        xa = torch.where(sel, xo, xe)
        e = torch.einsum("mjk,z...mk->z...mj", Tsym, xs)
        o = torch.einsum("mjk,z...mk->z...mj", Tanti, xa)
        out = self._unfold_rows(e, o)
        return torch.complex(out[0], out[1])

    def _legendre_ana_folded(self, name, Fm, tabs=None, even_m=None):
        """Folded analysis through packed table ``name``: (..., m, J)
        modes -> (..., m, n) complex; ``tabs`` / ``even_m`` as in
        :meth:`_legendre_syn_folded`."""
        N = self.truncation + 1
        K = (N + 1) // 2
        Tsym, Tanti, p = self.fold_tabs[name] if tabs is None else tabs
        ri = torch.stack([Fm.real, Fm.imag]).to(self.dtype)
        Fs, Fa = self._fold_rows(ri)
        xs = torch.einsum("mkj,z...mj->z...mk", Tsym, Fs)
        xa = torch.einsum("mkj,z...mj->z...mk", Tanti, Fa)
        # Interleave the parity classes back into dense n.
        sel = self._sym_selector(p, even_m)
        out = xs.new_zeros(xs.shape[:-1] + (N,))
        out[..., 0::2] = torch.where(sel, xs, xa)
        out[..., 1::2] = torch.where(sel, xa, xs)[..., :N - K]
        return torch.complex(out[0], out[1])

    def _im_over_a(self) -> torch.Tensor:
        return (1j * self.m_vals / self.grid.radius).to(self.cdtype)  # [m]

    # ------------------------------------------------------------- public API
    def analyze(self, field: torch.Tensor) -> torch.Tensor:
        """Grid (..., nlat, nlon) -> spectral (..., T+1, T+1) complex."""
        Fm = self._fourier(field.to(self.dtype))
        if self.fold:
            return self._legendre_ana_folded("A", Fm)
        return self._legendre_ana(self.A, Fm)

    def synthesize(self, spec: torch.Tensor) -> torch.Tensor:
        """Spectral (..., T+1, T+1) -> grid (..., nlat, nlon) real."""
        spec = spec.to(self.cdtype)
        if self.fold:
            return self._inv_fourier(self._legendre_syn_folded("P", spec))
        return self._inv_fourier(self._legendre_syn(self.P, spec))

    def laplacian_spec(self, spec):
        """Spectral Laplacian: multiply by -n(n+1)/a^2."""
        return spec * self.laplacian_eig

    def inverse_laplacian_spec(self, spec):
        """Spectral inverse Laplacian (n = 0 mode annihilated)."""
        return spec * self.inv_laplacian_eig

    def laplacian(self, field):
        """Grid-space spherical Laplacian diagnostic."""
        return self.synthesize(self.laplacian_spec(self.analyze(field)))

    def gradients(self, spec):
        """Zonal and meridional gradient grids of a spectral field:
        ((1/(a cos lat)) df/dlon, (1/a) df/dlat), pole-regular via G and H.
        """
        spec = spec.to(self.cdtype)
        a = self.grid.radius
        J = self.grid.nlat
        if self.fold:
            dx_m = self._im_over_a()[:, None] * self._legendre_syn_folded(
                "G", spec)
            dy_m = self._legendre_syn_folded("H", spec) / a
            return self._inv_fourier(dx_m), self._inv_fourier(dy_m)
        both = self._legendre_syn(self._GH, spec)
        dx_m = self._im_over_a()[:, None] * both[..., :J]
        dy_m = both[..., J:] / a
        return self._inv_fourier(dx_m), self._inv_fourier(dy_m)

    def uv_from_vrtdiv(self, vrt_spec, div_spec):
        """Grid winds (u, v) from spectral vorticity and divergence:
        u = k x grad(psi) + grad(chi), psi = inv_lap(vrt), chi = inv_lap(div).
        """
        psi = (vrt_spec * self.inv_laplacian_eig).to(self.cdtype)
        chi = (div_spec * self.inv_laplacian_eig).to(self.cdtype)
        a = self.grid.radius
        im = self._im_over_a()[:, None]
        J = self.grid.nlat
        if self.fold:
            both_H = self._legendre_syn_folded("H", torch.stack([psi, chi]))
            both_G = self._legendre_syn_folded("G", torch.stack([psi, chi]))
            u_m = -both_H[0] / a + im * both_G[1]
            v_m = im * both_G[0] + both_H[1] / a
            return self._inv_fourier(u_m), self._inv_fourier(v_m)
        both = self._legendre_syn(self._HG, torch.stack([psi, chi]))
        psi_H, psi_G = both[0][..., :J], both[0][..., J:]
        chi_H, chi_G = both[1][..., :J], both[1][..., J:]
        u_m = -psi_H / a + im * chi_G
        v_m = im * psi_G + chi_H / a
        return self._inv_fourier(u_m), self._inv_fourier(v_m)

    def vrtdiv_from_uv(self, u, v):
        """Spectral vorticity and divergence from grid winds, through the
        WLS inverse of the joint (u, v) synthesis."""
        u_m = self._fourier(u.to(self.dtype))
        v_m = self._fourier(v.to(self.dtype))
        if self.fold:
            psi = (self._legendre_ana_folded("AuPsi", u_m)
                   + 1j * self._legendre_ana_folded("AvPsi", v_m))
            chi = (1j * self._legendre_ana_folded("AuChi", u_m)
                   + self._legendre_ana_folded("AvChi", v_m))
            return psi * self.laplacian_eig, chi * self.laplacian_eig
        N = self.truncation + 1
        both_u = self._legendre_ana(self._Au, u_m)
        both_v = self._legendre_ana(self._Av, v_m)
        psi = both_u[..., :N] + 1j * both_v[..., :N]
        chi = 1j * both_u[..., N:] + both_v[..., N:]
        return psi * self.laplacian_eig, chi * self.laplacian_eig

    def mu_multiplier_operator(self, values_on_lat) -> torch.Tensor:
        """Spectral operator equal to synthesize -> multiply by a
        latitude-only field -> analyze: per m, ``A[m] @ diag(v) @ P[m]``,
        composed in float64 from the engine's tables. Returns an (M, N, N)
        real table; apply with :meth:`apply_mu_multiplier`."""
        v = np.asarray(values_on_lat, dtype=np.float64)
        P = to_numpy(self.P).astype(np.float64)
        A = to_numpy(self.A).astype(np.float64)
        op = np.einsum("mnj,j,mjk->mnk", A, v, P)
        return torch.as_tensor(op, dtype=self.dtype, device=self.device)

    def apply_mu_multiplier(self, op, spec):
        """Apply a mu_multiplier_operator table: (..., m, n) -> (..., m, n)."""
        return self._complex_contract("mnk,...mk->...mn", op,
                                      spec.to(self.cdtype))

    # ------------------------------------------------- pyspharm-compat extras
    @property
    def wavenumbers(self) -> tuple[np.ndarray, np.ndarray]:
        """Packed (m, n-m) index arrays in pyspharm's ``getspecindx`` order."""
        T = self.truncation
        ms, nmm = [], []
        for m in range(T + 1):
            for n in range(m, T + 1):
                ms.append(m)
                nmm.append(n - m)
        return np.array(ms), np.array(nmm)

    def pack(self, spec):
        """Dense (..., m, n) -> packed (..., nspec) pyspharm ordering."""
        idx_m, idx_nmm = self.wavenumbers
        return spec[..., idx_m, idx_m + idx_nmm]

    def unpack(self, packed):
        """Packed (..., nspec) -> dense (..., m, n)."""
        T = self.truncation
        idx_m, idx_nmm = self.wavenumbers
        dense = packed.new_zeros(packed.shape[:-1] + (T + 1, T + 1))
        dense[..., idx_m, idx_m + idx_nmm] = packed
        return dense

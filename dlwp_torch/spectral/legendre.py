"""Associated Legendre function tables for spherical-harmonic transforms.

Port of ``dlwp_tpu.spectral.legendre``: the same host-side float64 numpy
code, kept as the port's own copy, so the tables are the JAX package's bit for
bit. It precomputes the three latitude tables that turn every
spherical-harmonic operation into a batched matmul on device:

- ``P[m, j, n]``  = Pbar_n^m(mu_j)                (scalar synthesis/analysis)
- ``G[m, j, n]``  = Pbar_n^m(mu_j) / cos(lat_j)   (zonal-derivative / vector)
- ``H[m, j, n]``  = cos(lat_j) * d Pbar_n^m / dmu (meridional-derivative / vector)

``Pbar`` is fully normalized so that ``int_{-1}^{1} Pbar_n^m Pbar_{n'}^m dmu =
delta_{nn'}`` (no Condon-Shortley phase). G and H are the pole-regular
combinations used by vector spherical-harmonic synthesis: for m >= 1 both are
bounded at the poles (G ~ cos^{m-1}, H likewise), which is what lets the
engine evaluate winds and gradients on pole-inclusive regular grids without
the 1/cos(lat) blowup. G is only ever used multiplied by ``i*m`` so its m=0
plane is zeroed.

All recurrences are the standard stable ones:
  seed     Pbar_m^m   = sqrt((2m+1)/(2m)) * cos(lat) * Pbar_{m-1}^{m-1}
  upward   Pbar_n^m   = (mu * Pbar_{n-1}^m - eps_{n-1}^m Pbar_{n-2}^m)/eps_n^m
           eps_n^m    = sqrt((n^2 - m^2) / (4 n^2 - 1))
  deriv    (1-mu^2) dPbar_n^m/dmu = -n eps_{n+1}^m Pbar_{n+1}^m
                                    + (n+1) eps_n^m Pbar_{n-1}^m

These replace SPHEREPACK's internal alp/valp routines used by the reference
via pyspharm (``DLWP/barotropic/pyspharm_transforms.py:41``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _eps(n: np.ndarray | float, m: int) -> np.ndarray | float:
    return np.sqrt((np.asarray(n, dtype=np.float64) ** 2 - m**2) / (4.0 * np.asarray(n, dtype=np.float64) ** 2 - 1.0))


@dataclasses.dataclass(frozen=True)
class LegendreTables:
    """Dense Legendre tables, layout ``[m, lat, n]`` with zeros for n < m.

    Shapes are ``(T+1, nlat, T+1)`` (float64). ``n_total[m, n] = n`` and
    ``mask[m, n] = (n >= m)`` give per-coefficient degree/validity for
    building spectral operators (Laplacian, damping, ...).
    """

    truncation: int
    mu: np.ndarray  # (nlat,) sin(latitude)
    P: np.ndarray  # (M, J, N)
    G: np.ndarray  # (M, J, N), m=0 plane zeroed
    H: np.ndarray  # (M, J, N)
    n_total: np.ndarray  # (M, N) int
    mask: np.ndarray  # (M, N) bool, n >= m

    @property
    def nlat(self) -> int:
        return self.mu.shape[0]


def legendre_tables(truncation: int, mu: np.ndarray) -> LegendreTables:
    """Compute P/G/H tables at nodes ``mu`` (float64, host side).

    Args:
        truncation: triangular truncation T (modes n, m <= T retained).
        mu: (nlat,) array of sin(latitude) nodes in [-1, 1] (poles allowed).
    """
    T = int(truncation)
    mu = np.asarray(mu, dtype=np.float64)
    J = mu.shape[0]
    cos = np.sqrt(np.maximum(0.0, 1.0 - mu**2))  # cos(lat) >= 0

    M = N = T + 1
    # Internally compute degrees up to T+1 (needed for H via the derivative
    # recurrence), then crop.
    NN = T + 2
    P = np.zeros((M, J, NN))
    Gm = np.zeros((M, J, NN))  # P / cos(lat), valid for m >= 1

    # m = 0 plane of P: ordinary normalized Legendre polynomials.
    P[0, :, 0] = np.sqrt(0.5)
    if NN > 1:
        P[0, :, 1] = np.sqrt(1.5) * mu
    for n in range(2, NN):
        e_n = _eps(n, 0)
        e_nm1 = _eps(n - 1, 0)
        P[0, :, n] = (mu * P[0, :, n - 1] - e_nm1 * P[0, :, n - 2]) / e_n

    # m >= 1: seed G_m^m from P_{m-1}^{m-1}, then recurse upward in n for G,
    # and obtain P = cos * G (exactly zero at poles, as it should be).
    for m in range(1, M):
        seed = np.sqrt((2.0 * m + 1.0) / (2.0 * m))
        Gm[m, :, m] = seed * P[m - 1, :, m - 1]
        if m + 1 < NN:
            # First upward step: P_{m+1}^m = mu P_m^m / eps_{m+1}^m (the
            # three-term recurrence with the n-2 term absent).
            Gm[m, :, m + 1] = mu * Gm[m, :, m] / _eps(m + 1, m)
        for n in range(m + 2, NN):
            e_n = _eps(n, m)
            e_nm1 = _eps(n - 1, m)
            Gm[m, :, n] = (mu * Gm[m, :, n - 1] - e_nm1 * Gm[m, :, n - 2]) / e_n
        P[m] = cos[:, None] * Gm[m]

    # H = cos(lat) * dP/dmu.
    H = np.zeros((M, J, NN))
    # m = 0: dPbar_n/dmu by the polynomial derivative recurrence
    #   Pbar'_{n+1} = sqrt((2n+3)/(2n-1)) Pbar'_{n-1} + sqrt((2n+3)(2n+1)) Pbar_n
    dP0 = np.zeros((J, NN))
    dP0[:, 0] = 0.0
    if NN > 1:
        dP0[:, 1] = np.sqrt(1.5)
    for n in range(2, NN):
        k = n - 1  # recurrence index: P'_{k+1} from P'_{k-1} and P_k
        dP0[:, n] = (
            np.sqrt((2.0 * k + 3.0) / (2.0 * k - 1.0)) * dP0[:, n - 2]
            + np.sqrt((2.0 * k + 3.0) * (2.0 * k + 1.0)) * P[0, :, n - 1]
        )
    H[0] = cos[:, None] * dP0
    # m >= 1: H_n^m = -n eps_{n+1}^m G_{n+1}^m + (n+1) eps_n^m G_{n-1}^m
    # (the (1-mu^2) dP/dmu identity divided by cos; pole-regular).
    for m in range(1, M):
        for n in range(m, NN - 1):
            lower = eps_lower = 0.0
            if n - 1 >= m:
                eps_lower = _eps(n, m)
                lower = Gm[m, :, n - 1]
            H[m, :, n] = -n * _eps(n + 1, m) * Gm[m, :, n + 1] + (n + 1) * eps_lower * lower

    # Crop internal degree T+1 and zero the (unused) m = 0 plane of G.
    P = np.ascontiguousarray(P[:, :, :N])
    G = np.ascontiguousarray(Gm[:, :, :N])
    G[0] = 0.0
    H = np.ascontiguousarray(H[:, :, :N])

    n_total = np.broadcast_to(np.arange(N)[None, :], (M, N)).copy()
    mask = n_total >= np.arange(M)[:, None]
    P[:, :, :][~np.broadcast_to(mask[:, None, :], P.shape)] = 0.0
    G[~np.broadcast_to(mask[:, None, :], G.shape)] = 0.0
    H[~np.broadcast_to(mask[:, None, :], H.shape)] = 0.0

    return LegendreTables(
        truncation=T, mu=mu, P=P, G=G, H=H, n_total=n_total, mask=mask
    )

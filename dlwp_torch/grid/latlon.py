"""Global latitude/longitude grids and spherical quadrature.

Port of ``dlwp_tpu.grid.latlon``: the same host-side float64 numpy code, kept
as the port's own copy so that ``dlwp_torch`` imports nothing of the JAX
package. It replaces the grid handling that the reference delegates to
pyspharm (``DLWP/barotropic/pyspharm_transforms.py:112-127`` in the
reference): Gaussian latitudes/weights (``gaussian_lats_wts``) and regular
equiangular grids (``Spharmt(gridtype='regular')``).

Design notes:
- All grid metadata is computed once on the host in float64 numpy; device code
  only ever sees tensors made from these constant arrays.
- Regular (equiangular, pole-inclusive) grids use Clenshaw-Curtis quadrature:
  equally spaced latitudes are equally spaced colatitudes, so mu = sin(lat) =
  cos(theta) are exactly the Clenshaw-Curtis nodes, giving stable positive
  weights exact for polynomials in mu up to degree nlat-1.
- Gaussian grids use Gauss-Legendre nodes/weights (exact to degree 2*nlat-1),
  the classical choice for spectral dynamical cores.
"""

from __future__ import annotations

import dataclasses

import numpy as np

EARTH_RADIUS = 6_371_200.0  # metres, matches reference pyspharm_transforms.py:28
OMEGA = 7.29e-5  # rad/s, Earth's rotation rate as used by the reference model.py:84
GRAVITY = 9.81


def gaussian_latitudes(nlat: int) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian latitudes (degrees, north->south) and quadrature weights.

    The latitudes are the roots of the Legendre polynomial P_nlat(mu) with
    mu = sin(lat); weights are the Gauss-Legendre weights (sum to 2).
    """
    mu, w = np.polynomial.legendre.leggauss(nlat)
    lats = np.degrees(np.arcsin(mu))
    # north -> south ordering (matches CFS/ERA5 data layout)
    order = np.argsort(lats)[::-1]
    return lats[order], w[order]


def clenshaw_curtis_weights(n: int) -> np.ndarray:
    """Clenshaw-Curtis quadrature weights for nodes x_j = cos(j*pi/(n-1)).

    Exact for polynomials of degree <= n-1 on [-1, 1]; all weights positive.
    Computed via the cosine-moment system in closed form (DCT-I structure).
    """
    if n < 2:
        raise ValueError("need at least 2 nodes")
    m = n - 1
    theta = np.arange(n) * np.pi / m
    # Standard closed form:
    #   w_j = (c_j / m) * (1 - sum_{k=1}^{m//2} b_k cos(2 k theta_j)/(4k^2-1))
    # with b_k = 1 if 2k == m else 2, and c_j = 1 at the endpoints else 2.
    k = np.arange(1, m // 2 + 1)
    b = np.where(2 * k == m, 1.0, 2.0)
    series = (b / (4.0 * k**2 - 1.0))[None, :] * np.cos(
        2.0 * np.outer(theta, k)
    )
    w = (1.0 - series.sum(axis=1)) * (2.0 / m)
    w[0] /= 2.0
    w[-1] /= 2.0
    return w


@dataclasses.dataclass(frozen=True)
class LatLonGrid:
    """A global lat/lon grid with quadrature metadata.

    Attributes:
        lat: (nlat,) latitudes in degrees, strictly monotonic.
        lon: (nlon,) longitudes in degrees in [0, 360).
        quad_weights: (nlat,) quadrature weights in mu = sin(lat), summing to 2
            (only meaningful for 'regular' and 'gaussian' grid types).
        grid_type: 'regular' (equiangular, pole-inclusive), 'gaussian', or
            'custom' (e.g. pole-cropped data grids; no exact quadrature).
        radius: sphere radius in metres.
    """

    lat: np.ndarray
    lon: np.ndarray
    quad_weights: np.ndarray
    grid_type: str
    radius: float = EARTH_RADIUS

    @property
    def nlat(self) -> int:
        return self.lat.shape[0]

    @property
    def nlon(self) -> int:
        return self.lon.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nlat, self.nlon)

    @property
    def mu(self) -> np.ndarray:
        """sin(latitude) -- the Legendre-transform coordinate."""
        return np.sin(np.radians(self.lat))

    @property
    def coslat(self) -> np.ndarray:
        return np.cos(np.radians(self.lat))

    @property
    def coriolis(self) -> np.ndarray:
        """Coriolis parameter f = 2*Omega*sin(lat), shape (nlat,)."""
        return 2.0 * OMEGA * self.mu

    def cos_lat_weights(self, weighting: str = "cosine") -> np.ndarray:
        """Latitude loss weights (reference custom.py:899-991 semantics).

        'cosine':       cos(lat)
        'midlatitude':  cos(lat) + 0.5*sin(2*lat)^2  (boost mid-latitudes)
        """
        rad = np.radians(self.lat)
        w = np.cos(rad)
        if weighting == "midlatitude":
            w = w + 0.5 * np.sin(2.0 * rad) ** 2
        elif weighting != "cosine":
            raise ValueError("weighting must be 'cosine' or 'midlatitude'")
        return w

    @classmethod
    def regular(
        cls,
        nlat: int,
        nlon: int | None = None,
        radius: float = EARTH_RADIUS,
        descending: bool = True,
    ) -> "LatLonGrid":
        """Equiangular pole-inclusive grid, e.g. 73 x 144 for 2.5 degrees."""
        if nlon is None:
            nlon = 2 * (nlat - 1)
        lat = np.linspace(90.0, -90.0, nlat)
        if not descending:
            lat = lat[::-1].copy()
        lon = np.arange(nlon) * (360.0 / nlon)
        # Nodes mu = sin(lat) = cos(colat) are Clenshaw-Curtis nodes in colat.
        w = clenshaw_curtis_weights(nlat)
        return cls(lat=lat, lon=lon, quad_weights=w, grid_type="regular", radius=radius)

    @classmethod
    def gaussian(
        cls,
        nlat: int,
        nlon: int | None = None,
        radius: float = EARTH_RADIUS,
    ) -> "LatLonGrid":
        if nlon is None:
            nlon = 2 * nlat
        lat, w = gaussian_latitudes(nlat)
        lon = np.arange(nlon) * (360.0 / nlon)
        return cls(lat=lat, lon=lon, quad_weights=w, grid_type="gaussian", radius=radius)

    @classmethod
    def from_coords(
        cls, lat: np.ndarray, lon: np.ndarray, radius: float = EARTH_RADIUS
    ) -> "LatLonGrid":
        """Wrap explicit coordinate vectors (e.g. a pole-cropped data grid)."""
        lat = np.asarray(lat, dtype=np.float64)
        lon = np.asarray(lon, dtype=np.float64)
        w = np.zeros_like(lat)
        return cls(lat=lat, lon=lon, quad_weights=w, grid_type="custom", radius=radius)

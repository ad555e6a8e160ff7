"""Grid helpers (port of ``dlwp_tpu.grid``): lat/lon grids and quadrature,
solar insolation; beyond the JAX package, the cubed sphere of DLWP-CS
(:mod:`dlwp_torch.grid.cubed_sphere`)."""

from dlwp_torch.grid.insolation import (
    day_of_year,
    insolation,
    insolation_from_tables,
    insolation_tables,
)
from dlwp_torch.grid.latlon import (
    EARTH_RADIUS,
    GRAVITY,
    OMEGA,
    LatLonGrid,
    clenshaw_curtis_weights,
    gaussian_latitudes,
)

__all__ = [
    "EARTH_RADIUS",
    "GRAVITY",
    "LatLonGrid",
    "OMEGA",
    "clenshaw_curtis_weights",
    "day_of_year",
    "gaussian_latitudes",
    "insolation",
    "insolation_from_tables",
    "insolation_tables",
]

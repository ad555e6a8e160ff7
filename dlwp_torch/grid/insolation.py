"""Top-of-atmosphere solar insolation (port of ``dlwp_tpu.grid.insolation``).

The same first-order orbital model with fixed 1995 elements. Time is
fractional days since year start, leap days ignored. :func:`insolation`
and :func:`insolation_tables` run in numpy on the host;
:func:`insolation_from_tables` runs in PyTorch on the tensors' device, so
the rollout computes the forcing there from per-sample day scalars.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_OBLIQUITY = 23.4441 * np.pi / 180.0
_ECCENTRICITY = 0.016715
_PERIHELION_LON = 282.7 * np.pi / 180.0


def day_of_year(dates) -> np.ndarray:
    """Fractional day-of-year of datetime64-like inputs."""
    dates = np.asarray(dates, dtype="datetime64[s]")
    years = dates.astype("datetime64[Y]")
    return (dates - years).astype("timedelta64[s]").astype(np.float64) / 86400.0


def insolation(days, lat, lon, solar_constant: float = 1.0) -> np.ndarray:
    """(t, nlat, nlon) insolation (or (nlat, nlon) for scalar ``days``),
    clipped at zero; ``lat``/``lon`` in degrees, 1-D or 2-D."""
    days = np.asarray(days, dtype=np.float64)
    scalar_time = days.ndim == 0
    days = np.atleast_1d(days)
    lat = np.asarray(lat)
    lon = np.asarray(lon)
    if lat.ndim == 1:
        lon2, lat2 = np.meshgrid(lon, lat)
    else:
        lat2, lon2 = lat, lon
    beta = np.sqrt(1.0 - _ECCENTRICITY**2)
    lambda_m0 = _ECCENTRICITY * (1.0 + beta) * np.sin(_PERIHELION_LON)
    lambda_m = lambda_m0 + 2.0 * np.pi * (days - 80.5) / 365.0
    lam = lambda_m + 2.0 * _ECCENTRICITY * np.sin(lambda_m - _PERIHELION_LON)
    declination = np.arcsin(np.sin(_OBLIQUITY) * np.sin(lam))
    hour_angle = 2.0 * np.pi * (days[:, None, None] + lon2 / 360.0)
    rho = (1.0 - _ECCENTRICITY**2) / (
        1.0 + _ECCENTRICITY * np.cos(lam - _PERIHELION_LON)
    )
    lat_rad = np.radians(lat2)
    sol = (
        solar_constant
        * (
            np.sin(lat_rad)[None] * np.sin(declination)[:, None, None]
            - np.cos(lat_rad)[None]
            * np.cos(declination)[:, None, None]
            * np.cos(hour_angle)
        )
        * rho[:, None, None] ** -2
    )
    sol = np.maximum(sol, 0.0)
    return sol[0] if scalar_time else sol


def insolation_tables(lat, lon, dtype=np.float32) -> np.ndarray:
    """Static (3, nlat, nlon) basis fields for :func:`insolation_from_tables`:
    sin(lat), cos(lat)cos(lon), cos(lat)sin(lon)."""
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    if lat.ndim == 1:
        lon2, lat2 = np.meshgrid(lon, lat)
    else:
        lat2, lon2 = lat, lon
    lat_rad = np.radians(lat2)
    lon_phase = 2.0 * np.pi * lon2 / 360.0
    return np.stack([
        np.sin(lat_rad),
        np.cos(lat_rad) * np.cos(lon_phase),
        np.cos(lat_rad) * np.sin(lon_phase),
    ]).astype(dtype)


def insolation_from_tables(days: torch.Tensor, tables: torch.Tensor,
                           solar_constant: float = 1.0) -> torch.Tensor:
    """``(..., nlat, nlon)`` insolation for ``days`` of any shape, in the
    dtype of ``days``: O(days) scalars contracted with the three tables."""
    shape = days.shape
    d = days.reshape(-1)
    beta = math.sqrt(1.0 - _ECCENTRICITY**2)
    lambda_m0 = _ECCENTRICITY * (1.0 + beta) * math.sin(_PERIHELION_LON)
    lambda_m = lambda_m0 + 2.0 * math.pi * (d - 80.5) / 365.0
    lam = lambda_m + 2.0 * _ECCENTRICITY * torch.sin(lambda_m - _PERIHELION_LON)
    sin_decl = math.sin(_OBLIQUITY) * torch.sin(lam)
    cos_decl = torch.sqrt(1.0 - sin_decl**2)
    rho = (1.0 - _ECCENTRICITY**2) / (
        1.0 + _ECCENTRICITY * torch.cos(lam - _PERIHELION_LON)
    )
    r2 = solar_constant * rho**-2
    # Only the fractional day sets the diurnal phase; reducing first keeps
    # the fp32 argument reduction exact.
    phase = 2.0 * math.pi * (d - torch.floor(d))
    coeff = torch.stack([
        r2 * sin_decl,
        -r2 * cos_decl * torch.cos(phase),
        r2 * cos_decl * torch.sin(phase),
    ], dim=1)  # (D, 3)
    H, W = tables.shape[-2:]
    sol = coeff @ tables.to(coeff.dtype).reshape(3, H * W)
    return torch.clamp(sol, min=0.0).reshape(shape + (H, W))

"""Spherical-harmonic transforms (port of ``dlwp_tpu.spectral``)."""

from dlwp_torch.spectral.legendre import LegendreTables, legendre_tables
from dlwp_torch.spectral.transforms import SphericalHarmonics, dft_tables

__all__ = [
    "LegendreTables",
    "SphericalHarmonics",
    "dft_tables",
    "legendre_tables",
]

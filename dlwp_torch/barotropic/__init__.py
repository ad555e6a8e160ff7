"""Spectral barotropic dynamical cores (port of ``dlwp_tpu.barotropic``)."""

from dlwp_torch.barotropic.model import (
    BarotropicModel,
    BarotropicModelPsi,
    BarotropicState,
)

__all__ = ["BarotropicModel", "BarotropicModelPsi", "BarotropicState"]

"""Grid helpers (port of ``dlwp_tpu.grid``): solar insolation."""

from dlwp_torch.grid.insolation import (
    day_of_year,
    insolation,
    insolation_from_tables,
    insolation_tables,
)

__all__ = [
    "day_of_year",
    "insolation",
    "insolation_from_tables",
    "insolation_tables",
]

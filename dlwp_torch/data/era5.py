"""ERA5 reanalysis acquisition via the Copernicus CDS API (port of
``dlwp_tpu.data.era5``).

Capability surface of the reference's ``ERA5Reanalysis``
(``DLWP/data/era5.py:87-406``): per-(variable, level) retrieval requests to
the Climate Data Store, parallel submission, and an opened-dataset
DataSource for the Preprocessor. The ``cdsapi`` client and netCDF4 are
import-gated optional dependencies (absent in the build environment);
request construction and variable/level handling are unit-testable without
them.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

try:
    import cdsapi  # optional
except ImportError:
    cdsapi = None

try:
    import netCDF4  # optional
except ImportError:
    netCDF4 = None

try:
    import h5py
except ImportError:
    h5py = None

# Long -> short variable name map (reference era5.py:63-80 capability).
VARIABLE_NAMES = {
    "geopotential": "z",
    "temperature": "t",
    "u_component_of_wind": "u",
    "v_component_of_wind": "v",
    "vertical_velocity": "w",
    "specific_humidity": "q",
    "relative_humidity": "r",
    "vorticity": "vo",
    "divergence": "d",
    "2m_temperature": "t2m",
    "total_column_water_vapour": "tcwv",
    "mean_sea_level_pressure": "msl",
}

# The 37 pressure levels of the ERA5 archive (reference era5.py:111-112).
PRESSURE_LEVELS = [
    1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 125, 150, 175, 200, 225, 250,
    300, 350, 400, 450, 500, 550, 600, 650, 700, 750, 775, 800, 825, 850,
    875, 900, 925, 950, 975, 1000,
]


class ERA5Reanalysis:
    """ERA5 acquisition + DataSource."""

    def __init__(self, root_directory: str | None = None, file_id: str = ""):
        self.root_directory = root_directory or os.path.join(
            os.path.expanduser("~"), ".era5"
        )
        os.makedirs(self.root_directory, exist_ok=True)
        self.file_id = file_id
        self.dataset_variables: list[str] = []
        self.dataset_levels: list[int] = []
        self.dataset_dates = None
        self._opened: dict | None = None
        self._times = self._lat = self._lon = None

    # ----------------------------------------------------------- selection
    def set_variables(self, variables) -> None:
        for v in variables:
            if v not in VARIABLE_NAMES and v not in VARIABLE_NAMES.values():
                raise ValueError(f"unknown ERA5 variable {v!r}")
        self.dataset_variables = list(variables)

    def set_levels(self, levels) -> None:
        for l in levels:
            if l not in PRESSURE_LEVELS:
                raise ValueError(
                    f"level {l} not an ERA5 pressure level"
                )
        self.dataset_levels = list(levels)

    def file_path(self, variable: str, level: int | None) -> str:
        short = VARIABLE_NAMES.get(variable, variable)
        lev = f"_{level}" if level else ""
        return os.path.join(
            self.root_directory, f"era5_{short}{lev}{self.file_id}.nc"
        )

    def build_request(
        self, variable: str, level: int | None, dates, request_kwargs=None
    ) -> dict:
        """One CDS request per (variable, level) (reference era5.py:287-303),
        e.g. with ``request_kwargs={'grid': [2.0, 2.0]}``."""
        years = sorted({d.year for d in dates})
        req = {
            "product_type": "reanalysis",
            "format": "netcdf",
            "variable": variable,
            "year": [str(y) for y in years],
            "month": [f"{m:02d}" for m in range(1, 13)],
            "day": [f"{d:02d}" for d in range(1, 32)],
            "time": [f"{h:02d}:00" for h in range(0, 24, 6)],
        }
        if level:
            req["pressure_level"] = str(level)
        req.update(request_kwargs or {})
        return req

    def retrieve(self, variables=None, levels=None, dates=None, n_proc: int = 4,
                 request_kwargs: dict | None = None, verbose: bool = False):
        """Submit parallel CDS requests (reference era5.py:210-323)."""
        if cdsapi is None:
            raise RuntimeError(
                "cdsapi is required for ERA5 retrieval; install it and "
                "configure ~/.cdsapirc"
            )
        variables = variables or self.dataset_variables
        levels = levels or self.dataset_levels or [None]
        self.dataset_dates = dates

        def submit(pair):
            variable, level = pair
            target = self.file_path(variable, level)
            if os.path.exists(target):
                return
            dataset = (
                "reanalysis-era5-pressure-levels"
                if level
                else "reanalysis-era5-single-levels"
            )
            try:
                c = cdsapi.Client()
                c.retrieve(
                    dataset,
                    self.build_request(variable, level, dates, request_kwargs),
                    target,
                )
            except Exception as e:
                warnings.warn(f"ERA5 request failed for {pair}: {e}")

        pairs = [(v, l) for v in variables for l in levels]
        with ThreadPoolExecutor(max_workers=max(1, n_proc)) as pool:
            list(pool.map(submit, pairs))

    # ----------------------------------------------------- DataSource API
    def open(self, variables=None, levels=None):
        """Open retrieved netCDF files into memory (reference era5.py:344)."""
        if netCDF4 is None:
            raise RuntimeError("netCDF4 is required to open ERA5 files")
        variables = variables or self.dataset_variables
        levels = levels or self.dataset_levels or [None]
        opened: dict[tuple, np.ndarray] = {}
        for v in variables:
            short = VARIABLE_NAMES.get(v, v)
            for l in levels:
                with netCDF4.Dataset(self.file_path(v, l)) as nc:
                    self._lat = nc.variables["latitude"][:]
                    self._lon = nc.variables["longitude"][:]
                    t = nc.variables["time"]
                    self._times = netCDF4.num2date(t[:], t.units)
                    opened[(v, l)] = np.asarray(nc.variables[short][:])
        self._opened = opened
        return self

    @property
    def times(self):
        if self._times is None:
            raise RuntimeError("call open() first")
        return np.asarray(self._times, dtype="datetime64[ns]")

    @property
    def lat(self):
        return np.asarray(self._lat)

    @property
    def lon(self):
        return np.asarray(self._lon)

    def field(self, variable: str, level) -> np.ndarray:
        if self._opened is None:
            raise RuntimeError("call open() first")
        key = (variable, None if level in (None, 0, "") else level)
        return self._opened[key]

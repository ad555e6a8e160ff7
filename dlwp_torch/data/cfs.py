"""CFS Reanalysis / Reforecast acquisition (port of ``dlwp_tpu.data.cfs``).

Host-side data acquisition with the capability surface of the reference's
``DLWP/data/cfsr.py`` (``CFSReanalysis``, cfsr.py:86-662;
``CFSReforecast``, cfsr.py:669-1191): download 6-hourly pressure-level
GRIB2 from the NCDC NOMADS archive, decode to monthly files, and expose the
opened archive through the :class:`~dlwp_torch.data.preprocessing.DataSource`
protocol so the Preprocessor can consume it directly.

Differences from the reference, by design:
- decoded monthly files are HDF5 (this environment has no netCDF4); one
  file per month with dims (time, level, lat, lon) per variable;
- downloads use a thread pool (I/O bound) instead of a process pool;
- GRIB decoding requires ``pygrib`` (optional dependency, import-gated) --
  the variable identification table is built from GRIB message shortName/
  level metadata rather than a parameter-number CSV.

Network access and pygrib are unavailable in the build environment, so the
date/URL/file-management logic is unit-tested directly and the transfer
path (fetch, one retry, idempotency skip, atomic completion) is exercised
end-to-end against a local HTTP fixture server
(tests/test_torch_port_acquisition.py::TestRetrieveHTTP).
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timedelta
from urllib.request import urlopen

import numpy as np

try:
    import pygrib  # optional
except ImportError:
    pygrib = None

try:
    import h5py
except ImportError:
    h5py = None

DATA_START = datetime(1979, 1, 1)
DATA_END = datetime(2011, 3, 31)


def fetch_with_retry(url: str, local: str) -> bool:
    """Download ``url`` to ``local``; skip if already present, retry once
    on failure, then warn and move on (reference cfsr.py:284-296 semantics).

    The download is atomic: bytes stream to ``local + '.part'`` and are
    renamed into place only on success, so an interrupted transfer can
    never leave a truncated file that a later idempotency check
    (``getsize > 0``) would mistake for a completed one. Returns True if
    the file is present afterwards.
    """
    if os.path.exists(local) and os.path.getsize(local) > 0:
        return True
    part = local + ".part"
    for attempt in (1, 2):
        try:
            with urlopen(url) as r, open(part, "wb") as f:
                f.write(r.read())
            os.replace(part, local)
            return True
        except Exception as e:
            if attempt == 2:
                warnings.warn(f"failed to download {url}: {e}")
        finally:
            if os.path.exists(part):
                try:
                    os.remove(part)
                except OSError:
                    pass
    return False


_GRIB_DIR_FMT = "%Y/%Y%m/%Y%m%d"
_GRIB_FILE_FMT = "pgb{res}{run}.gdas.%Y%m%d%H.grb2"

# Default variable short names (pygrib conventions) mirroring the commonly
# used subset of the reference's 97-row parameter table (cfsr.py:75).
DEFAULT_VARIABLES = ["gh", "t", "u", "v", "w", "q", "r", "absv"]
# Human-readable aliases (reference variable naming, e.g. HGT for height).
VARIABLE_ALIASES = {
    "HGT": "gh",
    "TMP": "t",
    "UGRD": "u",
    "VGRD": "v",
    "VVEL": "w",
    "SPFH": "q",
    "RH": "r",
    "ABSV": "absv",
}

LEVEL_COORD = (
    [1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 125, 150, 175, 200, 225, 250,
     300, 350, 400, 450, 500, 550, 600, 650, 700, 750]
    + list(range(775, 1001, 25))
)


def six_hourly_dates(start, end) -> list[datetime]:
    """All 6-hourly analysis times in [start, end] (the reference's
    fill_hourly expansion, cfsr.py:180-185)."""
    out = []
    t = datetime(start.year, start.month, start.day)
    while t <= end:
        out.append(t)
        t += timedelta(hours=6)
    return out


class CFSReanalysis:
    """CFS Reanalysis acquisition + DataSource for the Preprocessor."""

    def __init__(
        self,
        root_directory: str | None = None,
        resolution: str = "l",
        run_type: str = "06",
        fill_hourly: bool = True,
        file_id: str = "",
    ):
        self.raw_files: list[str] = []
        self.dataset_dates: list[datetime] = []
        self.root_directory = root_directory or os.path.join(
            os.path.expanduser("~"), ".cfsr"
        )
        if resolution == "h":
            self.ny, self.nx = 361, 720
            self._root_url = "https://nomads.ncdc.noaa.gov/modeldata/cmd_pgbh"
        elif resolution == "l":
            self.ny, self.nx = 73, 144
            self._root_url = "https://nomads.ncdc.noaa.gov/modeldata/cmd_grblow"
        else:
            raise ValueError("resolution must be 'h' or 'l'")
        if run_type not in ["01", "02", "03", "04", "05", "06", "nl"]:
            raise ValueError("run_type must be 'nl' or '01'..'06'")
        self.resolution = resolution
        self.run_type = run_type
        self.fill_hourly = fill_hourly
        self.file_id = file_id
        self.level_coord = list(LEVEL_COORD)
        self._opened: dict[str, np.ndarray] | None = None
        self._times: np.ndarray | None = None
        self._lat: np.ndarray | None = None
        self._lon: np.ndarray | None = None

    # ------------------------------------------------------------ date mgmt
    def set_dates(self, dates) -> None:
        dates = sorted(dates)
        if self.fill_hourly:
            self.dataset_dates = six_hourly_dates(dates[0], dates[-1])
        else:
            self.dataset_dates = list(dates)

    def grib_path(self, dt: datetime) -> str:
        name = dt.strftime(_GRIB_FILE_FMT).format(
            res=self.resolution, run=self.run_type
        )
        return f"{dt.strftime(_GRIB_DIR_FMT)}/{name}"

    def grib_url(self, dt: datetime) -> str:
        return f"{self._root_url}/{self.grib_path(dt)}"

    # ------------------------------------------------------------- retrieve
    def retrieve(self, dates="all", n_proc: int = 4, verbose: bool = False):
        """Download GRIB files (reference cfsr.py:215-272); idempotent, one
        retry per file, parallel over a thread pool."""
        if dates != "all":
            self.set_dates(dates)
        self.raw_files = []
        for dt in self.dataset_dates:
            if dt < DATA_START or dt > DATA_END:
                warnings.warn(f"date {dt} outside valid range; skipping")
                continue
            rel = self.grib_path(dt)
            local = os.path.join(self.root_directory, rel)
            os.makedirs(os.path.dirname(local), exist_ok=True)
            self.raw_files.append(rel)

        def fetch(rel):
            fetch_with_retry(
                f"{self._root_url}/{rel}",
                os.path.join(self.root_directory, rel),
            )

        workers = max(1, n_proc) if n_proc else os.cpu_count()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(fetch, self.raw_files))

    # ---------------------------------------------------------------- write
    def monthly_file(self, year: int, month: int) -> str:
        return os.path.join(
            self.root_directory,
            f"cfsr_{self.resolution}_{year}{month:02d}{self.file_id}.h5",
        )

    def write(self, variables="all", levels="all", n_proc: int = 2,
              verbose: bool = False, delete_raw_files: bool = False):
        """Decode retrieved GRIBs into monthly HDF5 files
        (reference cfsr.py:298-563)."""
        if pygrib is None:
            raise RuntimeError(
                "pygrib is required to decode GRIB2 files; install it or use "
                "pre-decoded monthly files"
            )
        if h5py is None:
            raise RuntimeError("h5py is required to write monthly files")
        if variables == "all":
            variables = list(DEFAULT_VARIABLES)
        variables = [VARIABLE_ALIASES.get(v, v) for v in variables]
        if levels == "all":
            levels = list(self.level_coord)
        months: dict[tuple[int, int], list[datetime]] = {}
        for dt in self.dataset_dates:
            months.setdefault((dt.year, dt.month), []).append(dt)
        for (year, month), dts in sorted(months.items()):
            self._process_month(year, month, dts, variables, levels, verbose)
            if delete_raw_files:
                for dt in dts:
                    p = os.path.join(self.root_directory, self.grib_path(dt))
                    if os.path.exists(p):
                        os.remove(p)

    def _process_month(self, year, month, dts, variables, levels, verbose):
        path = self.monthly_file(year, month)
        nt, nl = len(dts), len(levels)
        data = {
            v: np.full((nt, nl, self.ny, self.nx), np.nan, np.float32)
            for v in variables
        }
        lat = lon = None
        for i, dt in enumerate(sorted(dts)):
            local = os.path.join(self.root_directory, self.grib_path(dt))
            if not os.path.exists(local):
                warnings.warn(f"missing GRIB {local}; skipping")
                continue
            # Authoritative identification by the GRIB2 numeric triple
            # (discipline, parameterCategory, parameterNumber) from the NCEP
            # code tables (reference matches the same triple via its csv
            # table, cfsr.py:455-459); shortName is only a fallback for
            # parameters missing from the registry.
            from dlwp_torch.data.grib_params import lookup

            codes = {}
            for v in data:
                p = lookup(v)
                if p is not None and p.level_kind == "pl":
                    codes[(p.discipline, p.category, p.number)] = v
            grbs = pygrib.open(local)
            for msg in grbs:
                try:
                    lev = msg.level
                    if msg.typeOfLevel != "isobaricInhPa":
                        continue
                    triple = (
                        int(msg.discipline),
                        int(msg.parameterCategory),
                        int(msg.parameterNumber),
                    )
                    v = codes.get(triple)
                    if v is None and msg.shortName in data:
                        v = msg.shortName  # fallback: decoder metadata
                except Exception:
                    continue
                if v is not None and lev in levels:
                    j = levels.index(lev)
                    data[v][i, j] = msg.values
                    if lat is None:
                        la, lo = msg.latlons()
                        lat, lon = la[:, 0], lo[0, :]
            grbs.close()
            if verbose:
                print(f"processed {local}")
        with h5py.File(path, "w") as f:
            f.create_dataset(
                "time",
                data=np.array(sorted(dts), dtype="datetime64[ns]").astype(np.int64),
            )
            f.create_dataset("level", data=np.asarray(levels))
            f.create_dataset("lat", data=lat if lat is not None else np.zeros(self.ny))
            f.create_dataset("lon", data=lon if lon is not None else np.zeros(self.nx))
            for v, arr in data.items():
                f.create_dataset(v, data=arr)

    # ----------------------------------------------------- DataSource API
    def open(self, years_months: list[tuple[int, int]] | None = None):
        """Open monthly files into memory, concatenated along time
        (reference cfsr.py:565-586)."""
        if h5py is None:
            raise RuntimeError("h5py is required")
        if years_months is None:
            months = sorted(
                {(d.year, d.month) for d in self.dataset_dates}
            )
        else:
            months = sorted(years_months)
        arrays: dict[str, list] = {}
        times = []
        for year, month in months:
            path = self.monthly_file(year, month)
            with h5py.File(path, "r") as f:
                times.append(f["time"][:].astype("datetime64[ns]"))
                self._lat = f["lat"][:]
                self._lon = f["lon"][:]
                self._levels = f["level"][:]
                for k in f:
                    if k in ("time", "level", "lat", "lon"):
                        continue
                    arrays.setdefault(k, []).append(f[k][:])
        self._times = np.concatenate(times)
        self._opened = {k: np.concatenate(v) for k, v in arrays.items()}
        return self

    @property
    def times(self) -> np.ndarray:
        if self._times is None:
            raise RuntimeError("call open() first")
        return self._times

    @property
    def lat(self) -> np.ndarray:
        return self._lat

    @property
    def lon(self) -> np.ndarray:
        return self._lon

    def field(self, variable: str, level) -> np.ndarray:
        """(time, lat, lon) array for one variable/level (DataSource)."""
        if self._opened is None:
            raise RuntimeError("call open() first")
        v = VARIABLE_ALIASES.get(variable, variable)
        arr = self._opened[v]
        if level in (None, 0, ""):
            return arr[:, 0]
        j = list(self._levels).index(level)
        return arr[:, j]

    def plot(self, variable: str, level, time_index: int = 0, **kwargs):
        """Quick-look map of one field (reference cfsr.py:612-662
        generate_basemap/plot capability, on plain matplotlib)."""
        from dlwp_torch.plot import plot_global_map

        field = self.field(variable, level)[time_index]
        title = kwargs.pop(
            "title", f"{variable}/{level} @ {self.times[time_index]}"
        )
        return plot_global_map(
            self.lat, self.lon, field, title=title, **kwargs
        )

    def closest_lat_lon(self, lat: float, lon: float):
        """Nearest grid index (reference cfsr.py:196-213)."""
        if lon < 0:
            lon += 360.0
        la, lo = np.meshgrid(self._lat, self._lon, indexing="ij")
        dist = (la - lat) ** 2 + (lo - lon) ** 2
        if dist.min() > (2.5 if self.resolution == "l" else 1.0):
            raise ValueError("no grid point near requested lat/lon")
        return np.unravel_index(np.argmin(dist), dist.shape)


# --------------------------------------------------------------------------
# CFS Reforecast (forecast-skill comparison data)
# --------------------------------------------------------------------------

REFORECAST_START = datetime(1982, 1, 1)
REFORECAST_END = datetime(2011, 3, 31)
REFORECAST_VARIABLES = [
    "chi200", "dswsfc", "lhtfl", "prate", "tmp2m", "tmpsfc", "ulwtoa",
    "wind200", "wind850", "z500", "z700", "z1000",
]


class CFSReforecast:
    """CFS Reforecast acquisition (reference ``CFSReforecast``,
    cfsr.py:669-1191): the 45-day / 4-month hindcast time series on a
    1-degree grid, used as a forecast-skill baseline
    (examples/validate.py:278-301). Output files hold
    (f_hour, time, lat, lon) per variable.
    """

    def __init__(self, root_directory: str | None = None,
                 fill_hourly: bool = True, file_id: str = ""):
        self.root_directory = root_directory or os.path.join(
            os.path.expanduser("~"), ".cfsr"
        )
        self._root_url = "https://nomads.ncdc.noaa.gov/data/cfsr-rfl-ts45"
        self.nx, self.ny = 360, 181
        self.dt_hours = 6
        self.variables = list(REFORECAST_VARIABLES)
        self.fill_hourly = fill_hourly
        self.file_id = file_id
        self.dataset_dates: list[datetime] = []
        self.raw_files: list[str] = []
        self._opened: dict | None = None
        self._times = self._f_hours = self._lat = self._lon = None

    def set_dates(self, dates) -> None:
        dates = sorted(dates)
        if self.fill_hourly:
            self.dataset_dates = six_hourly_dates(dates[0], dates[-1])
        else:
            self.dataset_dates = list(dates)

    @staticmethod
    def end_date(dt: datetime) -> datetime:
        """Forecast end date: 00Z runs extend to the 1st of the month ~4
        months out; off-hours runs extend 45 days (cfsr.py:817-824)."""
        if dt.hour == 0:
            return (dt.replace(day=1) + timedelta(days=130)).replace(day=1)
        return dt + timedelta(days=45)

    def grib_path(self, variable: str, dt: datetime) -> str:
        start = dt.strftime("%Y%m%d%H")
        end = self.end_date(dt).strftime("%Y%m%d%H")
        subdir = dt.strftime(f"{variable}/%Y/%Y%m/%Y%m%d")
        return f"{subdir}/{variable}.{start}.{end}.grb2"

    def grib_url(self, variable: str, dt: datetime) -> str:
        return f"{self._root_url}/{self.grib_path(variable, dt)}"

    def retrieve(self, dates="all", variables="all", n_proc: int = 4,
                 verbose: bool = False) -> None:
        """Download reforecast GRIBs (cfsr.py:777-869); idempotent."""
        if dates != "all":
            self.set_dates(dates)
        if variables == "all":
            variables = self.variables
        self.raw_files = []
        for var in variables:
            for dt in self.dataset_dates:
                if dt < REFORECAST_START or dt > REFORECAST_END:
                    warnings.warn(f"date {dt} outside reforecast range")
                    continue
                rel = self.grib_path(var, dt)
                local = os.path.join(self.root_directory, rel)
                os.makedirs(os.path.dirname(local), exist_ok=True)
                self.raw_files.append(rel)

        def fetch(rel):
            fetch_with_retry(
                f"{self._root_url}/{rel}",
                os.path.join(self.root_directory, rel),
            )

        with ThreadPoolExecutor(max_workers=max(1, n_proc)) as pool:
            list(pool.map(fetch, self.raw_files))

    def monthly_file(self, variable: str, year: int, month: int) -> str:
        return os.path.join(
            self.root_directory,
            f"cfsrf_{variable}_{year}{month:02d}{self.file_id}.h5",
        )

    def write(self, variables="all", max_f_hours: int = 1080,
              regrid_to=None, verbose: bool = False) -> None:
        """Decode reforecast GRIBs into monthly (f_hour, time, lat, lon)
        files (cfsr.py:871-1156); optional bivariate-spline regridding to a
        target (lat, lon) grid (cfsr.py:1014-1019)."""
        if pygrib is None:
            raise RuntimeError("pygrib is required to decode GRIB2 files")
        if h5py is None:
            raise RuntimeError("h5py is required")
        if variables == "all":
            variables = self.variables
        n_f = max_f_hours // self.dt_hours + 1
        months: dict[tuple[int, int], list[datetime]] = {}
        for dt in self.dataset_dates:
            months.setdefault((dt.year, dt.month), []).append(dt)
        for var in variables:
            for (year, month), dts in sorted(months.items()):
                dts = sorted(dts)
                data = lat = lon = None
                for i, dt in enumerate(dts):
                    local = os.path.join(
                        self.root_directory, self.grib_path(var, dt)
                    )
                    if not os.path.exists(local):
                        warnings.warn(f"missing {local}; skipping")
                        continue
                    grbs = pygrib.open(local)
                    for msg in grbs:
                        fh = int(
                            (msg.validDate - dt).total_seconds() // 3600
                        )
                        if fh % self.dt_hours or fh > max_f_hours:
                            continue
                        vals = msg.values
                        if lat is None:
                            la, lo = msg.latlons()
                            lat, lon = la[:, 0], lo[0, :]
                        if regrid_to is not None:
                            vals, lat2, lon2 = _regrid(vals, lat, lon,
                                                       *regrid_to)
                        else:
                            lat2, lon2 = lat, lon
                        if data is None:
                            data = np.full(
                                (n_f, len(dts), len(lat2), len(lon2)),
                                np.nan, np.float32,
                            )
                        data[fh // self.dt_hours, i] = vals
                    grbs.close()
                if data is None:
                    continue
                with h5py.File(self.monthly_file(var, year, month), "w") as f:
                    f.create_dataset(
                        "time",
                        data=np.array(dts, dtype="datetime64[ns]").astype(np.int64),
                    )
                    f.create_dataset(
                        "f_hour",
                        data=np.arange(n_f) * self.dt_hours,
                    )
                    f.create_dataset("lat", data=lat2)
                    f.create_dataset("lon", data=lon2)
                    f.create_dataset(var, data=data)
                if verbose:
                    print(f"wrote {self.monthly_file(var, year, month)}")

    def open(self, variable: str, years_months) -> "CFSReforecast":
        """Open monthly reforecast files, concatenated along init time
        (cfsr.py:1158-1191)."""
        if h5py is None:
            raise RuntimeError("h5py is required")
        arrays, times = [], []
        for year, month in sorted(years_months):
            with h5py.File(self.monthly_file(variable, year, month), "r") as f:
                times.append(f["time"][:].astype("datetime64[ns]"))
                self._f_hours = f["f_hour"][:]
                self._lat = f["lat"][:]
                self._lon = f["lon"][:]
                arrays.append(f[variable][:])
        self._times = np.concatenate(times)
        self._opened = {variable: np.concatenate(arrays, axis=1)}
        return self

    @property
    def times(self):
        return self._times

    @property
    def f_hours(self):
        return self._f_hours

    @property
    def lat(self):
        return self._lat

    @property
    def lon(self):
        return self._lon

    def forecast(self, variable: str) -> np.ndarray:
        """(f_hour, time, lat, lon) forecast array for verification."""
        return self._opened[variable]


def _regrid(vals, lat, lon, new_lat, new_lon):
    """Bivariate-spline regrid (reference cfsr.py:1014-1019 capability)."""
    from scipy.interpolate import RectBivariateSpline

    order = np.argsort(lat)
    spl = RectBivariateSpline(lat[order], lon, vals[order])
    out = spl(np.sort(new_lat), new_lon)
    # restore requested latitude orientation
    if new_lat[0] > new_lat[-1]:
        out = out[::-1]
    return out, np.asarray(new_lat), np.asarray(new_lon)

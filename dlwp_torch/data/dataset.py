"""The predictor dataset and its file format (port of
``dlwp_tpu.data.dataset``).

``predictors`` is (sample, [time_step,] varlev, lat, lon), with per-varlev
``mean``/``std`` and coordinate vectors, as in the reference's predictor
files. The file is HDF5 through h5py, in the JAX package's schema, so
either package reads what the other writes:

- ``predictors`` (and ``targets`` in the samples format): the arrays,
  chunked one sample a chunk (``(1, ...)``), uncompressed;
- ``sample``: the sample times as int64 nanoseconds since the epoch;
- ``varlev``: the 'VAR/level' names as bytes;
- ``lat``, ``lon``, and ``mean``/``std`` when the data are scaled;
- file attributes: the dataset's ``attrs``.

``from_file(path, load='lazy')`` keeps the h5py dataset open and reads on
demand (the samplers read a batch's rows at a time); ``load='full'``
reads everything into memory. h5py is optional: without it, writing and
reading raise ``RuntimeError``. ``to_netcdf`` and ``to_zarr`` need
netCDF4 and zarr the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

try:
    import h5py
except ImportError:
    h5py = None

NO_H5PY = "h5py is required for predictor-file I/O"


@dataclasses.dataclass
class PredictorDataset:
    """In-memory (or lazily backed) predictor dataset.

    ``predictors`` and ``targets`` are numpy arrays, or h5py datasets when
    read lazily; ``_file`` is then the open h5py file (:meth:`close`)."""

    predictors: Any
    sample: np.ndarray
    varlev: list[str]
    lat: np.ndarray
    lon: np.ndarray
    mean: np.ndarray | None = None
    std: np.ndarray | None = None
    targets: Any | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    _file: Any = None

    @property
    def dims(self) -> dict[str, int]:
        shape = self.predictors.shape
        names = (["sample", "time_step", "varlev", "lat", "lon"]
                 if len(shape) == 5 else ["sample", "varlev", "lat", "lon"])
        return dict(zip(names, shape))

    @property
    def has_time_step(self) -> bool:
        return np.ndim(self.predictors) == 5

    def varlev_index(self, names: Sequence[str]) -> np.ndarray:
        """Indices of the given varlev names (order preserved)."""
        lookup = {v: i for i, v in enumerate(self.varlev)}
        try:
            return np.array([lookup[n] for n in names], dtype=np.int64)
        except KeyError as e:
            raise KeyError(
                f"varlev {e.args[0]!r} not in dataset (has {self.varlev})"
            ) from None

    def isel_sample(self, index) -> "PredictorDataset":
        """Subset along the sample axis (train/validation splits), in
        memory."""
        return dataclasses.replace(
            self,
            predictors=np.asarray(self.predictors)[index],
            sample=self.sample[index],
            targets=None if self.targets is None
            else np.asarray(self.targets)[index],
            _file=None,
        )

    def sel(self, varlev: Sequence[str] | None = None) -> "PredictorDataset":
        """Subset channels by varlev name (a copy in memory)."""
        if varlev is None:
            return self
        idx = self.varlev_index(varlev)
        axis = 2 if self.has_time_step else 1
        return dataclasses.replace(
            self,
            predictors=np.take(np.asarray(self.predictors), idx, axis=axis),
            varlev=[self.varlev[i] for i in idx],
            mean=None if self.mean is None else self.mean[idx],
            std=None if self.std is None else self.std[idx],
            targets=None if self.targets is None
            else np.take(np.asarray(self.targets), idx, axis=axis),
            _file=None,
        )

    def load(self) -> "PredictorDataset":
        """Read lazy arrays into memory (the 'full' load policy)."""
        self.predictors = np.asarray(self.predictors)
        if self.targets is not None:
            self.targets = np.asarray(self.targets)
        return self

    def inverse_scale(self, data: np.ndarray) -> np.ndarray:
        """Undo the stored per-varlev scaling of a (..., varlev, lat, lon)
        array."""
        if self.mean is None or self.std is None:
            return data
        return data * self.std[:, None, None] + self.mean[:, None, None]

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    # ------------------------------------------------------------------ I/O
    def to_file(self, path: str) -> None:
        """Write the HDF5 predictor file (the schema above)."""
        if h5py is None:
            raise RuntimeError(NO_H5PY)
        pred = np.asarray(self.predictors)
        with h5py.File(path, "w") as f:
            f.create_dataset("predictors", data=pred,
                             chunks=(1,) + pred.shape[1:], compression=None)
            if self.targets is not None:
                f.create_dataset("targets", data=np.asarray(self.targets))
            f.create_dataset(
                "sample",
                data=self.sample.astype("datetime64[ns]").astype(np.int64))
            f.create_dataset("varlev",
                             data=np.array([v.encode() for v in self.varlev]))
            f.create_dataset("lat", data=np.asarray(self.lat))
            f.create_dataset("lon", data=np.asarray(self.lon))
            if self.mean is not None:
                f.create_dataset("mean", data=np.asarray(self.mean))
                f.create_dataset("std", data=np.asarray(self.std))
            for k, v in self.attrs.items():
                f.attrs[k] = v

    def to_netcdf(self, path: str) -> None:
        """Write a netCDF predictor file, the reference's own format
        (needs the optional netCDF4)."""
        try:
            import netCDF4
        except ImportError:
            raise RuntimeError(
                "netCDF4 is not installed; use to_file() (HDF5) instead"
            ) from None
        with netCDF4.Dataset(path, "w") as nc:
            dims = self.dims
            for name, size in dims.items():
                nc.createDimension(name, size)
            v = nc.createVariable("predictors", "f4", tuple(dims))
            v[:] = np.asarray(self.predictors)
            tvar = nc.createVariable("sample", "i8", ("sample",))
            tvar[:] = self.sample.astype("datetime64[ns]").astype(np.int64)
            tvar.units = "nanoseconds since 1970-01-01"
            nc.createVariable("lat", "f8", ("lat",))[:] = self.lat
            nc.createVariable("lon", "f8", ("lon",))[:] = self.lon
            if self.mean is not None:
                nc.createVariable("mean", "f8", ("varlev",))[:] = self.mean
                nc.createVariable("std", "f8", ("varlev",))[:] = self.std
            nc.setncattr("varlev", ",".join(self.varlev))

    def to_zarr(self, path: str) -> None:
        """Write a zarr store (needs the optional zarr)."""
        try:
            import zarr
        except ImportError:
            raise RuntimeError(
                "zarr is not installed; use to_file() (HDF5) instead"
            ) from None
        root = zarr.open(path, mode="w")
        root.create_dataset("predictors", data=np.asarray(self.predictors))
        root.create_dataset(
            "sample",
            data=self.sample.astype("datetime64[ns]").astype(np.int64))
        root.create_dataset("lat", data=np.asarray(self.lat))
        root.create_dataset("lon", data=np.asarray(self.lon))
        if self.mean is not None:
            root.create_dataset("mean", data=np.asarray(self.mean))
            root.create_dataset("std", data=np.asarray(self.std))
        root.attrs["varlev"] = list(self.varlev)

    @classmethod
    def from_file(cls, path: str, load: str = "full") -> "PredictorDataset":
        """Read a predictor file: ``load='full'`` into memory, ``'lazy'``
        keeping the h5py file open (closed by :meth:`close`)."""
        if h5py is None:
            raise RuntimeError(NO_H5PY)
        f = h5py.File(path, "r")
        pred = f["predictors"]
        targets = f["targets"] if "targets" in f else None
        if load == "full":
            pred = pred[:]
            targets = targets[:] if targets is not None else None
        ds = cls(
            predictors=pred,
            sample=f["sample"][:].astype("datetime64[ns]"),
            varlev=[v.decode() for v in f["varlev"][:]],
            lat=f["lat"][:],
            lon=f["lon"][:],
            mean=f["mean"][:] if "mean" in f else None,
            std=f["std"][:] if "std" in f else None,
            targets=targets,
            attrs=dict(f.attrs),
            _file=f if load != "full" else None,
        )
        if load == "full":
            f.close()
        return ds

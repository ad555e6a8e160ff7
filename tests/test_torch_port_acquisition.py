"""Acquisition in the port (``dlwp_torch.data.cfs``, ``era5``,
``grib_params``) with no network: each test of
``tests/test_plot_and_acquisition.py``'s CFS, ERA5, reforecast, GRIB and
local-HTTP classes run against the port, and the port held against the
JAX modules: the same paths, URLs, requests and tables, ``_regrid`` to
1e-12 relative (the same scipy spline on the same grid), and the same
HTTP requests against one local fixture server."""

import dataclasses
import os
from datetime import datetime

import h5py
import numpy as np
import pytest

import dlwp_tpu.data.cfs as jcfs
import dlwp_tpu.data.era5 as jera5
import dlwp_tpu.data.grib_params as jgrib
from test_plot_and_acquisition import _FixtureHTTPServer

import dlwp_torch.data.cfs as tcfs
import dlwp_torch.data.era5 as tera5
import dlwp_torch.data.grib_params as tgrib
from dlwp_torch.data import Preprocessor
from dlwp_torch.data.cfs import (
    VARIABLE_ALIASES,
    CFSReanalysis,
    CFSReforecast,
    _regrid,
    six_hourly_dates,
)
from dlwp_torch.data.era5 import PRESSURE_LEVELS, ERA5Reanalysis
from dlwp_torch.data.grib_params import GRIB2_PARAMS, lookup

from tests.torch_port_threads import one_blas_thread  # noqa: F401

TOL_REGRID = 1e-12


class TestCFSLogic:
    def test_six_hourly_expansion(self):
        dates = six_hourly_dates(datetime(2000, 1, 1), datetime(2000, 1, 2))
        assert len(dates) == 5
        assert dates[1] == datetime(2000, 1, 1, 6)

    def test_url_and_path_construction(self, tmp_path):
        cfs = CFSReanalysis(root_directory=str(tmp_path), resolution="l",
                            run_type="06")
        dt = datetime(2003, 7, 15, 6)
        assert cfs.grib_path(dt) == (
            "2003/200307/20030715/pgbl06.gdas.2003071506.grb2")
        assert cfs.grib_url(dt).startswith("https://nomads.ncdc.noaa.gov/")
        assert cfs.ny == 73 and cfs.nx == 144
        hi = CFSReanalysis(root_directory=str(tmp_path), resolution="h")
        assert hi.ny == 361 and hi.nx == 720
        with pytest.raises(ValueError):
            CFSReanalysis(resolution="x")
        with pytest.raises(ValueError):
            CFSReanalysis(run_type="99")

    def test_set_dates_fill_hourly(self, tmp_path):
        cfs = CFSReanalysis(root_directory=str(tmp_path))
        cfs.set_dates([datetime(2000, 1, 1), datetime(2000, 1, 2)])
        assert len(cfs.dataset_dates) == 5

    def test_monthly_roundtrip_without_pygrib(self, tmp_path):
        cfs = CFSReanalysis(root_directory=str(tmp_path))
        cfs.set_dates([datetime(2000, 1, 1), datetime(2000, 1, 1, 18)])
        path = cfs.monthly_file(2000, 1)
        times = np.array(cfs.dataset_dates, dtype="datetime64[ns]")
        with h5py.File(path, "w") as f:
            f.create_dataset("time", data=times.astype(np.int64))
            f.create_dataset("level", data=np.array([500, 1000]))
            f.create_dataset("lat", data=np.linspace(90, -90, 73))
            f.create_dataset("lon", data=np.arange(144) * 2.5)
            f.create_dataset(
                "gh", data=np.random.RandomState(0).randn(4, 2, 73, 144))
        cfs.open([(2000, 1)])
        assert cfs.times.shape == (4,)
        f500 = cfs.field("HGT", 500)
        assert f500.shape == (4, 73, 144)
        with pytest.raises(ValueError):
            cfs.closest_lat_lon(45.0, 500.0)
        idx = cfs.closest_lat_lon(45.0, 180.0)
        assert cfs.lat[idx[0]] == 45.0
        # The opened archive is a DataSource: JAX's reads the same file
        # into the same fields, and the Preprocessor takes it.
        jax_cfs = jcfs.CFSReanalysis(root_directory=str(tmp_path))
        jax_cfs.set_dates(cfs.dataset_dates)
        jax_cfs.open([(2000, 1)])
        np.testing.assert_array_equal(cfs.times, jax_cfs.times)
        np.testing.assert_array_equal(f500, jax_cfs.field("HGT", 500))
        assert idx == jax_cfs.closest_lat_lon(45.0, 180.0)
        ds = Preprocessor(cfs).data_to_series(["HGT"], [500, 1000])
        assert ds.varlev == ["HGT/500", "HGT/1000"]
        assert ds.predictors.shape == (4, 2, 73, 144)

    def test_retrieve_requires_no_network_when_cached(self, tmp_path):
        cfs = CFSReanalysis(root_directory=str(tmp_path))
        cfs.set_dates([datetime(2000, 1, 1)])
        for d in cfs.dataset_dates:
            p = os.path.join(str(tmp_path), cfs.grib_path(d))
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "wb") as f:
                f.write(b"x")
        cfs.retrieve()
        assert len(cfs.raw_files) == len(cfs.dataset_dates)

    def test_write_without_pygrib_raises_as_jax(self, tmp_path, monkeypatch):
        monkeypatch.setattr(tcfs, "pygrib", None)
        monkeypatch.setattr(jcfs, "pygrib", None)
        msgs = []
        for mod in (tcfs, jcfs):
            with pytest.raises(RuntimeError, match="pygrib") as e:
                mod.CFSReanalysis(root_directory=str(tmp_path)).write()
            msgs.append(str(e.value))
            with pytest.raises(RuntimeError, match="pygrib"):
                mod.CFSReforecast(root_directory=str(tmp_path)).write()
        assert msgs[0] == msgs[1]


class TestERA5Logic:
    def test_variable_and_level_validation(self, tmp_path):
        era = ERA5Reanalysis(root_directory=str(tmp_path))
        era.set_variables(["geopotential", "temperature"])
        with pytest.raises(ValueError):
            era.set_variables(["bogus_variable"])
        era.set_levels([500, 1000])
        with pytest.raises(ValueError):
            era.set_levels([123])
        assert 500 in PRESSURE_LEVELS

    def test_request_construction(self, tmp_path):
        era = ERA5Reanalysis(root_directory=str(tmp_path))
        dates = [datetime(2000, 1, 1), datetime(2001, 6, 1)]
        req = era.build_request(
            "geopotential", 500, dates, request_kwargs={"grid": [2.0, 2.0]})
        assert req["pressure_level"] == "500"
        assert req["year"] == ["2000", "2001"]
        assert req["grid"] == [2.0, 2.0]
        assert req["time"] == ["00:00", "06:00", "12:00", "18:00"]
        req_sfc = era.build_request("2m_temperature", None, dates)
        assert "pressure_level" not in req_sfc

    def test_file_path(self, tmp_path):
        era = ERA5Reanalysis(root_directory=str(tmp_path), file_id="_test")
        p = era.file_path("geopotential", 500)
        assert p.endswith("era5_z_500_test.nc")

    def test_retrieve_without_cdsapi_raises(self, tmp_path):
        era = ERA5Reanalysis(root_directory=str(tmp_path))
        if tera5.cdsapi is None:
            with pytest.raises(RuntimeError, match="cdsapi"):
                era.retrieve(["geopotential"], [500],
                             [datetime(2000, 1, 1)])

    def test_open_without_netcdf4_raises_as_jax(self, tmp_path, monkeypatch):
        monkeypatch.setattr(tera5, "netCDF4", None)
        monkeypatch.setattr(jera5, "netCDF4", None)
        msgs = []
        for mod in (tera5, jera5):
            era = mod.ERA5Reanalysis(root_directory=str(tmp_path))
            with pytest.raises(RuntimeError, match="netCDF4") as e:
                era.open(["geopotential"], [500])
            with pytest.raises(RuntimeError, match="open"):
                era.times
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


class TestCFSReforecast:
    def test_end_date_logic(self, tmp_path):
        c = CFSReforecast(root_directory=str(tmp_path))
        assert c.end_date(datetime(2003, 1, 1, 0)) == datetime(2003, 5, 1)
        assert c.end_date(datetime(2003, 1, 15, 6)) == datetime(2003, 3, 1, 6)

    def test_monthly_roundtrip(self, tmp_path):
        c = CFSReforecast(root_directory=str(tmp_path))
        times = np.array([datetime(2003, 1, 1), datetime(2003, 1, 1, 6)],
                         dtype="datetime64[ns]")
        with h5py.File(c.monthly_file("z500", 2003, 1), "w") as f:
            f.create_dataset("time", data=times.astype(np.int64))
            f.create_dataset("f_hour", data=np.arange(0, 49, 6))
            f.create_dataset("lat", data=np.linspace(90, -90, 181))
            f.create_dataset("lon", data=np.arange(360.0))
            f.create_dataset(
                "z500", data=np.random.RandomState(0).rand(
                    9, 2, 181, 360).astype(np.float32))
        c.open("z500", [(2003, 1)])
        fc = c.forecast("z500")
        assert fc.shape == (9, 2, 181, 360)
        assert c.f_hours[-1] == 48
        jc = jcfs.CFSReforecast(root_directory=str(tmp_path))
        jc.open("z500", [(2003, 1)])
        np.testing.assert_array_equal(fc, jc.forecast("z500"))
        np.testing.assert_array_equal(c.times, jc.times)

    def test_regrid(self):
        lat = np.linspace(90, -90, 19)
        lon = np.arange(0, 360, 10.0)
        vals = np.outer(np.sin(np.radians(lat)), np.ones(36))
        out, la2, lo2 = _regrid(vals, lat, lon, np.linspace(90, -90, 37),
                                np.arange(0, 360, 5.0))
        assert out.shape == (37, 72)
        assert abs(out[18].mean()) < 1e-6
        assert out[0].mean() > 0.9


@pytest.mark.parametrize("orientation", ["north_first", "south_first"])
def test_regrid_matches_jax(orientation):
    rng = np.random.RandomState(5)
    lat = np.linspace(90, -90, 19)
    lon = np.arange(0, 360, 10.0)
    vals = rng.randn(19, 36)
    new_lat = np.linspace(88, -88, 23)
    if orientation == "south_first":
        new_lat = new_lat[::-1]
    new_lon = np.arange(0, 350, 7.0)
    got = _regrid(vals, lat, lon, new_lat, new_lon)
    want = jcfs._regrid(vals, lat, lon, new_lat, new_lon)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL_REGRID, atol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


class TestCFSPlot:
    def test_quicklook_plot(self, tmp_path):
        cfs = CFSReanalysis(root_directory=str(tmp_path))
        cfs.set_dates([datetime(2000, 1, 1)])
        with h5py.File(cfs.monthly_file(2000, 1), "w") as f:
            f.create_dataset("time", data=np.array(
                [np.datetime64("2000-01-01")], dtype="datetime64[ns]"
            ).astype(np.int64))
            f.create_dataset("level", data=np.array([500]))
            f.create_dataset("lat", data=np.linspace(90, -90, 19))
            f.create_dataset("lon", data=np.arange(36) * 10.0)
            f.create_dataset("gh",
                             data=np.random.RandomState(0).rand(1, 1, 19, 36))
        cfs.open([(2000, 1)])
        ax = cfs.plot("HGT", 500)
        assert ax is not None
        assert ax.get_title() == "HGT/500 @ 2000-01-01T00:00:00.000000000"


class TestGribParams:
    def test_default_pressure_level_set(self):
        expect = {
            "HGT": (0, 3, 5), "TMP": (0, 0, 0), "UGRD": (0, 2, 2),
            "VGRD": (0, 2, 3), "VVEL": (0, 2, 8), "SPFH": (0, 1, 0),
            "RH": (0, 1, 1), "ABSV": (0, 2, 10), "STRM": (0, 2, 4),
            "CLWMR": (0, 1, 22), "GPA": (0, 3, 9), "5WAVH": (0, 3, 193),
        }
        for name, triple in expect.items():
            p = lookup(name)
            assert p is not None, name
            assert (p.discipline, p.category, p.number) == triple, name
            assert p.level_kind == "pl", name

    def test_spelling_variants(self):
        assert lookup("U GRD") == lookup("UGRD") == lookup("u")
        assert lookup("R H") == lookup("RH") == lookup("r")
        assert lookup("gh") == lookup("HGT")
        assert lookup("P WAT").level_kind == "108"
        assert lookup("SEAI") is not None
        assert lookup("SEAI").discipline == 10
        assert lookup("5WAVA") is not None
        assert lookup("NOT_A_VAR") is None

    def test_registry_covers_reference_breadth(self):
        blocks = {(p.discipline, p.category) for p in GRIB2_PARAMS.values()}
        for block in [(0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (0, 5),
                      (0, 6), (0, 7), (0, 14), (0, 19), (1, 0), (2, 0),
                      (2, 3), (10, 2)]:
            assert block in blocks, block
        assert len(GRIB2_PARAMS) >= 90


def test_grib_table_equals_jax_entry_for_entry():
    assert list(tgrib.GRIB2_PARAMS) == list(jgrib.GRIB2_PARAMS)
    for name, p in tgrib.GRIB2_PARAMS.items():
        assert dataclasses.astuple(p) == dataclasses.astuple(
            jgrib.GRIB2_PARAMS[name]), name
    assert tgrib._SPELLINGS == jgrib._SPELLINGS
    for name in [*tgrib.GRIB2_PARAMS, *tgrib._SPELLINGS, "gh", "x", "u grd"]:
        got, want = tgrib.lookup(name), jgrib.lookup(name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_tables_paths_and_urls_equal_jax(tmp_path):
    for attr in ("DEFAULT_VARIABLES", "VARIABLE_ALIASES", "LEVEL_COORD",
                 "DATA_START", "DATA_END", "REFORECAST_START",
                 "REFORECAST_END", "REFORECAST_VARIABLES"):
        assert getattr(tcfs, attr) == getattr(jcfs, attr), attr
    assert VARIABLE_ALIASES["HGT"] == "gh"
    for attr in ("VARIABLE_NAMES", "PRESSURE_LEVELS"):
        assert getattr(tera5, attr) == getattr(jera5, attr), attr
    dates = [datetime(1999, 12, 31, 18), datetime(2003, 7, 15, 6),
             datetime(2011, 3, 31)]
    assert (tcfs.six_hourly_dates(dates[0], dates[1])
            == jcfs.six_hourly_dates(dates[0], dates[1]))
    root = str(tmp_path)
    for res in ("l", "h"):
        for run in ("01", "06", "nl"):
            got = tcfs.CFSReanalysis(root, res, run, file_id="_x")
            want = jcfs.CFSReanalysis(root, res, run, file_id="_x")
            assert (got.ny, got.nx) == (want.ny, want.nx)
            for dt in dates:
                assert got.grib_path(dt) == want.grib_path(dt)
                assert got.grib_url(dt) == want.grib_url(dt)
            assert got.monthly_file(2003, 7) == want.monthly_file(2003, 7)
    got, want = tcfs.CFSReforecast(root), jcfs.CFSReforecast(root)
    for dt in dates:
        assert got.end_date(dt) == want.end_date(dt)
        assert got.grib_path("z500", dt) == want.grib_path("z500", dt)
        assert got.grib_url("z500", dt) == want.grib_url("z500", dt)
    assert got.monthly_file("z500", 2003, 1) == want.monthly_file(
        "z500", 2003, 1)
    era, jera = tera5.ERA5Reanalysis(root, "_y"), jera5.ERA5Reanalysis(
        root, "_y")
    for variable, level in (("geopotential", 500), ("2m_temperature", None),
                            ("t", 850)):
        assert era.file_path(variable, level) == jera.file_path(
            variable, level)
        assert (era.build_request(variable, level, dates, {"grid": [1, 1]})
                == jera.build_request(variable, level, dates,
                                      {"grid": [1, 1]}))


class TestRetrieveHTTP:
    """``retrieve()`` against a local HTTP fixture (no egress): fetch, one
    retry, idempotency skip, atomic partial-file handling."""

    def test_fetch_end_to_end(self, tmp_path):
        cfs = CFSReanalysis(root_directory=str(tmp_path), fill_hourly=False)
        dt = datetime(2000, 1, 1)
        rel = cfs.grib_path(dt)
        srv = _FixtureHTTPServer({f"/{rel}": b"GRIB-fixture-bytes"})
        try:
            cfs._root_url = srv.url
            cfs.retrieve([dt])
            local = os.path.join(str(tmp_path), rel)
            assert open(local, "rb").read() == b"GRIB-fixture-bytes"
            assert cfs.raw_files == [rel]
        finally:
            srv.close()

    def test_transient_failure_retried_once(self, tmp_path):
        import warnings as w

        cfs = CFSReanalysis(root_directory=str(tmp_path), fill_hourly=False)
        dt = datetime(2000, 1, 1)
        rel = cfs.grib_path(dt)
        srv = _FixtureHTTPServer({f"/{rel}": b"ok-after-retry"},
                                 fail_counts={f"/{rel}": 1})
        try:
            cfs._root_url = srv.url
            with w.catch_warnings():
                w.simplefilter("error")
                cfs.retrieve([dt])
            local = os.path.join(str(tmp_path), rel)
            assert open(local, "rb").read() == b"ok-after-retry"
            assert len(srv.requests) == 2
        finally:
            srv.close()

    def test_persistent_failure_warns_and_continues(self, tmp_path):
        cfs = CFSReanalysis(root_directory=str(tmp_path), fill_hourly=False)
        d_bad, d_good = datetime(2000, 1, 1), datetime(2000, 1, 2)
        rel_bad, rel_good = cfs.grib_path(d_bad), cfs.grib_path(d_good)
        srv = _FixtureHTTPServer({f"/{rel_good}": b"good"})
        try:
            cfs._root_url = srv.url
            with pytest.warns(UserWarning, match="failed to download"):
                cfs.retrieve([d_bad, d_good])
            assert not os.path.exists(os.path.join(str(tmp_path), rel_bad))
            good = os.path.join(str(tmp_path), rel_good)
            assert open(good, "rb").read() == b"good"
            assert srv.requests.count(f"/{rel_bad}") == 2
        finally:
            srv.close()

    def test_idempotency_skip(self, tmp_path):
        cfs = CFSReanalysis(root_directory=str(tmp_path), fill_hourly=False)
        dt = datetime(2000, 1, 1)
        rel = cfs.grib_path(dt)
        srv = _FixtureHTTPServer({f"/{rel}": b"payload"})
        try:
            cfs._root_url = srv.url
            cfs.retrieve([dt])
            n = len(srv.requests)
            cfs.retrieve([dt])
            assert len(srv.requests) == n
        finally:
            srv.close()

    def test_truncated_transfer_leaves_no_partial_file(self, tmp_path):
        cfs = CFSReanalysis(root_directory=str(tmp_path), fill_hourly=False)
        dt = datetime(2000, 1, 1)
        rel = cfs.grib_path(dt)
        path = f"/{rel}"
        srv = _FixtureHTTPServer({path: b"full-grib-payload"},
                                 truncate_paths=[path])
        try:
            cfs._root_url = srv.url
            with pytest.warns(UserWarning, match="failed to download"):
                cfs.retrieve([dt])
            local = os.path.join(str(tmp_path), rel)
            assert not os.path.exists(local)
            assert not os.path.exists(local + ".part")
            srv.truncate_paths.clear()
            cfs.retrieve([dt])
            assert open(local, "rb").read() == b"full-grib-payload"
        finally:
            srv.close()

    def test_reforecast_fetch(self, tmp_path):
        rf = CFSReforecast(root_directory=str(tmp_path))
        rf.variables = ["z500"]
        dt = datetime(2000, 1, 1)
        rf.set_dates([dt])
        rel = rf.grib_path("z500", dt)
        srv = _FixtureHTTPServer({f"/{rel}": b"reforecast-bytes"})
        try:
            rf._root_url = srv.url
            rf.retrieve()
            local = os.path.join(str(tmp_path), rel)
            assert open(local, "rb").read() == b"reforecast-bytes"
        finally:
            srv.close()


@pytest.mark.parametrize("kind", ["reanalysis", "reforecast"])
def test_retrieve_sends_jax_requests(tmp_path, kind):
    """Both packages' ``retrieve`` over the same dates ask one fixture
    server for the same paths (one failing once, one missing: the retry
    and the warning alike) and leave the same files."""
    dates = [datetime(2000, 1, 1), datetime(2000, 1, 1, 12)]
    trees = {}
    for name, mod in (("port", tcfs), ("jax", jcfs)):
        root = tmp_path / name
        if kind == "reanalysis":
            obj = mod.CFSReanalysis(root_directory=str(root))
            obj.set_dates(dates)
            rels = [obj.grib_path(d) for d in obj.dataset_dates]
        else:
            obj = mod.CFSReforecast(root_directory=str(root))
            obj.variables = ["z500", "tmp2m"]
            obj.set_dates(dates)
            rels = [obj.grib_path(v, d) for v in obj.variables
                    for d in obj.dataset_dates]
        files = {f"/{r}": r.encode() for r in rels[1:]}  # first: 404
        srv = _FixtureHTTPServer(files, fail_counts={f"/{rels[-1]}": 1})
        try:
            obj._root_url = srv.url
            with pytest.warns(UserWarning, match="failed to download"):
                obj.retrieve(n_proc=1)
        finally:
            srv.close()
        trees[name] = (sorted(srv.requests), obj.raw_files, sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs))
    assert trees["port"] == trees["jax"]
    assert len(trees["port"][0]) == len(trees["port"][1]) + 2

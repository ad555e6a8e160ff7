"""Plotting in the port (``dlwp_torch.plot``), rendered with matplotlib's
Agg backend: the figures of ``tests/test_plot_and_acquisition.py``'s
``test_figures_render`` / ``test_movie`` and its utilities, and the port
held against ``dlwp_tpu.plot``: colormaps as arrays
(``cm(np.linspace(0, 1, N))``), ``shifted_color_map``, ``remove_chars``
and ``rotate_vector_r`` equal (the same numpy and matplotlib arithmetic),
and each figure's drawn data equal to the JAX module's figure."""

import os

import matplotlib
import numpy as np
import pytest

import dlwp_tpu.plot as jplot

import dlwp_torch.plot as tplot
from dlwp_torch.plot import (
    blue_red_colormap,
    forecast_example_plot,
    history_plot,
    plot_global_map,
    plot_movie,
    radar_colormap,
    remove_chars,
    rgb_colormap,
    rotate_vector_r,
    shifted_color_map,
    zonal_mean_plot,
)

from tests.torch_port_threads import one_blas_thread  # noqa: F401


def test_backend_is_agg():
    assert matplotlib.get_backend().lower() == "agg"
    assert tplot.__all__ == jplot.__all__


class TestPlotUtils:
    def test_colormaps(self):
        assert radar_colormap().N == 16
        assert blue_red_colormap(64).N == 64
        cm = rgb_colormap([(255, 0, 0), (0, 0, 255)])
        assert cm(0.0)[0] > 0.9
        sc = shifted_color_map(blue_red_colormap(), midpoint=0.3)
        assert sc is not None

    def test_remove_chars(self):
        assert remove_chars("HGT/500 mb") == "HGT500mb"

    def test_rotate_vector_identity_projection(self):
        lons = np.arange(0, 360, 30.0)
        lats = np.linspace(-60, 60, 5)
        u = np.ones((5, 12))
        v = np.zeros((5, 12))
        uo, vo = rotate_vector_r(lambda lo, la: (lo, la), u, v, lons, lats)
        np.testing.assert_allclose(np.hypot(uo, vo), np.hypot(u, v),
                                   atol=1e-6)


class TestPlotFunctions:
    def test_figures_render(self, tmp_path):
        lat = np.linspace(90, -90, 19)
        lon = np.arange(0, 360, 10.0)
        field = np.random.RandomState(0).randn(19, 36)
        ax = plot_global_map(lat, lon, field, title="test")
        assert ax is not None
        history_plot({"loss": [3, 2, 1], "val_loss": [3.5, 2.5, 1.5]},
                     file_path=str(tmp_path / "hist.png"))
        assert os.path.exists(tmp_path / "hist.png")
        forecast_example_plot(field, field * 1.1, lat, lon, f_hour=24,
                              file_path=str(tmp_path / "ex.png"))
        assert os.path.exists(tmp_path / "ex.png")
        zonal_mean_plot(field, lat, file_path=str(tmp_path / "zm.png"))
        assert os.path.exists(tmp_path / "zm.png")

    def test_movie(self, tmp_path):
        lat = np.linspace(90, -90, 10)
        lon = np.arange(0, 360, 36.0)
        fields = np.random.RandomState(1).randn(3, 10, 10)
        out = plot_movie(fields, lat, lon, str(tmp_path / "m.gif"),
                         titles=["a", "b", "c"], fps=2)
        assert os.path.exists(out)


COLORMAPS = {
    "radar": lambda m: m.radar_colormap(),
    "blue_red_64": lambda m: m.blue_red_colormap(64),
    "blue_red": lambda m: m.blue_red_colormap(),
    "rgb_255": lambda m: m.rgb_colormap([(255, 0, 0), (0, 128, 255),
                                         (10, 200, 30)], n=100),
    "rgb_unit": lambda m: m.rgb_colormap([(1.0, 0.5, 0.0), (0.0, 0.0, 1.0)]),
    "shifted": lambda m: m.shifted_color_map(m.blue_red_colormap(),
                                             midpoint=0.3),
    "shifted_range": lambda m: m.shifted_color_map(
        m.radar_colormap(), start=0.1, midpoint=0.6, stop=0.9),
}


@pytest.mark.parametrize("name", sorted(COLORMAPS))
def test_colormap_arrays_equal_jax(name):
    got, want = COLORMAPS[name](tplot), COLORMAPS[name](jplot)
    assert got.N == want.N and got.name == want.name
    x = np.linspace(0, 1, got.N)
    np.testing.assert_array_equal(got(x), want(x))


@pytest.mark.parametrize("s", ["HGT/500 mb", "a\\b c/d", "", "plain"])
def test_remove_chars_equals_jax(s):
    assert remove_chars(s) == jplot.remove_chars(s)
    assert remove_chars(s, "ab") == jplot.remove_chars(s, "ab")


@pytest.mark.parametrize("grid", ["1d", "2d_polar"])
@pytest.mark.parametrize("returnxy", [False, True])
def test_rotate_vector_r_equals_jax(grid, returnxy):
    """A Mercator-like projection (the rotation is not the identity), with
    points near the pole where the displacement flips."""
    def project(lon, lat):
        return (np.radians(lon),
                np.log(np.tan(np.pi / 4 + np.radians(np.clip(lat, -89.9,
                                                             89.9)) / 2)))

    rng = np.random.RandomState(3)
    lons = np.arange(0, 360, 40.0)
    lats = np.array([-89.999995, -45.0, 0.0, 60.0, 89.999995])
    if grid == "2d_polar":
        lons, lats = np.meshgrid(lons, lats)
    u, v = rng.randn(2, 5, 9)
    got = rotate_vector_r(project, u, v, lons, lats, returnxy=returnxy)
    want = jplot.rotate_vector_r(project, u, v, lons, lats,
                                 returnxy=returnxy)
    assert len(got) == len(want) == (4 if returnxy else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _drawn(fig):
    """The data each axes of a figure draws: mesh arrays, line data,
    titles and labels."""
    out = []
    for ax in fig.axes:
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel()))
        for coll in ax.collections:
            arr = coll.get_array()
            if arr is not None:
                out.append(np.asarray(arr).tolist())
                out.append(coll.get_clim())
        for line in ax.lines:
            out.append(np.asarray(line.get_xydata()).tolist())
    return out


FIGURES = {
    "global_map": lambda m, a: m.plot_global_map(
        a["lat"], a["lon"], a["field"], title="t", vmin=-1.0).figure,
    "history": lambda m, a: m.history_plot(
        {"loss": [3, 2, 1], "val_loss": [3.5, 2.5, 1.5], "x": [1]},
        metrics=("loss", "val_loss", "missing")),
    "example": lambda m, a: m.forecast_example_plot(
        a["field"], a["field"] * 1.1, a["lat"], a["lon"], f_hour=24),
    "zonal_mean_1d": lambda m, a: m.zonal_mean_plot(a["field"], a["lat"],
                                                     title="z"),
    "zonal_mean_2d": lambda m, a: m.zonal_mean_plot(
        np.stack([a["field"], 2 * a["field"]]), a["lat"],
        pressure_or_time=[500, 850]),
    "slp_contour": lambda m, a: m.slp_contour(
        m.plot_global_map(a["lat"], a["lon"], a["field"]), a["lat"],
        a["lon"], 1000 + 20 * a["field"]).figure,
}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figures_draw_what_jax_draws(name):
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(0)
    args = dict(lat=np.linspace(90, -90, 19), lon=np.arange(0, 360, 10.0),
                field=rng.randn(19, 36))
    got, want = FIGURES[name](tplot, args), FIGURES[name](jplot, args)
    try:
        assert _drawn(got) == _drawn(want)
        assert len(got.axes) == len(want.axes)
    finally:
        plt.close(got)
        plt.close(want)


def test_movie_frames_equal_jax(tmp_path):
    from PIL import Image, ImageSequence

    lat = np.linspace(90, -90, 10)
    lon = np.arange(0, 360, 36.0)
    fields = np.random.RandomState(1).randn(3, 10, 10)
    frames = []
    for i, m in enumerate((tplot, jplot)):
        path = m.plot_movie(fields, lat, lon, str(tmp_path / f"{i}.gif"),
                            titles=["a", "b", "c"], fps=2)
        with Image.open(path) as im:
            frames.append([np.asarray(f.convert("RGB"))
                           for f in ImageSequence.Iterator(im)])
    assert len(frames[0]) == len(frames[1]) == 3
    for a, b in zip(*frames):
        np.testing.assert_array_equal(a, b)

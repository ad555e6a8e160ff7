"""Colormaps and plotting helpers (reference ``DLWP/plot/util.py``; port
of ``dlwp_tpu.plot.util``).

Fresh matplotlib-only implementations with the same capability surface:
NWS-style reflectivity colormap, blue-red anomaly maps, generic RGB-list
colormaps, center-shifted colormaps, and a projection-agnostic vector
rotation (the reference's ``rotate_vector_r`` depended on Basemap; here any
``project(lon, lat) -> (x, y)`` callable works).
"""

from __future__ import annotations

import numpy as np
import matplotlib.colors as mcolors


def radar_colormap():
    """NWS-style radar reflectivity colormap (16 levels)."""
    colors = [
        "#ffffff", "#04e9e7", "#019ff4", "#0300f4", "#02fd02", "#01c501",
        "#008e00", "#fdf802", "#e5bc00", "#fd9500", "#fd0000", "#d40000",
        "#bc0000", "#f800fd", "#9854c6", "#fdfdfd",
    ]
    return mcolors.ListedColormap(colors, name="radar")


def blue_red_colormap(n: int = 256):
    """Diverging blue-white-red colormap for anomalies."""
    return mcolors.LinearSegmentedColormap.from_list(
        "blue_red", ["#1f3bb3", "#7aa8f0", "#ffffff", "#f08a7a", "#b31f1f"],
        N=n,
    )


def rgb_colormap(rgb_list, name: str = "custom", n: int = 256):
    """Colormap from a list of RGB tuples (0-255 or 0-1)."""
    rgb = np.asarray(rgb_list, dtype=float)
    if rgb.max() > 1.0:
        rgb = rgb / 255.0
    return mcolors.LinearSegmentedColormap.from_list(name, rgb, N=n)


def shifted_color_map(cmap, start=0.0, midpoint=0.5, stop=1.0, name="shifted"):
    """Re-center a colormap's midpoint (useful for asymmetric anomaly
    ranges), reference util.py:201 capability."""
    cdict = {"red": [], "green": [], "blue": [], "alpha": []}
    reg_index = np.linspace(start, stop, 257)
    shift_index = np.hstack(
        [
            np.linspace(0.0, midpoint, 128, endpoint=False),
            np.linspace(midpoint, 1.0, 129, endpoint=True),
        ]
    )
    for ri, si in zip(reg_index, shift_index):
        r, g, b, a = cmap(ri)
        cdict["red"].append((si, r, r))
        cdict["green"].append((si, g, g))
        cdict["blue"].append((si, b, b))
        cdict["alpha"].append((si, a, a))
    new_cmap = mcolors.LinearSegmentedColormap(name, cdict)
    return new_cmap


def remove_chars(s: str, chars: str = "/\\ ") -> str:
    """Strip characters unsuitable for file names."""
    return "".join(c for c in s if c not in chars)


def rotate_vector_r(project, uin, vin, lons, lats, returnxy: bool = False):
    """Rotate (u, v) from geographic to projected coordinates.

    ``project(lon, lat) -> (x, y)`` is any map projection callable (the
    reference required a Basemap instance). Magnitude is preserved; the
    direction is rotated by the local projection distortion, estimated from
    a small displacement along the vector.
    """
    uin = np.asarray(uin, dtype=float)
    vin = np.asarray(vin, dtype=float)
    lons = np.asarray(lons, dtype=float)
    lats = np.asarray(lats, dtype=float)
    if lons.ndim == 1 and lats.ndim == 1:
        lons, lats = np.meshgrid(lons, lats)
    x, y = project(lons, lats)

    mag = np.hypot(uin, vin)
    theta = np.arctan2(vin, uin)
    eps = 1e-5
    dlon = eps * np.cos(theta)
    dlat = eps * np.sin(theta) * np.cos(np.radians(lats))
    over = np.abs(lats + dlat) >= 90.0
    dlon[over] *= -1.0
    dlat[over] *= -1.0
    xn, yn = project(lons + dlon, lats + dlat)
    ang = np.arctan2(yn - y, xn - x)
    ang[over] += np.pi
    uout = mag * np.cos(ang)
    vout = mag * np.sin(ang)
    if returnxy:
        return uout, vout, x, y
    return uout, vout

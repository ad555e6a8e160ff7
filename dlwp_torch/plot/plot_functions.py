"""Figure builders (reference ``DLWP/plot/plot_functions.py``; port of
``dlwp_tpu.plot.plot_functions``).

Same capability surface as the reference (global field maps, SLP contour
overlays, forecast movies, training-history curves, forecast example
panels, zonal-mean sections) re-implemented on plain matplotlib -- the
reference's Basemap dependency is deprecated/unavailable; a cylindrical
lat/lon projection is used natively and any cartopy axes can be passed in.
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt


def plot_global_map(
    lat,
    lon,
    field,
    ax=None,
    title=None,
    cmap="jet",
    vmin=None,
    vmax=None,
    colorbar=True,
    coastline_color=None,
):
    """Filled global map of a (lat, lon) field (reference plot_basemap,
    plot_functions.py:17)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 5))
    mesh = ax.pcolormesh(
        lon, lat, np.asarray(field), cmap=cmap, vmin=vmin, vmax=vmax,
        shading="auto",
    )
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    if title:
        ax.set_title(title)
    if colorbar:
        plt.colorbar(mesh, ax=ax, shrink=0.8)
    return ax


def slp_contour(ax, lat, lon, slp, levels=None, color="black", lw=0.7):
    """Overlay sea-level-pressure contours (reference slp_contour,
    plot_functions.py:67)."""
    slp = np.asarray(slp)
    if levels is None:
        levels = np.arange(940.0, 1080.0, 4.0)
    cs = ax.contour(lon, lat, slp, levels=levels, colors=color, linewidths=lw)
    ax.clabel(cs, inline=True, fontsize=7, fmt="%d")
    return ax


def plot_movie(
    fields,
    lat,
    lon,
    file_path: str,
    titles=None,
    cmap="jet",
    vmin=None,
    vmax=None,
    fps: int = 4,
):
    """Render a sequence of global fields to an animated GIF (reference
    plot_movie, plot_functions.py:129)."""
    from matplotlib.animation import FuncAnimation, PillowWriter

    fields = np.asarray(fields)
    vmin = vmin if vmin is not None else np.nanmin(fields)
    vmax = vmax if vmax is not None else np.nanmax(fields)
    fig, ax = plt.subplots(figsize=(10, 5))
    mesh = ax.pcolormesh(
        lon, lat, fields[0], cmap=cmap, vmin=vmin, vmax=vmax, shading="auto"
    )
    plt.colorbar(mesh, ax=ax, shrink=0.8)

    def update(i):
        mesh.set_array(fields[i].ravel())
        if titles is not None:
            ax.set_title(str(titles[i]))
        return (mesh,)

    anim = FuncAnimation(fig, update, frames=len(fields))
    anim.save(file_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return file_path


def history_plot(history, metrics=("loss", "val_loss"), file_path=None):
    """Training-history curves (reference history_plot,
    plot_functions.py:168). ``history`` is a Trainer History or a dict."""
    hist = history.history if hasattr(history, "history") else history
    fig, ax = plt.subplots(figsize=(7, 4))
    for m in metrics:
        if m in hist:
            ax.plot(hist[m], label=m)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    ax.grid(alpha=0.3)
    if file_path:
        fig.savefig(file_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def forecast_example_plot(
    verification, forecast, lat, lon, f_hour=None, file_path=None, cmap="jet"
):
    """Side-by-side verification vs. forecast panels (reference
    forecast_example_plot, plot_functions.py:192)."""
    fig, axes = plt.subplots(1, 2, figsize=(14, 4))
    vmin = np.nanmin(verification)
    vmax = np.nanmax(verification)
    plot_global_map(lat, lon, verification, ax=axes[0], title="verification",
                    cmap=cmap, vmin=vmin, vmax=vmax, colorbar=False)
    t = f"forecast (+{f_hour}h)" if f_hour is not None else "forecast"
    plot_global_map(lat, lon, forecast, ax=axes[1], title=t,
                    cmap=cmap, vmin=vmin, vmax=vmax, colorbar=False)
    if file_path:
        fig.savefig(file_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def zonal_mean_plot(field, lat, pressure_or_time=None, file_path=None,
                    cmap="jet", title=None):
    """Zonal-mean cross-section (reference zonal_mean_plot,
    plot_functions.py:247): mean over longitude vs. latitude."""
    zm = np.nanmean(np.asarray(field), axis=-1)
    fig, ax = plt.subplots(figsize=(7, 4))
    if zm.ndim == 1:
        ax.plot(lat, zm)
        ax.set_xlabel("latitude")
    else:
        y = (
            pressure_or_time
            if pressure_or_time is not None
            else np.arange(zm.shape[0])
        )
        mesh = ax.pcolormesh(lat, y, zm, cmap=cmap, shading="auto")
        plt.colorbar(mesh, ax=ax, shrink=0.8)
        ax.set_xlabel("latitude")
    if title:
        ax.set_title(title)
    if file_path:
        fig.savefig(file_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig

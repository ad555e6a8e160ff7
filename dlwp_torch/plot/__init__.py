"""Visualization utilities (reference ``DLWP/plot``; port of
``dlwp_tpu.plot``). Needs matplotlib, which ``import dlwp_torch`` does not;
figures render with the Agg backend."""

from dlwp_torch.plot.plot_functions import (
    plot_global_map,
    slp_contour,
    plot_movie,
    history_plot,
    forecast_example_plot,
    zonal_mean_plot,
)
from dlwp_torch.plot.util import (
    radar_colormap,
    blue_red_colormap,
    rgb_colormap,
    shifted_color_map,
    remove_chars,
    rotate_vector_r,
)

__all__ = [
    "plot_global_map",
    "slp_contour",
    "plot_movie",
    "history_plot",
    "forecast_example_plot",
    "zonal_mean_plot",
    "radar_colormap",
    "blue_red_colormap",
    "rgb_colormap",
    "shifted_color_map",
    "remove_chars",
    "rotate_vector_r",
]

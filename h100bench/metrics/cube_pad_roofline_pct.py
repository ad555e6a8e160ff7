"""The ``cube_pad`` kernel's share of its roofline: the summed least times
of its traced launches (bytes at the card's bandwidth, from the shapes in
``cube_counts.py``) over their device time."""

from h100bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "cube_pad_kernel", "cube_pad_per_step",
                        "cube_pad_bound_s_per_step")

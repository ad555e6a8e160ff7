"""The ``fused_conv_pool`` kernel's share of its roofline: the summed
least times of its traced launches over their device time."""

from h100bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "conv_pool_kernel", "conv_pool_per_step",
                        "conv_pool_bound_s_per_step")

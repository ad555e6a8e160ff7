"""The ``lstm_gates`` kernel's share of its roofline: the summed least
times of its traced launches over their device time."""

from h100bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "lstm_gates_kernel", "gates_per_step",
                        "gates_bound_s_per_step")

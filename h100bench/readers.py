"""The per-layer metrics' arithmetic, shared by the readers in
``h100bench/metrics/``. Each takes the run's context (the trace's
:class:`~h100bench.tracing.Summary`, the driver's unit counts) and returns
a number, or None where the run holds nothing to read.
"""

from __future__ import annotations

from h100bench import counts, tracing


def idle_pct(ctx):
    """Percent of the traced window in which no operation ran on the
    device."""
    s = ctx["trace"]
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def samples_per_s(ctx):
    """Samples of every train step in the driver's unprofiled window over
    the window's seconds (whole epochs, each with its validation pass)."""
    return ctx["units"].get("samples_per_s")


def launches_per_step(ctx):
    """Kernel-launch runtime calls in the traced window per model step
    (forecasts) or train step (training)."""
    s, steps = ctx["trace"], ctx["units"]["steps"]
    return s.launches / steps if s.launches and steps else None


def mfu_forecast_pct(ctx):
    """The configuration's forward FLOPs of every step in the traced
    window over the window's length at the chip's peak."""
    u, s = ctx["units"], ctx["trace"]
    if "flops_per_step" not in u:
        return None
    return 100.0 * u["flops_per_step"] * u["steps"] / (
        s.window_s * counts.PEAK_FLOPS)


def mfu_train_pct(ctx):
    """3 x forward FLOPs x sequence steps of every sample trained in the
    traced window over the window's length at the chip's peak."""
    u, s = ctx["units"], ctx["trace"]
    if "flops_per_sample" not in u:
        return None
    return 100.0 * u["flops_per_sample"] * u["samples"] / (
        s.window_s * counts.PEAK_FLOPS)


def roofline_pct(ctx, fragment: str, per_step: str, bound_per_step: str):
    """Sum of the least times of the launches of the kernels named with
    ``fragment`` over their summed device time; the launches split over
    the model's stages as a step launches them."""
    u = ctx["units"]
    n, secs = tracing.kernel_time(ctx["trace"], fragment)
    if not n or not u.get(per_step):
        return None
    return 100.0 * u[bound_per_step] * (n / u[per_step]) / secs

"""Forward FLOPs of the traced rollout steps over the window at the chip's peak."""

from h100bench.readers import mfu_forecast_pct as read  # noqa: F401

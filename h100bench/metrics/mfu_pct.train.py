"""3 x forward FLOPs x sequence steps of the traced samples over the window at the chip's peak."""

from h100bench.readers import mfu_train_pct as read  # noqa: F401

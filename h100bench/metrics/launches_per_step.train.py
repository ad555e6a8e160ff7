"""Kernel-launch runtime calls per train step (validation included), training cells."""

from h100bench.readers import launches_per_step as read  # noqa: F401

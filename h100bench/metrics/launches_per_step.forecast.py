"""Kernel-launch runtime calls per rollout step, forecast throughput cells."""

from h100bench.readers import launches_per_step as read  # noqa: F401

"""Kernel-launch runtime calls per rollout step, single-forecast latency cells."""

from h100bench.readers import launches_per_step as read  # noqa: F401

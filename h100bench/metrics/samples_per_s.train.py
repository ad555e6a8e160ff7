"""Training samples a second of wall clock over an unprofiled window."""

from h100bench.readers import samples_per_s as read  # noqa: F401

"""Device idle share of the traced window, single-forecast latency cells."""

from h100bench.readers import idle_pct as read  # noqa: F401

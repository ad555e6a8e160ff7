"""Tests of the benchmark itself (CPU; the ``cuda`` ones on the card)."""

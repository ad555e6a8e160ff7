"""Profiling and throughput instrumentation (port of
``dlwp_tpu.utils.profiling``).

- :func:`trace` -- a ``torch.profiler`` context around a block that writes
  a Chrome trace (``chrome://tracing``, Perfetto, TensorBoard);
- :class:`StepTimer` -- per-step time: CUDA events on the card, read at
  :meth:`StepTimer.stop` after the end event completes; the host clock on
  the CPU;
- :class:`ThroughputMeter` -- the grid-points/s(/card) meter.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from dlwp_torch.device import resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block: host operators, and the card's kernels
    when one is present; yields the ``torch.profiler.profile`` and writes
    ``log_dir/trace.json`` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Seconds per step. On ``cuda`` (the default; raises without a card
    unless ``device='cpu'``) :meth:`start` and :meth:`stop` record CUDA
    events on the current stream and :meth:`stop` waits for the second;
    on the CPU they read the host clock."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        if self.device.type == "cuda":
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self, result=None):
        """End the step (``result``, the step's output, is accepted for the
        JAX package's signature: the end event orders after its work)."""
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times)


class ThroughputMeter:
    """grid-points/s(/card) meter.

    grid_points = batch * steps * nlat * nlon processed per second,
    divided by the number of cards for the per-card figure.
    """

    def __init__(self, nlat: int, nlon: int, n_chips: int = 1):
        self.nlat = nlat
        self.nlon = nlon
        self.n_chips = n_chips

    def rate(self, batch: int, steps: int, seconds: float) -> float:
        return batch * steps * self.nlat * self.nlon / seconds

    def rate_per_chip(self, batch: int, steps: int, seconds: float) -> float:
        return self.rate(batch, steps, seconds) / self.n_chips

    def scaling_efficiency(
        self, single_chip_rate: float, n_chip_rate: float, n: int
    ) -> float:
        """Fraction of ideal linear scaling achieved at n cards."""
        return n_chip_rate / (single_chip_rate * n)

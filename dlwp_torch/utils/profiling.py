"""Profiling and throughput instrumentation (port of
``dlwp_tpu.utils.profiling``).

- :func:`trace` -- a ``torch.profiler`` context around a block that writes
  a Chrome trace (``chrome://tracing``, Perfetto, TensorBoard), the
  program's spans among its events;
- :func:`span` -- a named interval of the program's host work (a rollout
  step, a layer, a kernel wrapper, a train step's phases), recorded only
  while a ``torch.profiler`` window is open; :func:`spans` reads the
  records of a window, :func:`clear_spans` empties them;
- :class:`StepTimer` -- per-step time: CUDA events on the card, read at
  :meth:`StepTimer.stop` after the end event completes; the host clock on
  the CPU;
- :class:`ThroughputMeter` -- the grid-points/s(/card) meter.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import _profiler_enabled

from dlwp_torch.device import resolve_device

TRACE_FILE = "trace.json"
# The span records kept: the newest this many (a rollout step records
# about 20, a train step about 70).
SPAN_BUFFER = 1 << 20


class SpanRecord(NamedTuple):
    """One finished span. ``parent``: the id of the span open around it on
    the same thread (None at a thread's outermost span); ``root``: the id
    of that thread's outermost open span, shared by every span of one
    request (a ``rollout`` call, a train step). Times are
    ``time.time_ns()``, the clock of the profiler's own records."""

    id: int
    parent: int | None
    root: int
    name: str
    thread: int  # threading.get_native_id(), the profiler's thread id
    start_ns: int
    end_ns: int


# Finished spans as plain tuples (SpanRecord's fields), newest last.
_records: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_ids = itertools.count(1)
# A span's entry in the profile: the profiler's record function, in its
# fast form where this torch has it (a fraction of a microsecond, where
# ``torch.profiler.record_function`` dispatches two operators).
_annotate = getattr(torch._C._profiler, "_RecordFunctionFast",
                    torch.profiler.record_function)


class _Thread(threading.local):
    """A thread's open spans, (id, root) pairs innermost last, and its
    native id (read once: it is a system call)."""

    def __init__(self):
        self.stack = []
        self.tid = threading.get_native_id()


_thread = _Thread()


class span(contextlib.ContextDecorator):
    """``with span(name):`` or ``@span(name)``: a span of host work.

    Recorded only while a ``torch.profiler`` window is open, and then also
    entered as the profiler's record function of that name, so that a
    profile of host operations (:func:`trace`'s Chrome trace) shows it.
    Otherwise, and while ``torch.export`` or ``torch.compile`` traces, it
    does nothing but that check. A span launches no kernel, records no
    CUDA event and never synchronizes. Each thread nests its own spans:
    the layers that autograd's device thread recomputes in a backward
    start spans of that thread, not of the one that called ``backward``."""

    def __init__(self, name: str):
        self.name = name
        self._open = None

    def _recreate_cm(self):
        # As a decorator, each call gets its own span.
        return span(self.name)

    def __enter__(self):
        if _profiler_enabled() and not torch.compiler.is_compiling():
            rf = _annotate(self.name)
            start = time.time_ns()
            rf.__enter__()
            stack = _thread.stack
            sid = next(_ids)
            parent, root = stack[-1] if stack else (None, sid)
            stack.append((sid, root))
            self._open = (sid, parent, root, rf, start)
        return self

    def __exit__(self, *exc):
        if self._open is not None:
            sid, parent, root, rf, start = self._open
            self._open = None
            _thread.stack.pop()
            rf.__exit__(*exc)
            _records.append((sid, parent, root, self.name, _thread.tid,
                             start, time.time_ns()))
        return False


def spans(t0_ns: int | None = None, t1_ns: int | None = None) -> list:
    """The recorded spans (:class:`SpanRecord`) that overlap the window
    [``t0_ns``, ``t1_ns``] (either end open when None), in order of their
    start."""
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    return sorted((SpanRecord(*r) for r in list(_records)
                   if r[6] >= lo and r[5] <= hi),
                  key=lambda r: (r.start_ns, r.id))


def clear_spans() -> None:
    """Forget every recorded span."""
    _records.clear()


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

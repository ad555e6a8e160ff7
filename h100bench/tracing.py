"""One ``torch.profiler`` window, reduced to what the metrics read: the
device's busy time (the union of its operations' intervals),
kernel-launch runtime calls, device time by kernel name, and the idle gaps
labelled by what the host was doing.

On the card the profiler records CUDA activity only: the device's
operations and the host's CUDA runtime calls. Recording every host-side
PyTorch operation as well made the host-bound cells' traced windows half
again to twice as long as untraced ones, which would read as device idle
time. The window runs from the first runtime call to the end of the last
(the closing synchronize).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                "cuLaunchKernel", "cuLaunchKernelEx")
TOP = 10
# How far back the gap labelling looks for the host call around a gap.
_LOOKBACK = 256


@contextlib.contextmanager
def window(enabled: bool, device_type: str):
    """A profiler over the measured window when ``enabled`` (None inside
    otherwise): CUDA activity on the card, host operations on the CPU."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if device_type == "cuda" else \
        ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        yield prof


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    launches: int  # kernel-launch runtime calls
    device_kernels: int  # kernel records on the device
    kernels: dict  # name -> [count, seconds]
    device_ops: list  # [[name, seconds]], most time first
    idle_gaps: list  # [[host call, seconds]], most idle time first


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_busy_s(prof) -> float | None:
    """Seconds in which an operation ran on the card over a whole profile:
    the union of its CUDA operations' intervals, as :func:`summarize`
    takes it, reading the device's records alone so that a long window
    reduces in seconds. None where the profile holds none."""
    from torch._C._autograd import DeviceType

    intervals = [(e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA
                 and not e.is_user_annotation()]
    if not intervals:
        return None
    return sum(f - s for s, f in _union(intervals)) / 1e9


def summarize(prof) -> Summary:
    """Reduce a finished profile of one window."""
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        kind = e.device_type().name
        if kind == "CPU":
            host.append(e)
        elif kind == "CUDA":
            device.append(e)
    if not host:
        raise RuntimeError("the trace holds no host call")
    host.sort(key=lambda e: e.start_ns())
    t0 = host[0].start_ns()
    t1 = max(e.end_ns() for e in host)
    intervals, kernels = [], {}
    n_kernels = 0
    for e in device:
        s, f = max(e.start_ns(), t0), min(e.end_ns(), t1)
        if f <= s:
            continue
        intervals.append((s, f))
        name = e.name()
        row = kernels.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (f - s) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            n_kernels += 1
    busy = _union(intervals)
    busy_s = sum(e - s for s, e in busy) / 1e9
    launches = sum(1 for e in host if e.name() in LAUNCH_CALLS)
    # Idle gaps: between the busy intervals, and at the window's ends,
    # each labelled by the innermost host call around its start.
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    starts = [e.start_ns() for e in host]
    by_host: dict = {}
    for s, f in gaps:
        label = "between CUDA calls"
        j = bisect.bisect_right(starts, s) - 1
        for k in range(j, max(j - _LOOKBACK, -1), -1):
            if host[k].end_ns() > s:
                label = host[k].name()
                break
        by_host[label] = by_host.get(label, 0.0) + (f - s) / 1e9
    ops = sorted(([n, v[1]] for n, v in kernels.items()), key=lambda r: -r[1])
    idle = sorted(([n, v] for n, v in by_host.items()), key=lambda r: -r[1])
    return Summary(window_s=(t1 - t0) / 1e9, busy_s=busy_s, launches=launches,
                   device_kernels=n_kernels, kernels=kernels,
                   device_ops=ops[:TOP], idle_gaps=idle[:TOP])


def kernel_time(summary: Summary, fragment: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``fragment``."""
    n, s = 0, 0.0
    for name, (count, secs) in summary.kernels.items():
        if fragment in name:
            n += count
            s += secs
    return n, s

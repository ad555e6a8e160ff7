"""The program's spans in a traced run: the arithmetic of the readers that
attribute host time to them, and of ``tools/span_split.py``, which also
places the device's busy time and the launch calls of a profile on them.

``dlwp_torch.utils.profiling`` records a span (rollout step, layer,
kernel wrapper, train step and its phases) only while a profiler window
is open, on ``time.time_ns()``, the clock of the profile's own records.
A ``--trace 1`` run opens one window, so the spans the process holds when
the driver returns are that window's, and a span lies on the same time
line as the window's device intervals and launch calls
(:func:`timeline`). A program without spans gives None, and so does each
reader.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq

from h100bench import tracing

NO_SPAN = "(no span)"


@dataclasses.dataclass
class Timeline:
    """A profiled window on the profile's clock (ns), as
    :func:`h100bench.tracing.summarize` reduces it."""

    t0_ns: int  # the window's first host call's start
    t1_ns: int  # the window's last host call's end
    busy_ns: list  # the device's operations, merged: [[start, end]]
    launch_ns: list  # the launch runtime calls' starts, sorted


def timeline(prof) -> Timeline:
    """The time line of a finished profile of one window: the same host
    calls, device intervals and launch calls as ``tracing.summarize``
    reads."""
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
    t0 = min(e.start_ns() for e in host)
    t1 = max(e.end_ns() for e in host)
    busy = tracing._union(
        (max(e.start_ns(), t0), min(e.end_ns(), t1)) for e in device
        if min(e.end_ns(), t1) > max(e.start_ns(), t0))
    launch_ns = sorted(e.start_ns() for e in host
                       if e.name() in tracing.LAUNCH_CALLS)
    return Timeline(t0_ns=t0, t1_ns=t1, busy_ns=busy, launch_ns=launch_ns)


def recorded(ctx) -> list | None:
    """The spans of a traced run's window, or None where the run was not
    traced or the program records none."""
    if ctx.get("trace") is None:
        return None
    try:
        from dlwp_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def clip(record, tl: Timeline) -> tuple[int, int]:
    """A span's interval cut to the window."""
    return max(record.start_ns, tl.t0_ns), min(record.end_ns, tl.t1_ns)


def total_ns(intervals) -> int:
    return sum(e - s for s, e in intervals)


def busy_within(busy, s: int, e: int) -> int:
    """Nanoseconds of the merged ``busy`` intervals inside [s, e]."""
    i = bisect.bisect_right(busy, [s, float("inf")]) - 1
    out = 0
    for bs, be in busy[max(i, 0):]:
        if bs >= e:
            break
        out += max(0, min(be, e) - max(bs, s))
    return out


def idle_within(tl: Timeline, intervals) -> int:
    """Nanoseconds in which the device was idle inside the union of
    ``intervals``: their length less their overlap with the device's busy
    intervals."""
    return sum(e - s - busy_within(tl.busy_ns, s, e)
               for s, e in tracing._union(intervals))


def launches_within(tl: Timeline, intervals) -> int:
    """Launch runtime calls that start inside the union of
    ``intervals``."""
    starts = tl.launch_ns
    return sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
               for s, e in tracing._union(intervals))


def self_ns(records) -> dict:
    """Each span's self time by id: its duration less the union of its
    children's intervals."""
    children: dict = {}
    for r in records:
        if r.parent is not None:
            children.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    return {r.id: r.end_ns - r.start_ns - total_ns(
                tracing._union((max(s, r.start_ns), min(e, r.end_ns))
                               for s, e in children.get(r.id, ())))
            for r in records}


def idle_by_innermost(tl: Timeline, records) -> dict:
    """Device idle seconds of the window by the innermost span open at
    each instant (the open span that started last, on any thread), and
    under :data:`NO_SPAN` where none is open."""
    t0, t1 = tl.t0_ns, tl.t1_ns
    events = []  # (time, kind, record index): ends (0) before starts (1)
    for i, r in enumerate(records):
        s, e = clip(r, tl)
        if e > s:
            events += [(s, 1, i), (e, 0, i)]
    gaps, prev = [], t0
    for s, e in tl.busy_ns:
        if s > prev:
            gaps.append((prev, min(s, t1)))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    points = sorted({t for g in gaps for t in g} | {t for t, _, _ in events})
    events.sort()
    out: dict = {}
    open_heap, closed = [], set()  # by latest start: (-start, -id, index)
    k, g = 0, 0
    for a, b in zip(points, points[1:]):
        while k < len(events) and events[k][0] <= a:
            t, kind, i = events[k]
            if kind:
                heapq.heappush(open_heap, (-records[i].start_ns,
                                           -records[i].id, i))
            else:
                closed.add(i)
            k += 1
        while open_heap and open_heap[0][2] in closed:
            closed.discard(heapq.heappop(open_heap)[2])
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        if g < len(gaps) and gaps[g][0] <= a:
            name = records[open_heap[0][2]].name if open_heap else NO_SPAN
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def host_ms_per_step(ctx, name: str):
    """The readers' number (``h100bench/metrics/``): milliseconds of the
    window inside spans called ``name`` per rollout or train step
    (``units.steps``), or None where the run holds no such span."""
    records, steps = recorded(ctx), ctx["units"].get("steps")
    if not records or not steps:
        return None
    found = [(r.start_ns, r.end_ns) for r in records if r.name == name]
    if not found:
        return None
    return total_ns(found) / 1e6 / steps

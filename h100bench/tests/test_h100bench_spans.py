"""The readers of the program's spans.

On the CPU: a profile's time line (``spans.timeline``) agrees with the
trace summary's totals, the span arithmetic (self time, idle time and
launches inside spans, idle time by innermost span) on hand-made time
lines, tiny forecast and train cells run with ``--trace 1`` through the
harness, reporting every span metric, finite, with one ``rollout.step``
span a model step and one ``train.step`` span a traced train step, and
``tools/span_split.py`` splits their windows by span.

On the card (``-m cuda``): the spans' clock is the profile's. Spans
around ``torch.cuda.synchronize()`` and around single launches hold the
profile's records of the CUDA calls they made, a launch's to within
50 us at each end (median), in a CUDA-only window as ``tracing.window`` opens it;
the recompute of a
checkpointed model, run by autograd's device thread, records its spans
there.

    python -m pytest h100bench/tests/test_h100bench_spans.py -q
    python -m pytest --noconftest -m cuda h100bench/tests/test_h100bench_spans.py
"""

from __future__ import annotations

import json
import math
import random
import statistics
import textwrap
from types import SimpleNamespace

import pytest

from h100bench import spans, tracing
from h100bench.tests import tiny

SPAN_METRICS = {
    "forecast": ("dispatch_host_ms_per_step.forecast",),
    "train": ("dispatch_host_ms_per_step.train",
              "optimizer_host_ms_per_step.train"),
}


class _Event:
    def __init__(self, kind, name, start, end, annotation=False):
        self._kind = SimpleNamespace(name=kind)
        self._name, self._start, self._end = name, start, end
        self._annotation = annotation

    def device_type(self):
        return self._kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def is_user_annotation(self):
        return self._annotation


def _profile(events):
    results = SimpleNamespace(events=lambda: list(events))
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _time_line(seed):
    """Host runtime calls (launches among them) and device operations,
    overlapping at random, as a profile of one window holds them."""
    rng = random.Random(seed)
    events, t = [], 1_000_000
    for _ in range(rng.randint(5, 60)):
        t += rng.randint(0, 5000)
        name = rng.choice(tracing.LAUNCH_CALLS + ("cudaMemcpyAsync",
                                                   "cudaStreamSynchronize"))
        end = t + rng.randint(1, 3000)
        events.append(_Event("CPU", name, t, end))
        if rng.random() < 0.8:
            s = t + rng.randint(-2000, 8000)
            events.append(_Event("CUDA", f"k{rng.randint(0, 4)}", s,
                                 s + rng.randint(1, 9000)))
        if rng.random() < 0.2:
            events.append(_Event("CUDA", "annotation", t, end + 50,
                                 annotation=True))
    rng.shuffle(events)
    return events


@pytest.mark.parametrize("seed", range(6))
def test_time_line_agrees_with_the_summary(seed):
    prof = _profile(_time_line(seed))
    s, tl = tracing.summarize(prof), spans.timeline(prof)
    assert (tl.t1_ns - tl.t0_ns) / 1e9 == pytest.approx(s.window_s,
                                                        abs=1e-12)
    assert spans.total_ns(tl.busy_ns) / 1e9 == pytest.approx(s.busy_s,
                                                             abs=1e-12)
    assert len(tl.launch_ns) == s.launches
    assert tl.launch_ns == sorted(tl.launch_ns)
    assert all(tl.t0_ns <= t <= tl.t1_ns for t in tl.launch_ns)
    flat = [x for iv in tl.busy_ns for x in iv]
    assert flat == sorted(flat) and len(set(flat)) == len(flat)
    assert tl.t0_ns <= flat[0] and flat[-1] <= tl.t1_ns if flat else True
    # The idle time by innermost span covers the summary's idle time.
    idle = spans.idle_by_innermost(tl, [])
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s,
                                               abs=1e-12)


def _rec(id, parent, root, name, start, end, thread=1):
    return SimpleNamespace(id=id, parent=parent, root=root, name=name,
                           thread=thread, start_ns=start, end_ns=end)


def test_span_arithmetic_on_a_hand_made_time_line():
    # Window 0-100; the device busy 10-20 and 50-80; launches at 5, 12,
    # 30, 55 and 95.
    s = spans.Timeline(t0_ns=0, t1_ns=100, busy_ns=[[10, 20], [50, 80]],
                       launch_ns=[5, 12, 30, 55, 95])
    recs = [_rec(1, None, 1, "step", 0, 60), _rec(2, 1, 1, "model", 5, 40),
            _rec(3, 2, 1, "layer", 8, 15), _rec(4, 2, 1, "layer", 25, 35),
            _rec(5, 1, 1, "next", 45, 60), _rec(6, None, 6, "step", 60, 120),
            _rec(7, None, 7, "recompute", 30, 38, thread=2)]
    assert spans.self_ns(recs) == {1: 60 - 35 - 15, 2: 35 - 7 - 10, 3: 7,
                                   4: 10, 5: 15, 6: 60, 7: 8}
    steps = [spans.clip(r, s) for r in recs if r.name == "step"]
    assert steps == [(0, 60), (60, 100)]
    # Idle inside the steps: 100 less the 40 busy.
    assert spans.idle_within(s, steps) == 60
    assert spans.idle_within(s, [(15, 55)]) == 30
    assert spans.launches_within(s, steps) == 5
    assert spans.launches_within(s, [(12, 30), (29, 56)]) == 3
    idle = spans.idle_by_innermost(s, recs)
    # 0-5 step, 5-8 model, 8-10 layer; 20-25 model, 25-30 layer,
    # 30-35 recompute (started last), 35-38 recompute, 38-40 model,
    # 40-45 step, 45-50 next, 80-100 step.
    assert idle == pytest.approx({"step": (5 + 5 + 20) / 1e9,
                                  "model": (3 + 5 + 2) / 1e9,
                                  "layer": (2 + 5) / 1e9,
                                  "recompute": 8 / 1e9,
                                  "next": 5 / 1e9})
    assert math.isclose(sum(idle.values()), 60 / 1e9)
    assert spans.idle_by_innermost(s, [])[spans.NO_SPAN] == \
        pytest.approx(60 / 1e9)


def test_readers_give_nothing_without_spans():
    from dlwp_torch.utils import profiling

    profiling.clear_spans()
    ctx = {"trace": SimpleNamespace(), "units": {"steps": 4}}
    assert spans.recorded(ctx) == []
    assert spans.host_ms_per_step(ctx, "rollout.step") is None
    untraced = {"trace": None, "units": {"steps": 4}}
    assert spans.recorded(untraced) is None
    assert spans.host_ms_per_step(untraced, "rollout.step") is None


RUNNER = textwrap.dedent("""
    import collections, importlib, json
    import torch
    from h100bench import harness
    from dlwp_torch.utils import profiling
    cell = harness.load_cell({cell!r})
    driver = importlib.import_module(
        "h100bench.drivers." + cell.traffic["driver"])
    run_driver, box = driver.run, {{}}

    def spy(run):
        box["out"] = run_driver(run)
        return box["out"]

    driver.run = spy
    run = harness.Run(cell=cell, seed={seed}, seconds=0.3, trace=True,
                      device=torch.device("cpu"))
    result = harness.run_cell(run, harness.now())
    out = box["out"]
    names = collections.Counter(r.name for r in profiling.spans())
    result["span_counts"] = dict(names)
    result["unit_steps"] = out.units["steps"]
    print(json.dumps(result))
""")


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("cell,kind,step", [
    ("flagship_tiny.forecast_tiny", "forecast", "rollout.step"),
    ("tower_tiny.forecast_tiny", "forecast", "rollout.step"),
    ("flagship_tiny.train_tiny", "train", "train.step"),
])
def test_tiny_cells_report_every_span_metric(copy_root, cell, kind, step,
                                             monkeypatch):
    monkeypatch.setattr(tiny, "RUNNER", RUNNER)
    result = tiny.run(copy_root, cell, seed=3100000007)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    for name in SPAN_METRICS[kind]:
        assert name in m and math.isfinite(m[name]), name
    assert result["span_counts"][step] == result["unit_steps"] > 0
    assert m[f"dispatch_host_ms_per_step.{kind}"] > 0
    if kind == "train":
        counts = result["span_counts"]
        for phase in ("train.forward", "train.backward", "train.optimizer",
                      "fit.gather"):
            assert counts[phase] == result["unit_steps"], phase
        assert m["optimizer_host_ms_per_step.train"] < \
            m["dispatch_host_ms_per_step.train"]
    else:
        counts = result["span_counts"]
        assert counts["rollout.model"] == counts["rollout.step"]


def test_a_program_without_spans_reports_the_rest(copy_root, monkeypatch):
    """The benchmark over a program that records no span (an older
    checkout): the span metrics are left out and nothing raises."""
    monkeypatch.setattr(tiny, "RUNNER", RUNNER.replace(
        "from dlwp_torch.utils import profiling\n",
        "from dlwp_torch.utils import profiling\n"
        "spans_of = profiling.spans\n"
        "del profiling.spans\n").replace("profiling.spans(", "spans_of("))
    result = tiny.run(copy_root, "flagship_tiny.forecast_tiny", seed=11)
    assert result["correct"], result["checks"]
    assert "device_idle_pct.forecast" in result["metrics"]
    assert not set(SPAN_METRICS["forecast"]) & set(result["metrics"])


SPLIT = textwrap.dedent("""
    import json
    import torch
    from h100bench.tools.span_split import measure
    print(json.dumps(measure({cell!r}, {seed}, 0.3, torch.device("cpu"))))
""")


@pytest.mark.parametrize("cell,step", [
    ("flagship_tiny.forecast_tiny", "rollout.step"),
    ("flagship_tiny.train_tiny", "train.step"),
])
def test_span_split_places_the_window_on_the_spans(copy_root, cell, step,
                                                   monkeypatch):
    monkeypatch.setattr(tiny, "RUNNER", SPLIT)
    out = tiny.run(copy_root, cell, seed=3100000011)
    assert out["correct"] and out["step"] == step
    assert out["span_counts"][step] == out["steps"] > 0
    # On the CPU the profile holds no device operation: all idle.
    assert out["device_idle_pct"] == pytest.approx(100.0)
    assert 0 < out["dispatch_idle_pct"] <= out["device_idle_pct"]
    assert sum(out["idle_share_by_innermost"].values()) == pytest.approx(1)
    assert out["self_ms_per_step"][step] >= 0
    kind = "train" if step == "train.step" else "forecast"
    for name in SPAN_METRICS[kind]:
        assert math.isfinite(out["metrics"][name]), name
    if kind == "train":
        assert out["optimizer_launches_per_step"] == 0  # no CUDA calls
        assert out["span_counts"]["train.optimizer"] == out["steps"]


def _calls_inside(prof, records):
    """For each span record, the profile's host CUDA calls that overlap
    it, as [start, end, name] relative to the span's start."""
    calls = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type().name == "CPU"
                   and not e.is_user_annotation())
    return [[[s - r.start_ns, e - r.start_ns, n] for s, e, n in calls
             if e > r.start_ns and s < r.end_ns] for r in records]


@pytest.mark.cuda
def test_span_clock_is_the_profiles_on_the_card():
    """Spans around ``torch.cuda.synchronize()`` (after queued products)
    and around single kernel launches hold the profile's records of the
    CUDA calls they made, and a launch's record lies, in the median,
    within 50 us of its span's ends. A clock offset would push a record
    out of its span at one end, so the two clocks agree to within the
    gaps measured."""
    import torch

    from dlwp_torch.utils import profiling

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.randn(4096, 4096, device="cuda")
    b = torch.zeros(1, device="cuda")
    (a @ a).sum().item()
    profiling.clear_spans()
    with tracing.window(True, "cuda") as prof:
        for _ in range(5):
            for _ in range(8):
                a = torch.tanh(a @ a)
            with profiling.span("sync"):
                torch.cuda.synchronize()
            for _ in range(4):
                with profiling.span("launch"):
                    b.add_(1.0)
    got = profiling.spans()
    syncs = [r for r in got if r.name == "sync"]
    launches = [r for r in got if r.name == "launch"]
    sync_calls = _calls_inside(prof, syncs)
    launch_calls = _calls_inside(prof, launches)
    print(json.dumps({"sync": [[r.end_ns - r.start_ns, c] for r, c in
                               zip(syncs, sync_calls)],
                      "launch": [[r.end_ns - r.start_ns, c] for r, c in
                                 zip(launches, launch_calls)]}))
    assert len(syncs) == 5 and len(launches) == 20
    for r, calls in zip(syncs + launches, sync_calls + launch_calls):
        length = r.end_ns - r.start_ns
        assert calls and all(0 <= s and e <= length for s, e, _ in calls)
    for calls in sync_calls:  # each waited for the products
        assert any(n == "cudaDeviceSynchronize" and e - s > 100_000
                   for s, e, n in calls)
    # The launch's record, not the module loading the first one triggers.
    gaps = [[(s, r.end_ns - r.start_ns - e) for s, e, n in calls
             if n in tracing.LAUNCH_CALLS] for r, calls in
            zip(launches, launch_calls)]
    assert all(len(g) == 1 for g in gaps)
    # A launch right after a synchronize waits on the profiler's own work;
    # the typical one lies within 50 us of its span at each end.
    assert statistics.median(g[0][0] for g in gaps) <= 50_000
    assert statistics.median(g[0][1] for g in gaps) <= 50_000


@pytest.mark.cuda
def test_recompute_spans_on_autograds_device_thread():
    import threading

    import torch
    from torch.utils.checkpoint import checkpoint

    from dlwp_torch import build_sequential
    from dlwp_torch.utils import profiling

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = build_sequential(
        [("CyclicConv2D", (8, 3), {"activation": "tanh"}),
         ("CyclicConv2D", (4, 3), {"dilation": 2})], device="cuda")
    x = torch.randn(4, 6, 36, 144, device="cuda")
    model.init(x)
    for p in model.parameters():
        p.requires_grad_(True)
    profiling.clear_spans()
    main = threading.get_native_id()
    with tracing.window(True, "cuda"):
        with profiling.span("outer"):
            checkpoint(model, x, use_reentrant=False).square().sum() \
                .backward()
            with profiling.span("after"):
                pass
        torch.cuda.synchronize()
    got = profiling.spans()
    outer = next(r for r in got if r.name == "outer")
    after = next(r for r in got if r.name == "after")
    layers = [r for r in got if r.name == "layer.CyclicConv2D"]
    again = [r for r in layers if r.thread != main]
    assert len(layers) == 4 and len(again) == 2
    assert all(r.parent is None and r.root == r.id for r in again)
    assert after.parent == outer.id

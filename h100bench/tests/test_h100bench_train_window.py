"""The training cell's window: the card's busy time over a whole profile,
and a profiled run's per-layer numbers beside the unprofiled rate."""

from __future__ import annotations

import types

import pytest
from torch._C._autograd import DeviceType

from h100bench import tracing
from h100bench.tests import tiny


def _event(device, start, end, annotation=False):
    return types.SimpleNamespace(device_type=lambda: device,
                                 start_ns=lambda: start, end_ns=lambda: end,
                                 is_user_annotation=lambda: annotation)


def _profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_device_busy_is_the_union_of_device_intervals():
    prof = _profile([
        _event(DeviceType.CPU, 0, 10_000_000_000),  # host calls: not busy
        _event(DeviceType.CUDA, 1_000_000_000, 3_000_000_000),
        _event(DeviceType.CUDA, 2_000_000_000, 4_000_000_000),  # overlaps
        _event(DeviceType.CUDA, 6_000_000_000, 6_500_000_000),
        _event(DeviceType.CUDA, 0, 9_000_000_000, annotation=True),
    ])
    assert tracing.device_busy_s(prof) == pytest.approx(3.5)


def test_a_profile_without_device_records_reads_nothing():
    assert tracing.device_busy_s(
        _profile([_event(DeviceType.CPU, 0, 5)])) is None


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("window"))


@pytest.mark.parametrize("trace", [False, True])
def test_train_window_metrics(copy_root, trace):
    result = tiny.run(copy_root, "flagship_tiny.train_tiny", trace=trace)
    assert result["correct"], result["checks"]
    notes, metrics = result["notes"], result["metrics"]
    assert notes["epochs"] == len(notes["epoch_s"]) >= 1
    assert notes["window_s"] == pytest.approx(sum(notes["epoch_s"]))
    if not trace:
        # No card: nothing recorded the device, so only set-up reads.
        assert set(metrics) == {"setup_s"}
        assert not notes["window_profiled"]
        return
    rate = metrics["samples_per_s.train"]["value"]
    assert rate == pytest.approx(notes["window_samples_per_s"])
    assert {"device_idle_pct.train", "mfu_pct.train"} <= set(metrics)
    # The window's steps, then the profiled epoch's.
    per_epoch = notes["steps_an_epoch"]
    assert result["attempted"] == per_epoch * (notes["epochs"] + 1)

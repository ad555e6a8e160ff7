"""Closed-loop forecasts on the cubed sphere: one caller runs
``TimeSeriesEstimator.rollout_fn(steps)`` back to back, each call ending
in a device synchronize, as :mod:`h100bench.drivers.forecast` does on the
lat-lon grid, with the same traffic keys and the same check.

The configuration's ``grid`` is a cube (``face_size`` n): fields are
``(C, 6 n, n)``, the six faces stacked along the rows, the layout the
program's samplers and estimator carry, with 2-D latitudes and longitudes
from ``dlwp_torch.grid.cubed_sphere``. Grid points a forecast step: 6 n n.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench import counts, cube_counts, harness, inputs, tracing
from h100bench.drivers.forecast import compare
from h100bench.reference import load as load_reference


def make_series(cfg: dict, n: int, gen: torch.Generator, device, ref):
    """A standard normal series ``(n, C, 6 f, f)`` float32 of the
    configuration's channels, 6-hourly from the generator's start, its
    insolation ``(n, 6 f, f)`` float32 and its days-of-year ``(n,)``
    float64 (the reference's insolation at the reference's cells)."""
    f = cfg["grid"]["face_size"]
    C = len(cfg["channels"])
    series = torch.randn((n, C, 6 * f, f), generator=gen, device=device)
    days = torch.as_tensor(ref.day_of_year(inputs.series_times(n)),
                           device=device)
    sol = ref.insolation(days, *ref.lat_lon(f)).to(torch.float32)
    return series, sol, days


def build(run: harness.Run, weights: dict):
    """The program's forecast path: a ``DLWPNeuralNet`` of the
    configuration's layers with the benchmark's weights, and the estimator
    over a sampler of the cube's folded grid and the channels."""
    from dlwp_torch.data import PredictorDataset, SeriesSampler
    from dlwp_torch.forecast import TimeSeriesEstimator
    from dlwp_torch.grid.cubed_sphere import folded_lat_lon
    from dlwp_torch.models import DLWPNeuralNet

    cfg = run.cfg
    f = cfg["grid"]["face_size"]
    T = cfg["input_time_steps"]
    net = DLWPNeuralNet(is_convolutional=True, is_recurrent=False,
                        time_dim=T, scaler_type=None, device=run.device)
    net.build_model([(name, args, kw) for name, args, kw in cfg["layers"]])
    inputs.load_into(net.base_model, weights)
    lat, lon = folded_lat_lon(f)
    n = 2 * T + 4
    ds = PredictorDataset(
        predictors=np.zeros((n, len(cfg["channels"]), 6 * f, f), np.float32),
        sample=inputs.series_times(n), varlev=list(cfg["channels"]),
        lat=lat, lon=lon)
    sampler = SeriesSampler(ds, model=net, input_time_steps=T,
                            output_time_steps=cfg["output_time_steps"],
                            add_insolation=cfg["insolation"],
                            batch_size=run.traffic["batch"])
    return TimeSeriesEstimator(net, sampler)


def run(run: harness.Run) -> harness.Outcome:
    from dlwp_torch import kernels

    cfg, t, dev = run.cfg, run.traffic, run.device
    stamps = {"driver": harness.now()}
    f = cfg["grid"]["face_size"]
    T = cfg["input_time_steps"]
    B, steps = t["batch"], t["steps"]
    ref = load_reference(cfg["reference"])
    s_weights, s_series, s_draws, s_picks = run.seeds(4)
    weights = inputs.make_weights(cfg, inputs.generator(s_weights, dev), dev)
    series, sol, days = make_series(
        cfg, t["series_samples"], inputs.generator(s_series, dev), dev, ref)
    starts = torch.randint(0, t["series_samples"] - T + 1, (t["draws"], B),
                           generator=inputs.generator(s_draws, dev),
                           device=dev)
    offsets = torch.arange(T, device=dev)
    picks = set(np.random.default_rng(s_picks).choice(
        t["check"]["first"], t["check"]["picks"], replace=False).tolist())
    run.sync()
    stamps["inputs"] = harness.now()
    est = build(run, weights)
    rollout = est.rollout_fn(steps)
    mean_state = torch.zeros((len(cfg["channels"]) + 1, 6 * f, f),
                             device=dev)  # no channel is imputed

    def forecast_inputs(i):
        s = starts[i % len(starts)]
        return (inputs.window(series, sol, s[:, None] + offsets),
                days.index_select(0, s + T - 1))

    stamps["program"] = harness.now()
    for i in range(t["warmup"]):
        rollout(*forecast_inputs(i), mean_state)
    run.sync()
    stamps["warmup"] = harness.now()

    seconds = min(run.seconds, t["trace_seconds"]) if run.trace else run.seconds
    kernels.reset_launch_counts()
    kept, latency = {}, []
    t0 = harness.now()
    with run.window() as prof:
        i = 0
        while True:
            x, d = forecast_inputs(t["warmup"] + i)
            ts = harness.now()
            preds = rollout(x, d, mean_state)
            run.sync()
            te = harness.now()
            latency.append(te - ts)
            if i in picks:
                kept[i] = (x, d, preds)
            i += 1
            if te - t0 >= seconds:
                break
        kept[i - 1] = (x, d, preds)
    elapsed = te - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = tracing.summarize(prof) if prof is not None else None
    del rollout, est, preds
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    answers, control = [], ([] if run.control else None)
    for k in sorted(kept):
        x, d, p = kept[k]
        got, ctl = compare(run, ref, weights, x, d, p, run.control == "tf32")
        answers.append(got)
        if ctl is not None:
            control.append(ctl)

    n = len(latency)
    pads = cube_counts.pad_launches(cfg)
    units = {
        "steps": n * steps,
        "flops_per_step": counts.forward_flops(cfg) * B,
        "cube_pad_per_step": len(pads),
        "cube_pad_bound_s_per_step": sum(
            cube_counts.pad_bytes(c, m, 1, B) / counts.PEAK_BYTES
            for c, m in pads),
    }
    e2e = {
        "forecast_mgp_per_s": B * steps * 6 * f * f * n / elapsed / 1e6,
        "forecast_p95_ms": float(np.percentile(latency, 95)) * 1e3,
    }
    notes = {"forecasts": n, "window_s": elapsed, "kept": sorted(kept),
             "stamps": stamps,
             "launch_counts": {k: v for k, v in launches.items() if v}}
    if summary is not None:
        notes["trace"] = {"launch_calls": summary.launches,
                          "device_kernels": summary.device_kernels}
    return harness.Outcome(
        setup_end=t0, attempted=n, end_to_end=e2e, units=units,
        answers=answers, memory_peak_bytes=peak, summary=summary,
        control=control, notes=notes)

"""Closed-loop forecasts: one caller runs ``TimeSeriesEstimator.rollout_fn
(steps)`` back to back, each call ending in a device synchronize.

Traffic keys: ``batch`` (init times a forecast), ``steps`` (model
applications a forecast), ``series_samples`` (6-hourly samples of the
seeded series the init times are drawn from), ``draws`` (init-time draws
made ahead, cycled), ``warmup`` (forecasts before the window),
``trace_seconds`` (the traced window), and ``check``: ``first`` and
``picks`` (that many forecasts among the window's first ``first`` are
kept, drawn from the seed, and the window's last one) and ``block`` (the
reference's batch block).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench import counts, harness, inputs, specs, tracing
from h100bench.reference import load as load_reference


def build(run: harness.Run, weights: dict):
    """The program's forecast path for the configuration: a
    ``DLWPNeuralNet`` with the benchmark's weights and the estimator over a
    sampler of the configuration's grid and channels."""
    from dlwp_torch.data import PredictorDataset, SeriesSampler
    from dlwp_torch.forecast import TimeSeriesEstimator
    from dlwp_torch.models import DLWPNeuralNet

    cfg = run.cfg
    g = specs.grid(cfg)
    T = cfg["input_time_steps"]
    net = DLWPNeuralNet(is_convolutional=True,
                        is_recurrent=cfg["is_recurrent"], time_dim=T,
                        scaler_type=None, device=run.device)
    net.build_model(specs.layers(cfg))
    inputs.load_into(net.base_model, weights)
    # The estimator reads only the sampler's layout (times, channels,
    # grid): a few samples of zeros carry it.
    n = 2 * T + 4
    ds = PredictorDataset(
        predictors=np.zeros((n, len(cfg["channels"]), g.nlat, g.nlon),
                            np.float32),
        sample=inputs.series_times(n), varlev=list(cfg["channels"]),
        lat=np.asarray(g.lat()), lon=np.asarray(g.lon()))
    sampler = SeriesSampler(ds, model=net, input_time_steps=T,
                            output_time_steps=cfg["output_time_steps"],
                            add_insolation=cfg["insolation"],
                            batch_size=run.traffic["batch"])
    return TimeSeriesEstimator(net, sampler)


class Gap:
    """Accumulates a forecast's differences from the reference, step by
    step, in float64 on the device."""

    def __init__(self, device):
        z = lambda: torch.zeros((), dtype=torch.float64, device=device)  # noqa: E731
        self.s1_max, self.s1_sq, self.s1_n = z(), z(), 0
        self.max, self.diff_sq, self.ref_sq, self.n = z(), z(), z(), 0

    def add(self, step: int, got: torch.Tensor, ref: torch.Tensor) -> None:
        d = (got.to(torch.float64) - ref.to(torch.float64))
        r2 = ref.to(torch.float64).square().sum()
        dmax = d.abs().max()
        if step == 0:
            self.s1_max = torch.maximum(self.s1_max, dmax)
            self.s1_sq += r2
            self.s1_n += ref.numel()
        self.max = torch.maximum(self.max, dmax)
        self.diff_sq += d.square().sum()
        self.ref_sq += r2
        self.n += ref.numel()

    def numbers(self) -> dict:
        rms1 = math.sqrt(float(self.s1_sq) / self.s1_n)
        rms = math.sqrt(float(self.ref_sq) / self.n)
        return {"step1_gap": float(self.s1_max) / rms1,
                "max_gap": float(self.max) / rms,
                "rrms": math.sqrt(float(self.diff_sq) / float(self.ref_sq))}


def compare(run, ref, weights, x, days, preds, control: bool):
    """The program's forecast ``preds`` (steps, B, T, C, H, W) against the
    reference from the same inputs, in batch blocks; with ``control`` also
    the reference in TF32 against the reference. Returns (numbers, control
    numbers or None)."""
    steps, B = preds.shape[:2]
    block = run.traffic["check"]["block"]
    got, ctl = Gap(x.device), Gap(x.device) if control else None
    with torch.no_grad():
        for b0 in range(0, B, block):
            sl = slice(b0, b0 + block)
            exact = ref.rollout(weights, run.cfg, x[sl], days[sl], steps)
            low = (ref.rollout(weights, run.cfg, x[sl], days[sl], steps)
                   if control else None)
            for it in range(steps):
                with ref.precision(False):
                    r = next(exact)
                got.add(it, preds[it, sl], r)
                if control:
                    with ref.precision(True):
                        c = next(low)
                    ctl.add(it, c, r)
    return got.numbers(), (ctl.numbers() if control else None)


def run(run: harness.Run) -> harness.Outcome:
    from dlwp_torch import kernels

    cfg, t, dev = run.cfg, run.traffic, run.device
    stamps = {"driver": harness.now()}
    g = specs.grid(cfg)
    T = cfg["input_time_steps"]
    B, steps = t["batch"], t["steps"]
    s_weights, s_series, s_draws, s_picks = run.seeds(4)
    weights = inputs.make_weights(cfg, inputs.generator(s_weights, dev), dev)
    series, sol, days = inputs.make_series(
        cfg, t["series_samples"], inputs.generator(s_series, dev), dev)
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
    mean_state = torch.zeros((len(cfg["channels"]) + 1, g.nlat, g.nlon),
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

    ref = load_reference(cfg["reference"])
    answers, control = [], ([] if run.control else None)
    for k in sorted(kept):
        x, d, p = kept[k]
        got, ctl = compare(run, ref, weights, x, d, p, run.control == "tf32")
        answers.append(got)
        if ctl is not None:
            control.append(ctl)

    n = len(latency)
    stages = counts.conv_pool_stages(cfg)
    gates = counts.gate_layers(cfg)
    units = {
        "steps": n * steps,
        "flops_per_step": counts.forward_flops(cfg) * B,
        "conv_pool_per_step": len(stages),
        "conv_pool_bound_s_per_step": sum(
            counts.bound_s(*counts.conv_pool_cost(s, B)) for s in stages),
        "gates_per_step": counts.gate_launches_per_step(cfg),
        "gates_bound_s_per_step": sum(
            (s.in_shape[0] - 1) * counts.bound_s(*counts.gate_cost(s, B))
            for s in gates),
    }
    e2e = {
        "forecast_mgp_per_s": B * steps * g.nlat * g.nlon * n / elapsed / 1e6,
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

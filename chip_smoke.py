#!/usr/bin/env python3
"""Smoke run of the dlwp_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each raising on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build of every kernel in ``dlwp_torch/csrc`` (``nvcc``, in parallel);
3. each kernel against its plain PyTorch version on the card, at the
   flagship shapes and on an odd case;
4. the golden ConvLSTM flagship rollout of ``tests/fixtures/golden.npz``
   (8x16 grid, 3 steps) reproduced in fp32 through the kernels;
5. the main path at full width: synthetic 36x144 dataset -> SeriesSampler
   (+insolation) -> DLWPNeuralNet(ConvLSTM flagship, random weights from a
   seed) -> TimeSeriesEstimator.predict(32) at B=64, with fp32 and bf16
   gates; launch counts prove the kernels ran, and 4 samples are held
   against the same predict on the CPU (plain versions);
6. timings with CUDA events (median of repeats after warm-up): each kernel
   and its plain version, and the rollout rate in grid points per second
   (B * steps * 36 * 144 / elapsed);
7. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth. Bounds are stated against these.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

B, STEPS, NLAT, NLON, C, TD = 64, 32, 36, 144, 2, 2
TOL_F32 = 1e-5  # kernel vs plain, fp32: only the summation order differs
TOL_BF16 = 5e-2  # bf16 gates: one bf16 rounding step near 1.0 is 7.8e-3
TOL_GOLDEN = 1e-4  # fp32 through 3 steps vs the float64 golden values
# Main path vs the CPU run (plain versions, same weights). Step 1 differs
# only by fp32 summation order (cuDNN vs CPU convs), so it is held tightly;
# over 32 autoregressive steps those differences compound, so the
# trajectory is held by relative RMS.
TOL_STEP1 = {"fp32": 1e-4, "bf16": 5e-2}
TOL_TRAJ_RRMS = {"fp32": 1e-3, "bf16": 5e-2}


def log(*a):
    print(*a, flush=True)


def timed_ms(fn, reps=5, inner=10, warmup=2):
    """Median over ``reps`` of the mean per-call ms of ``inner`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernels(torch, dev):
    from dlwp_torch.kernels import (
        fused_conv_pool, fused_conv_pool_plain, lstm_gates, lstm_gates_plain,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"fused_conv_pool": 0.0, "lstm_gates": 0.0}
    timing = {"fused_conv_pool": [], "lstm_gates": []}
    # (B, C, H, W, O, dilation): flagship stages 1 and 2, then an odd case.
    for shape, flagship in [((B, 24, NLAT, NLON, 32, 2), True),
                            ((B, 32, NLAT // 2, NLON // 2, 64, 1), True),
                            ((3, 5, 10, 18, 7, 3), False)]:
        b, c, h, w, o, d = shape
        x = torch.randn(b, c, h, w, device=dev, generator=g)
        k = torch.randn(o, c, 3, 3, device=dev, generator=g) / (9 * c) ** 0.5
        bias = 0.1 * torch.randn(o, device=dev, generator=g)
        y = fused_conv_pool(x, k, bias, d)
        torch.cuda.synchronize()
        err = (y - fused_conv_pool_plain(x, k, bias, d)).abs().max().item()
        log(f"check fused_conv_pool {shape}: max|kernel-plain| = {err:.3e}")
        if not err <= TOL_F32:
            raise AssertionError(f"fused_conv_pool {shape}: {err} > {TOL_F32}")
        errs["fused_conv_pool"] = max(errs["fused_conv_pool"], err)
        if flagship:
            nbytes = 4 * (x.numel() + k.numel() + o + y.numel())
            flops = 2 * b * o * h * w * c * 9
            timing["fused_conv_pool"].append(dict(
                shape=list(shape),
                ms=timed_ms(lambda: fused_conv_pool(x, k, bias, d)),
                plain_ms=timed_ms(lambda: fused_conv_pool_plain(x, k, bias, d)),
                bytes=nbytes, flops=flops,
            ))
    # (B, F, H, W): the flagship ConvLSTM (F=12 at 36x144), then odd.
    for shape, flagship in [((B, 12, NLAT, NLON), True),
                            ((3, 5, 7, 9), False)]:
        b, f, h, w = shape
        zx = torch.randn(b, 4 * f, h, w, device=dev, generator=g)
        zh = torch.randn(b, 4 * f, h, w, device=dev, generator=g)
        cc = torch.randn(b, f, h, w, device=dev, generator=g)
        for ra in ("hard_sigmoid", "sigmoid"):
            for gd in (None, "bfloat16"):
                h1, c1 = lstm_gates(zx, zh, cc, "tanh", ra, gd)
                torch.cuda.synchronize()
                h2, c2 = lstm_gates_plain(zx, zh, cc, "tanh", ra, gd)
                err = max((h1 - h2).abs().max().item(),
                          (c1 - c2).abs().max().item())
                tol = TOL_F32 if gd is None else TOL_BF16
                log(f"check lstm_gates {shape} {ra} {gd}: "
                    f"max|kernel-plain| = {err:.3e}")
                if not err <= tol:
                    raise AssertionError(f"lstm_gates {shape} {ra} {gd}: {err}")
                errs["lstm_gates"] = max(errs["lstm_gates"], err)
                if flagship and ra == "hard_sigmoid":
                    n = cc.numel()
                    timing["lstm_gates"].append(dict(
                        shape=list(shape), gate_dtype=gd,
                        ms=timed_ms(lambda: lstm_gates(zx, zh, cc, "tanh", ra, gd)),
                        plain_ms=timed_ms(
                            lambda: lstm_gates_plain(zx, zh, cc, "tanh", ra, gd)),
                        bytes=4 * (2 * zx.numel() + 3 * n),
                        flops=30 * n,  # adds, products, 5 activations
                    ))
    return errs, timing


def check_golden(torch, dev, root):
    from dlwp_torch import build_sequential, load_flax_params, tree_from_leaves
    from dlwp_torch.flagship import convlstm_specs
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    data = np.load(os.path.join(root, "tests", "fixtures", "golden.npz"))
    model = build_sequential(convlstm_specs(8, 16), device=dev)
    leaves = [data[f"convlstm_param_{i}"] for i in range(15)]
    load_flax_params(model, tree_from_leaves(model, leaves))
    x = torch.as_tensor(data["convlstm_x0"], dtype=torch.float32, device=dev)
    reset_launch_counts()
    with torch.inference_mode():
        for _ in range(3):
            pred = model(x)
            x = torch.cat([pred, x[:, :, 2:3]], dim=2)
    counts = launch_counts()
    err = np.abs(x.cpu().numpy() - data["convlstm_roll3"]).max()
    log(f"golden convlstm_roll3 (fp32 through kernels, {counts}): "
        f"max abs err {err:.3e}")
    if counts != {"fused_conv_pool": 6, "lstm_gates": 3}:
        raise AssertionError(f"golden run did not use the kernels: {counts}")
    if not err <= TOL_GOLDEN:
        raise AssertionError(f"golden: {err} > {TOL_GOLDEN}")


def flagship_stack(device, seed=0):
    """Synthetic dataset -> model -> sampler, as a user builds it."""
    from dlwp_torch import DLWPNeuralNet, PredictorDataset, SeriesSampler
    from dlwp_torch.flagship import convlstm_specs

    n = B + 2 * TD + 2
    data = PredictorDataset(
        predictors=np.random.RandomState(seed)
        .randn(n, C, NLAT, NLON).astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, NLAT),
        lon=np.arange(NLON) * (360.0 / NLON),
        mean=np.zeros(C, np.float32),
        std=np.ones(C, np.float32),
    )
    dlwp = DLWPNeuralNet(time_dim=TD, scaler_type=None, is_recurrent=True,
                         device=device)
    dlwp.build_model(convlstm_specs(NLAT, NLON, C, TD))
    sampler = SeriesSampler(data, model=dlwp, input_time_steps=TD,
                            output_time_steps=TD, batch_size=B,
                            add_insolation=True)
    return dlwp, sampler


def run_main_path(torch, dev):
    from dlwp_torch import TimeSeriesEstimator
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    dlwp, sampler = flagship_stack(dev)
    x_sample, _ = sampler.generate(np.arange(1))
    dlwp.init(x_sample, seed=0)
    tree = {"params": {
        f"layers_{i}": {k: p.detach().cpu().numpy()
                        for k, p in layer.named_parameters()}
        for i, layer in enumerate(dlwp.base_model.layers)
        if any(True for _ in layer.parameters())
    }}
    cpu, cpu_sampler = flagship_stack("cpu")
    cpu.load_flax_params(tree)
    torch.set_num_threads(os.cpu_count() or 1)

    results, counts = {}, {}
    for tag, gd in (("fp32", None), ("bf16", "bfloat16")):
        est = TimeSeriesEstimator(dlwp, sampler, gate_dtype=gd)
        reset_launch_counts()
        fc = est.predict(STEPS, samples=np.arange(B))
        torch.cuda.synchronize()
        counts[tag] = launch_counts()
        log(f"main path {tag}: predict({STEPS}) at B={B}: "
            f"values {fc.values.shape}, launches {counts[tag]}")
        need = {"fused_conv_pool": 2 * STEPS, "lstm_gates": STEPS}
        if counts[tag] != need:
            raise AssertionError(f"{tag} launches {counts[tag]} != {need}")
        if fc.values.shape != (STEPS * TD, B, C, NLAT, NLON) or not (
                np.isfinite(fc.values).all()):
            raise AssertionError(f"{tag}: bad forecast {fc.values.shape}")
        t0 = time.perf_counter()
        ref = TimeSeriesEstimator(cpu, cpu_sampler, gate_dtype=gd).predict(
            STEPS, samples=np.arange(4))
        got = fc.values[:, :4]
        step1 = np.abs(got[:TD] - ref.values[:TD]).max()
        rrms = (np.sqrt(np.mean((got - ref.values) ** 2))
                / np.sqrt(np.mean(ref.values ** 2)))
        log(f"main path {tag} vs CPU plain (4 samples, "
            f"{time.perf_counter() - t0:.1f} s on CPU): step-1 max abs "
            f"{step1:.3e}, {STEPS}-step relative RMS {rrms:.3e}")
        if not step1 <= TOL_STEP1[tag]:
            raise AssertionError(f"{tag} step 1: {step1} > {TOL_STEP1[tag]}")
        if not rrms <= TOL_TRAJ_RRMS[tag]:
            raise AssertionError(f"{tag} trajectory: {rrms}")

        x0, days, ms, _ = est.prepare_inputs(np.arange(B))
        rollout = est.rollout_fn(STEPS)
        elapsed = timed_ms(lambda: rollout(x0, days, ms), reps=5, inner=1,
                           warmup=1) / 1e3
        gps = B * STEPS * NLAT * NLON / elapsed
        results[tag] = {"elapsed_s": elapsed, "grid_points_per_s": gps}
        log(f"rollout {tag}: {elapsed * 1e3:.2f} ms per predict({STEPS}) "
            f"at B={B} -> {gps / 1e6:.2f} Mgp/s")
        results[tag]["device_ms_per_step"] = profile_steps(
            torch, est, x0, days, ms, tag)
    return counts["fp32"], results


def profile_steps(torch, est, x0, days, ms, tag, steps=4):
    """Device time by kernel over a short rollout (torch.profiler); returns
    the device kernel ms per step."""
    from torch.profiler import ProfilerActivity, profile

    rollout = est.rollout_fn(steps)
    rollout(x0, days, ms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rollout(x0, days, ms)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type.name == "CUDA"]
    total = sum(e.device_time_total for e in rows)
    log(f"profile of rollout({steps}) {tag}: device kernel time "
        f"{total / 1e3:.3f} ms")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:12]:
        log(f"  {e.device_time_total / 1e3 / steps:9.4f} ms/step "
            f"{100 * e.device_time_total / max(total, 1):5.1f}%  "
            f"x{e.count // steps:<3d} {e.key[:90]}")
    return total / 1e3 / steps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)

    from dlwp_torch.device import resolve_device
    from dlwp_torch.kernels import _build

    dev = resolve_device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(f"kernel build: {_build.build():.1f} s for {_build.sources()}")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    errs, timing = check_kernels(torch, dev)
    check_golden(torch, dev, root)
    launches, rollout = run_main_path(torch, dev)

    kernels = []
    for name, source, replaces in (
        ("fused_conv_pool", "dlwp_torch/csrc/fused_conv_pool.cu",
         "dlwp_tpu/ops/fused_stages.py:56"),
        ("lstm_gates", "dlwp_torch/csrc/lstm_gates.cu",
         "dlwp_tpu/ops/lstm_gates.py:80"),
    ):
        # The main path's launches: both conv-pool stages once per step
        # (reported as the mean per launch), the fp32 gates once per step.
        rows = [r for r in timing[name] if r.get("gate_dtype") is None]
        for r in timing[name]:
            r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["flops"])
            log(f"timing {name} {r['shape']} gate_dtype="
                f"{r.get('gate_dtype')}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": float(np.mean([r["ms"] for r in rows])),
            "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
            "bound_ms": float(np.mean([r["bound_ms"] for r in rows])),
            "bound_by": rows[0]["bound_by"],
            "library_ms": None,
            "per_shape": timing[name],
        })
    log(json.dumps({"rollout": rollout, "card": card}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the dlwp_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each raising on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build of every kernel in ``dlwp_torch/csrc`` (``nvcc`` for the CUDA
   sources and the host C compiler for the batch gather, in parallel),
   with each CUDA kernel's registers and spills from ``-Xptxas -v``;
3. each kernel against its plain PyTorch version on the card, at the
   flagship shapes and on odd cases (``fused_conv_pool``: both encoder
   stages, the odd cases of ``CONV_POOL_CASES``, both stages on the
   0.5-degree grid (180x720, column blocks) and dilations from 9 to W - 1
   (taps staged in groups), each with the plan and grid it launched, the
   large dilations also under every other plan bit for bit; at each
   flagship stage samples 0..2 of B=64 equal a B=3
   call bit for bit, and other plans (the other ring depth, warp build,
   column split, tile shape and weight layout) give the chosen plan's
   result bit for bit, the ring's other depth timed beside it);
4. the golden ConvLSTM flagship rollout of ``tests/fixtures/golden.npz``
   (8x16 grid, 3 steps) reproduced in fp32 through the kernels;
5. the main path at full width: synthetic 36x144 dataset -> SeriesSampler
   (+insolation) -> DLWPNeuralNet(ConvLSTM flagship, random weights from a
   seed) -> TimeSeriesEstimator.predict(32) at B=64, with fp32 and bf16
   gates; launch counts prove the kernels ran, and 4 samples are held
   against the same predict on the CPU (plain versions); the rollout's
   device time by kernel (``torch.profiler``), idle share and the
   conv-pool kernel's share;
6. timings with CUDA events (median of repeats after warm-up): each kernel
   and its plain version, and the rollout rate in grid points per second
   (B * steps * 36 * 144 / elapsed); for ``fused_conv_pool`` at each
   stage also its device time (``torch.profiler``) against its 3xTF32 and
   fp32 bounds, and the yardstick of cuDNN's ``F.conv2d`` alone (TF32
   off) on the input padded once, without the pool, bias and tanh;
   then the layers' routing on the card: a float64 predict(2) through the
   compositions (no kernel launch) against the CPU, a ConvLSTM2D with
   'relu' (plain gate chain) against the CPU, a float32 FusedConvPool2D
   at dilation 9 through the kernel against the CPU, the gates' gradient
   (kernel forward, plain VJP) against autograd through the plain version
   and a ConvLSTM2D's against the plain gate chain, and fused_conv_pool
   refusing an operand that requires grad;
7. the training phase (``--only train``), the flow of
   ``examples/train_convlstm.py`` at full width: the dataset of phase 5
   (176 samples, the last 25% held out), a shuffled SeriesSampler at
   B=32, the flagship from a seed, a latitude-weighted MSE, adam at 1e-3,
   early stopping armed; ``fit_generator`` for 2 epochs with a checkpoint
   each epoch, a fresh model resumed to epoch 3 against two uninterrupted
   3-epoch runs (bit-equal, or under cuDNN's default algorithms within
   ``TOL_RESUME_RRMS`` and bit-equal under its deterministic ones), each
   fit's launch counts (the gate kernel in every train step, the conv-pool
   kernel only in validation); the forecast after fit (predict(32) at
   B=64, both kernels); ``device_prefetch``'s batches against the
   sampler's; the first 3 train steps against the CPU at S=1 and S=2 (with
   the insolation-persisting splice); train steps/s and samples/s (CUDA
   events), one step's device time by part (``torch.profiler``), and what
   a hand backward could save (the plain gate VJP and each conv-pool
   stage's composition backward, beside their bounds);
8. the barotropic step kernel against its plain version on the card (psi
   form with and without the hemisphere sign correction, vorticity form):
   T24 on 37x72 for 20 steps and T72 on 73x144 for 40 steps, relative max
   |dz|; 7 + 13 steps equal 20 bit for bit;
9. the barotropic path at full width, the configuration ``bench.py`` times:
   T72 on 73x144, dt 1800 s, damping 5e-6, ``step_impl="kernel"``,
   ``run_with_snapshots(24, 12)`` (144 h, 6-hourly) for both forms; 24
   launches each, finite, snapshot times equal to the plain engine's, and
   the final state within relative RMS 1e-3 of the plain engine on the CPU
   in fp32 (printed at every snapshot); its wall time (CUDA events),
   device kernel time by name (``torch.profiler``) and idle share; then the
   example's default flow (``examples/run_barotropic.py``: 4 batched init
   times, T42, plain engine) on the card against the CPU;
10. barotropic timings (CUDA events, median of 3 after warm-up): ms per step
    as the two-point slope of 500 and 2000 steps, for the kernel, its plain
    version and the plain engine, beside the bound per step; the kernel's
    sync probe (its two grid syncs a step alone, same grid and shared
    memory) on its grid and on 37, 73 and 132 blocks; the stages of a step
    from block 0's clock64() stamps (the kernel's timing build); the kernel
    and its probe at T24 on 37x72; registers and spills of both forms;
11. the lat-band kernels (``halo_exchange``, ``overlap_conv``,
    ``overlap_conv_db``) against their plain versions on meshes of virtual
    shards of the one card (lat 1, 2, 4 and data 2 x lat 2), at every
    sharded conv of the flagship at B=64 and on odd cases (W=18, 72, 144;
    C=3, 12, 32, 128; O=7, 48, 64; B=5 with chunk 2; 0-sided and bf16
    halos): halos bit-equal; convs within 1e-5, the two conv kernels
    bit-equal to each other and to themselves on shards whose base is not
    16-byte aligned;
12. the spatial-parallel forecast at full width: the flagship built with
    ``mesh=build_mesh(MeshConfig(data=1, lat=2), devices=[cuda:0] * 2)``,
    ``batch_spec=("data", None, None, "lat", None)``,
    ``spatial_impl="overlap"``, ``predict(32)`` at B=64 in fp32 gates;
    launch counts equal to those the port's dispatch gives (derived from
    one CPU forward), the forecast held against the unsharded forecast on
    the card and 4 samples against the same sharded predict on the CPU;
    then B=8 for 4 steps, which takes ``overlap_conv``; the sharded and
    unsharded rollout rates, the sharded device time by kernel and idle
    share; each lat-band kernel, its plain version and cuDNN's
    ``F.conv2d`` on the pre-padded shards timed at the path's shapes
    (CUDA events, and device time from ``torch.profiler``) beside its
    bound: fp32 FMA, and for the convs also their 3xTF32 tensor-core
    arithmetic;
13. device-resident training (``--only device_train``) at the training
    phase's width: every batch of a ``DeviceSeriesSampler`` equal to the
    host sampler's bit for bit (S=1, S=2, two epochs); ``fit_device`` for
    3 epochs with ``examples/train_convlstm.py --cosine-decay``'s chain
    (clip 1.0, adam on a cosine decay to 5%) and a device validation
    sampler on the card against the CPU from the same weights (the
    training phase's limits, ``TOL_TRAIN``), every epoch's step loop under
    ``torch.cuda.set_sync_debug_mode("error")``, launch counts (the gate
    kernel in every train step, the conv-pool kernel only in validation);
    ``fit_device`` against per-batch ``fit`` (bit-equal under cuDNN's
    deterministic algorithms); then ``fit_generator`` and ``fit_device``
    timed in turns over 8 epochs of 1197 windows: train samples/s, device
    idle share, the step loop's host time;
14. ``--only layers``: a spec model of every newly registered layer (Conv2D
    SAME at stride 2 with an even kernel, the padding layers, RowConv2D,
    AveragePooling2D, Dense, slice_layer, an edgefix CyclicConv2D) on the
    card against the CPU;
15. ``--only skip_tower``: SkipTower(c_out=4, width=32, time_steps=2,
    lstm_features=8) on the flagship input: predict(32) at B=64 against the
    CPU (forecast limits; gate launches), its rate and idle share, and 3
    train steps against the CPU (train limits);
16. ``--only verify``: ``examples/validate.py``'s flow (validation split,
    ``TimeSeriesEstimator.predict``, ``verification_from_series``, the
    RMSE rows) on the model phase 13 trained, on the card against the CPU
    (1e-4 relative), the table printed;
17. ``--only fold``: ``SphericalHarmonics.build(fold=True)`` against the
    unfolded engine at T72 on 73x144 and T170 on 361x720 (every public
    transform, 1e-5 of scale; the scalar and vector round trips as
    projections, 1e-4) and the round trips' times, one and 16 fields;
18. ``--only spherical``: ``examples/train_spherical.py``'s stack at
    ``bench.py``'s width (B=64, 3 channels on 73x144, b_in 36, truncation
    12, 16 features, Linear 9216 -> 31536): forward and 3 Adam steps
    against the CPU, the forward rate, the train step's time and device
    time by kernel (no hand kernel: none launched);
19. ``--only sharded_spectral``: ``ShardedSphericalHarmonics`` and
    ``ShardedBarotropicModel`` on two virtual lat shards of the card
    (Gaussian 72x144, T71), folded and not, against the unsharded engine
    and 20 steps of the unsharded model, with ms a step of each;
20. ``--only paper_run``: ``docs/DEPLOY.md``'s paper run (the two-truth
    archive, ``Preprocessor.data_to_series``, the pole crop,
    ``train_convlstm.py``'s tower through ``fit_device`` at B=32, S=2,
    ``validate.py``'s rows with the vrt barotropic baseline), cut to
    ``--paper-years`` (1) and ``--paper-epochs`` (10): the archive's
    seconds and ms a step, a short archive against the CPU, the train
    rate, idle share and launches, the RMSE table, the skill criterion
    and the growing barotropic row, both kernels at 72x144 against their
    plain versions;
21. ``--only serve``: the flagship forecast's rollout (B=64, 32 steps)
    exported with ``dlwp_torch.serve.export_program`` on the CPU from CPU
    weights and on the card, serialized and loaded on the card: launches
    per call equal to the eager path's (both kernels through their custom
    ops), B=1, 7 and 64 from one artifact against the eager rollout
    (relative RMS 1e-6), the CPU plain rollout at the forecast's limits,
    export, serialize and load seconds, size, and the rate in turns with
    the eager rollout with both idle shares; ``export_rollout`` of a
    recurrent ``DLWPNeuralNet`` (two channels, a fitted standard scaler,
    time_steps 64) against the eager ``predict_timeseries``;
    ``export_barotropic`` of the psi form at T72 (plain engine, the
    reference's ``run_with_snapshots(24, 12)``, rolled: two programs of
    one 12-step interval) exported on the CPU, 1 and 4 members bit-equal
    to the eager engine on the card and against the CPU; ``opcheck`` of both
    ops on the card at the flagship's shapes; ``entry()``'s forward
    exported and run;
22. ``--only host_data``: the host data path (about a minute): (a) the
    native batch gather (``dlwp_torch/csrc/batch_assembler.c``, a host
    kernel with no TPU counterpart) bit for bit against its numpy version
    at the flagship's batch (B=32, offsets 0..3, two channels) on 36x144
    and 72x144, with duplicated and unsorted samples; (b) one batch's
    assembly both ways and in the sampler's earlier stacked numpy form
    (host clock), and a batch's ``generate`` by part; (c)
    ``fit_generator`` at B=32 in four turns (the earlier stacked gather,
    native, native, stacked), each split into sampler,
    copies, steps and the rest, the native calls two a batch; one epoch's
    launches and native calls counted from 0; (d) where h5py imports, the
    Preprocessor streaming a 36x144 source to a predictor file, read
    lazily by a shuffled SeriesSampler (batches equal to the in-memory
    sampler's) that trains one epoch on the card, else file I/O raising
    the JAX package's RuntimeError; (e) ``CFSReanalysis.retrieve`` against
    a local ``http.server`` fixture (fetch, retry, warning, idempotent
    skip);
23. ``--only sharded_train``: training the flagship with its activations
    sharded over meshes that repeat the card, built as
    ``examples/train_convlstm.py`` builds it (B=32, the training phase's
    stack) with ``spatial_impl="overlap"``: on (data 1, lat 2), (data 2,
    lat 2) and (data 1, lat 2, lon 2) 3 train steps from the unsharded
    card model's weights on the same batches, within ``TOL_TRAIN`` of the
    unsharded card run and of the CPU's lat=2 run (plain versions), each
    step's launches equal to one forward's dispatch (the lon mesh: the
    gates only); ``fit_device`` for an epoch on the lat=2 mesh
    (``DeviceSeriesSampler(sharding=mesh)``); ``dryrun_multichip`` on 8
    and 4 entries of the card; each train step timed in turns with the
    unsharded one (CUDA events), split by part (``torch.profiler``), with
    the idle share and the plain-exchange recompute's share of the
    backward;
24. ``--only multicard`` (about a minute): (a) with two cards or more,
    the lat-band kernels on shards of cuda:0 and cuda:1 (peer access)
    against their plain versions, the lat=2 sharded forecast (B=64, 32
    steps, overlap convs) on the two cards against the one-card run, and
    3 lat=2 train steps against the one-card lat=2 steps; with one card
    a line saying it was not run; (b) two ranks spawned over
    ``torch.multiprocessing`` on cuda:0 with gloo (NCCL refuses two ranks
    on one GPU), and with two cards also NCCL with a card a rank: 3
    flagship train steps at B=32 with the data axis across the ranks and
    lat 2 on each rank's card, against the single-process card run of
    the same batches at ``TOL_TRAIN``, the parameters bit-equal across
    ranks; ``sharded_cyclic_conv2d`` with a lat axis across the ranks
    against ``cyclic_conv2d`` at ``TOL_F32``, and the overlap impl there;
    ms a step against the unsharded one-process step, the gradient
    all-reduce's ms and bytes; and with a lat axis across the ranks
    (CUDA IPC): the halo kernel at lat 2 and lat 4 bit-equal to the
    one-process kernel, both overlap kernels at the lat=2 forecast's conv
    shapes within ``TOL_F32`` of their plain versions, each rank's
    launches, the IPC call's time (host clock, device, the barrier's
    share, opening the handles) beside the repeated-card launch, 3
    flagship train steps at B=32 against the one-process card run at
    ``TOL_TRAIN``, the sharded spectral core (T71 on 72x144) and 20
    barotropic steps against the unsharded ones, and a lon=2 conv whose
    ring spans the ranks; where the machine refuses IPC, the CUDA error
    and the items it leaves unverified;
25. ``--only examples`` (under a minute): the workflows of
    ``dlwp_torch.examples`` through ``main(argv)`` on the card: (a)
    ``train_convlstm`` at its default widths on the synthetic demo data
    (B=32, 25% held out, latitude-weighted MSE) for 2 epochs with a
    checkpoint, then ``--resume`` to 3, each fit's launches (the gates in
    every train step, both kernels in every validation batch) and finite
    losses; (b) ``validate`` of its saved model (12 forecast steps) on the
    card and with ``--device cpu``: the forecast row within
    ``TOL_EX_FORECAST``, persistence and climatology equal, the
    barotropic row within ``TOL_BARO_RRMS``; (c) ``run_barotropic --n-init
    1 --step-impl kernel`` against the CPU's plain engine and
    ``make_barotropic_archive`` through the fused step (one segment)
    against the CPU, where h5py is missing (the card's host) each main
    raising naming it and its compute function run, and
    ``write_predictors`` / ``add_thickness`` the same way; (d) ``train``,
    ``train_functional``, ``train_spherical`` and ``train_distributed
    --virtual 4 --data-shards 2 --lat-shards 2`` for an epoch, each model
    reloaded through ``load_model``; (e) the plot scripts where
    matplotlib imports; each script's seconds;
26. ``--only cube_pad``: the cube pad kernel at the cube U-Net's 10 pad
    shapes (B=64; C 10-128 on faces of 48, 24, 12) bit-equal to the plain
    gather forward and to its VJP backward, timed against the plain
    gather and a lone ``index_select`` of the same table with the bound
    from the bytes, and a 4-step B=64 cube forecast's launches (10 a
    step) and kernel device time per launch;
27. ``--only cyclic_conv``: the cyclic conv kernel at the tower's four
    small-grid convs (``CYCLIC_CONVS``) at B = 1, 8, 32, 64, 128 and 256:
    within TOL_F32 of the plain version, samples bit-equal to a B=3 call
    and at B=64 under every other warp layout, timed (events, profiler
    device time, the kernel alone) against the plain version (cuDNN and
    its pad, bias, activation and permute passes) and ``F.conv2d`` alone,
    with the 3xTF32 bound; with ``CYCLIC_SWEEP=<file>`` every candidate
    plan's device time at B = 1, 8, 64 and 256, into that JSON file;
28. a ``{"kernels": [...]}`` line, then the last line
    ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is present.
``--only PHASE[,PHASE]`` runs the named phases alone (after the build),
without the result lines, to iterate on one part on the card.
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
PEAK_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12

B, STEPS, NLAT, NLON, C, TD = 64, 32, 36, 144, 2, 2
TOL_F32 = 1e-5  # kernel vs plain, fp32: only the summation order differs
TOL_BF16 = 5e-2  # bf16 gates: one bf16 rounding step near 1.0 is 7.8e-3
TOL_GOLDEN = 1e-4  # fp32 through 3 steps vs the float64 golden values
TOL_F64 = 1e-10  # float64 on the card vs the CPU: summation order only
# Main path vs the CPU run (plain versions, same weights). Step 1 differs
# only by fp32 summation order (cuDNN vs CPU convs), so it is held tightly;
# over 32 autoregressive steps those differences compound, so the
# trajectory is held by relative RMS.
TOL_STEP1 = {"fp32": 1e-4, "bf16": 5e-2}
TOL_TRAJ_RRMS = {"fp32": 1e-3, "bf16": 5e-2}
# Barotropic step kernel vs its plain version, relative max |dz|: the JAX
# package's bar for its Pallas step (tests/test_pallas_step.py) at T24 over
# 20 steps; the T72 run sums over 3x more modes for 2x more steps.
TOL_BARO = {24: 1e-5, 72: 1e-4}
# Barotropic path on the card vs the plain engine on the CPU, fp32: relative
# RMS of the final spectral vorticity after 288 steps.
TOL_BARO_RRMS = 1e-3
BARO_SNAPS, BARO_EVERY, BARO_SLOPE_N = 24, 12, 500
# Block counts the barotropic sync probe is also timed on: the row pairs of
# T72 (37), the columns (73) and one block an SM (132).
SYNC_PROBE_BLOCKS = (37, 73, 132)
# The spatial-parallel path: two lat bands of the one card, as the JAX
# recurrent dry run shards its ConvLSTM input (__graft_entry__.py:201).
SHARD_SPEC = ("data", None, None, "lat", None)
B_SMALL, STEPS_SMALL = 8, 4
# Meshes of virtual shards the lat-band kernels are checked on: (data, lat).
PAR_MESHES = ((1, 1), (1, 2), (1, 4), (2, 2))
# The flagship's sharded convs at B=64: (name, x shape, O, kernel size,
# dilation). Dilated and 5x5 convs take the halo kernel, the 3x3 undilated
# ones the overlap kernels.
HALO_CONVS = (
    ("convlstm input", (TD * B, C + 1, NLAT, NLON), 48, 3, 2),
    ("tower conv 1", (B, 4 * (C + 1) * TD, NLAT, NLON), 32, 3, 2),
    ("tower conv 5", (B, 64, NLAT, NLON), 32, 3, 2),
    ("tower conv 6", (B, 32, NLAT, NLON), TD * C, 5, 1),
)
# fused_conv_pool (B, C, H, W, O, dilation): the flagship's encoder stages
# (the main path's shapes), then odd cases: d 1/2/3, C 3/5/11/24/32, O
# 7/37/64/65, W 10/16/18/72/144, H 4/8/10; then both stages on the
# 0.5-degree grid (180x720), 5 column blocks a row; then dilations that
# stage their taps' rows, or rows and columns, in three groups (up to W -
# 1), each also under every other plan.
CONV_POOL_CASES = ((B, 24, NLAT, NLON, 32, 2),
                   (B, 32, NLAT // 2, NLON // 2, 64, 1),
                   (3, 5, 10, 18, 7, 3), (3, 11, 10, 18, 37, 1),
                   (2, 3, 8, 16, 65, 2), (4, 32, 8, 72, 7, 1),
                   (2, 24, 10, 144, 64, 3), (5, 11, 8, 16, 37, 2),
                   (2, 5, 4, 10, 7, 3), (2, 24, 180, 720, 32, 2),
                   (2, 32, 90, 360, 64, 1), (3, 5, 10, 18, 7, 9),
                   (2, 3, 8, 16, 65, 15), (2, 24, 36, 144, 32, 17),
                   (2, 24, 36, 144, 32, 143))
LARGE_DILATION = 9  # and above: the cases checked under every plan
# The training phase: B=32 on a 176-sample series (the last 25% held out),
# 3 epochs, adam at 1e-3; card vs CPU over the first 3 steps. Limits of
# the card vs the CPU (fp32, plain versions, same weights and batches):
# each step's loss (relative), the first step's gradient (global relative
# RMS over every parameter) and the parameters after the 3 steps
# (relative RMS); Adam turns tiny gradient differences into sign-sized
# steps, hence the parameters' looser limit. The first card run gave at
# most 1.1e-7, 1.7e-6 and 1.4e-5 (S=2); the limits keep a 10x margin.
TRAIN_B, TRAIN_N, TRAIN_LR, TRAIN_EPOCHS, TRAIN_CHECK_STEPS = 32, 176, 1e-3, 3, 3
TOL_TRAIN = {"loss": 1e-5, "grad": 2e-5, "params": 2e-4}
# fit_generator's rate is timed over a window of seconds: a 1600-sample
# series (1197 train windows, 38 steps an epoch at B=32), 8 epochs.
FIT_TIME_N, FIT_TIME_EPOCHS = 1600, 8
# A resumed fit against the uninterrupted one: bit-equal under cuDNN's
# deterministic algorithms; with its default ones (whose gradient sums
# are not in a fixed order) within this relative RMS of the parameters
# after 3 epochs (15 steps). Two uninterrupted runs differed by up to
# 6.1e-5 in the first card runs.
TOL_RESUME_RRMS = 1e-3
OVERLAP_CONVS = (
    ("convlstm recurrent", (B, 12, NLAT, NLON), 48),
    ("tower conv 2", (B, 32, NLAT // 2, NLON // 2), 64),
    ("tower conv 4", (B, 128, NLAT // 2, NLON // 2), 64),
)


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


def expected_counts(**nonzero):
    """Expected launch counts: ``nonzero`` and 0 for every other kernel."""
    from dlwp_torch.kernels import WRAPPERS

    return {name: nonzero.get(name, 0) for name in WRAPPERS}


def bound_ms(nbytes, flops, peak=PEAK_FP32_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def plan_text(plan):
    return (f"warp {plan.mo}x1 x {plan.ncg} column tiles x {plan.n_cb} "
            f"column blocks, tile {plan.bb}x{plan.rb}, {plan.warps} warps, "
            f"{plan.stages} stages ({plan.smem} B, "
            f"{'resident' if plan.resident else 'streamed'} weights), "
            f"{plan.n_og} o-groups, {plan.tiles} tiles")


def check_kernels(torch, dev):
    import torch.nn.functional as F

    from dlwp_torch.kernels import (
        fused_conv_pool, fused_conv_pool_plain, lstm_gates, lstm_gates_plain,
    )
    from dlwp_torch.kernels.fused_conv_pool import _launch, _variants
    from dlwp_torch.ops.padding import pad_latlon

    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"fused_conv_pool": 0.0, "lstm_gates": 0.0}
    timing = {"fused_conv_pool": [], "lstm_gates": []}
    for shape in CONV_POOL_CASES:
        b, c, h, w, o, d = shape
        flagship = b == B
        x = torch.randn(b, c, h, w, device=dev, generator=g)
        k = torch.randn(o, c, 3, 3, device=dev, generator=g) / (9 * c) ** 0.5
        bias = 0.1 * torch.randn(o, device=dev, generator=g)
        y = fused_conv_pool(x, k, bias, d)
        plan, grid = fused_conv_pool.last_launch
        torch.cuda.synchronize()
        err = (y - fused_conv_pool_plain(x, k, bias, d)).abs().max().item()
        log(f"check fused_conv_pool {shape}: max|kernel-plain| = {err:.3e}; "
            f"{plan_text(plan)}, grid {grid}")
        if not err <= TOL_F32:
            raise AssertionError(f"fused_conv_pool {shape}: {err} > {TOL_F32}")
        errs["fused_conv_pool"] = max(errs["fused_conv_pool"], err)
        if not flagship and d < LARGE_DILATION:
            continue
        # A sample's result depends neither on the batch nor on the plan.
        if flagship:
            small = fused_conv_pool(x[:3].contiguous(), k, bias, d)
            torch.cuda.synchronize()
            if not torch.equal(small, y[:3]):
                raise AssertionError(f"fused_conv_pool {shape}: B=3 differs "
                                     f"from B={b}")
        variants = _variants(plan, *shape)
        for other in variants:
            if not torch.equal(_launch(x, k, bias, d, other), y):
                raise AssertionError(f"fused_conv_pool {shape}: plan "
                                     f"{other} differs from {plan}")
        log(f"check fused_conv_pool {shape}: {len(variants)} other plans "
            f"bit-equal ({', '.join(plan_text(p) for p in variants)})")
        if not flagship:
            continue
        ring = variants[0]  # the chosen plan with the other ring depth
        ring_ms = device_ms_per_call(
            torch, lambda: _launch(x, k, bias, d, ring))
        # The yardstick: cuDNN's conv alone (TF32 off), without the pool,
        # bias and tanh, on the input padded once outside the timer.
        xp = pad_latlon(x, (d, d), (d, d))

        def library():
            return F.conv2d(xp, k, dilation=d)

        def kernel():
            return fused_conv_pool(x, k, bias, d)

        timing["fused_conv_pool"].append(dict(
            shape=list(shape),
            library_device_ms=device_ms_per_call(torch, library),
            device_ms=device_ms_per_call(torch, kernel),
            other_ring=dict(stages=ring.stages, smem=ring.smem,
                            device_ms=ring_ms),
            ms=timed_ms(kernel),
            plain_ms=timed_ms(lambda: fused_conv_pool_plain(x, k, bias, d)),
            library_ms=timed_ms(library),
            library_note="cuDNN conv alone, without pool/bias/tanh",
            bytes=4 * (x.numel() + k.numel() + o + y.numel()),
            flops=2 * b * o * h * w * c * 9,
            plan=plan._asdict(), grid=grid,
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


# The cube U-Net's pads (DLWP-CS, 6 x 48 x 48 faces, B=64): (channels, face
# size) of the input of each of a model step's 10 ``cube_pad`` launches,
# one before every 3x3 conv.
CUBE_PADS = ((10, 48), (32, 48), (32, 24), (64, 24), (64, 12), (128, 12),
             (128, 24), (64, 24), (64, 48), (32, 48))
CUBE_STEPS = 4  # model steps of the cube forecast the launches are read on
# cyclic_conv: the tower's four small-grid convs after the peephole
# fusions, (name, C, H, W, O, kernel size, upsample, activation), checked
# against the plain version (cuDNN's conv and its pad, bias, activation and
# permute passes) and timed at each batch of CYCLIC_BATCHES.
CYCLIC_CONVS = (
    ("conv128", 64, NLAT // 4, NLON // 4, 128, 3, False, "tanh"),
    ("up64", 128, NLAT // 4, NLON // 4, 64, 3, True, "tanh"),
    ("emit_small32", 64, NLAT // 2, NLON // 2, 32, 3, False, "tanh"),
    ("up4_5x5", 32, NLAT // 2, NLON // 2, TD * C, 5, True, "linear"),
)
CYCLIC_BATCHES = (1, 8, 32, 64, 128, 256)
# The kernel's own bound: 3 TF32 tensor-core products a multiply-add.
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3


def check_cube_pad(torch, dev):
    """``cube_pad`` on the card at the cube U-Net's pads (``CUBE_PADS``,
    B=64): bit-equal to ``cube_pad_plain`` forward and to its VJP backward;
    timed (events and profiler device time) against the plain gather and
    a lone ``index_select`` of the same table on the flattened faces, with
    the bound from the bytes (faces read, padded faces written); then a
    cube forecast of ``CUBE_STEPS`` steps at B=64, built through
    ``DLWPNeuralNet.build_model``: its launches and the kernel's device
    time per launch there."""
    from dlwp_torch import PredictorDataset, SeriesSampler, TimeSeriesEstimator
    from dlwp_torch.grid.cubed_sphere import folded_lat_lon
    from dlwp_torch.kernels import cube_pad, launch_counts, reset_launch_counts
    from dlwp_torch.models import DLWPNeuralNet
    from dlwp_torch.ops.padding import (_cube_index, cube_pad_plain,
                                        cube_pad_vjp)

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for c, n in dict.fromkeys(CUBE_PADS):
        eq = torch.randn(4 * B, c, n, n, device=dev, generator=g)
        pol = torch.randn(2 * B, c, n, n, device=dev, generator=g)
        got = cube_pad(eq, pol, 1)
        if not torch.equal(got, cube_pad_plain(eq, pol, 1)):
            raise AssertionError(f"cube_pad (B={B}, C={c}, n={n}): kernel "
                                 "differs from the plain gather")
        leaves = [eq.clone().requires_grad_(True),
                  pol.clone().requires_grad_(True)]
        grad = torch.randn(got.shape, device=dev, generator=g)
        cube_pad(*leaves, 1).backward(grad)
        want = cube_pad_vjp(grad, 1)
        if not (torch.equal(leaves[0].grad, want[0])
                and torch.equal(leaves[1].grad, want[1])):
            raise AssertionError(f"cube_pad (B={B}, C={c}, n={n}): backward "
                                 "differs from the plain VJP")
        # The yardstick: the plain version's one gather alone, on faces
        # already flattened to (B C, 6 n n) outside the timer.
        flat = torch.cat([eq.reshape(4, B * c, n * n),
                          pol.reshape(2, B * c, n * n)]).transpose(0, 1)
        flat = flat.reshape(B * c, 6 * n * n).contiguous()
        idx = _cube_index(n, 1, dev)

        def library():
            return flat.index_select(1, idx)

        def kernel():
            return cube_pad(eq, pol, 1)

        m = n + 2
        row = dict(
            shape=[B, c, n], launches_a_step=CUBE_PADS.count((c, n)),
            ms=timed_ms(kernel), device_ms=device_ms_per_call(torch, kernel),
            plain_ms=timed_ms(lambda: cube_pad_plain(eq, pol, 1)),
            library_ms=timed_ms(library),
            library_device_ms=device_ms_per_call(torch, library),
            bytes=4 * 6 * B * c * (n * n + m * m), flops=0)
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], 0)
        log(f"check cube_pad (B={B}, C={c}, n={n}): bit-equal forward and "
            f"backward; kernel {row['ms']:.4f} ms (device "
            f"{row['device_ms']:.4f}, {100 * row['bound_ms'] / row['device_ms']:.1f}"
            f"% of the bound {row['bound_ms']:.4f} ms), plain "
            f"{row['plain_ms']:.4f} ms, index_select alone "
            f"{row['library_ms']:.4f} ms (device {row['library_device_ms']:.4f})")
        rows.append(row)
        del eq, pol, got, leaves, grad, want, flat
    step = {k: sum(r[k] * r["launches_a_step"] for r in rows)
            for k in ("ms", "device_ms", "plain_ms", "library_ms",
                      "library_device_ms", "bound_ms", "bytes")}
    log(f"cube_pad, a U-Net step's 10 launches at B={B}: kernel "
        f"{step['ms']:.4f} ms (device {step['device_ms']:.4f}, "
        f"{100 * step['bound_ms'] / step['device_ms']:.2f}% of the bound "
        f"{step['bound_ms']:.4f} ms), plain {step['plain_ms']:.4f} ms "
        f"({step['plain_ms'] / step['ms']:.2f}x the kernel), index_select "
        f"alone {step['library_ms']:.4f} ms (device "
        f"{step['library_device_ms']:.4f})")

    # The main path: a B=64 cube forecast on seeded fields and weights.
    n_face, T = 48, B + 6
    lat, lon = folded_lat_lon(n_face)
    rng = np.random.RandomState(0)
    data = PredictorDataset(
        predictors=rng.randn(T, 4, 6 * n_face, n_face).astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(T) * np.timedelta64(6, "h")),
        varlev=["Z500", "TAU300-700", "Z1000", "T2m"], lat=lat, lon=lon)
    net = DLWPNeuralNet(time_dim=2, scaler_type=None, device=dev)
    net.build_model([("CubeUNet", [8], {"filters": [32, 64, 128]})])
    sampler = SeriesSampler(data, model=net, input_time_steps=2,
                            output_time_steps=2, add_insolation=True,
                            batch_size=B)
    net.init(sampler.generate(np.arange(1))[0], seed=1)
    est = TimeSeriesEstimator(net, sampler)
    x0, days, ms, _ = est.prepare_inputs(np.arange(B))
    roll = est.rollout_fn(CUBE_STEPS)
    roll(x0, days, ms)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = roll(x0, days, ms)
    torch.cuda.synchronize()
    launches = launch_counts()["cube_pad"]
    if launches != 10 * CUBE_STEPS or not torch.isfinite(out).all():
        raise AssertionError(f"cube forecast: {launches} cube_pad launches "
                             f"over {CUBE_STEPS} steps, finite "
                             f"{bool(torch.isfinite(out).all())}")
    names = {}
    profile_steps(torch, est, x0, days, ms, f"cube B={B}", steps=CUBE_STEPS,
                  names=names)
    pad = [(t, k) for key, (t, k) in names.items() if "cube_pad" in key]
    on_path = (sum(t for t, _ in pad) / sum(k for _, k in pad)
               if pad else None)
    log(f"cube forecast B={B}, {CUBE_STEPS} steps: {launches} cube_pad "
        f"launches; device ms a launch there {on_path}")
    return {"rows": rows, "step": step, "launches_forecast": launches,
            "forecast_steps": CUBE_STEPS,
            "device_ms_per_launch_on_path": on_path}


def kernel_device_ms(torch, fns, name, reps=5):
    """Device ms of the kernels named with ``name`` that each of ``fns``
    launches (median of ``reps`` calls), in one profiler session: the
    kernels in launch order, ``reps`` a call."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    # A profiler session in a process that has run others before it has
    # come back without device records; it is repeated before failing.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        ks = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type().name == "CUDA" and name in e.name()),
                    key=lambda e: e.start_ns())
        if len(ks) == reps * len(fns):
            break
    else:
        raise AssertionError(f"{len(ks)} {name} launches traced for "
                             f"{reps * len(fns)} calls")
    ms = [(e.end_ns() - e.start_ns()) / 1e6 for e in ks]
    return [float(np.median(ms[i * reps:(i + 1) * reps]))
            for i in range(len(fns))]


def cyclic_conv_plan_text(plan, grid):
    return (f"warp {plan.mf}x{plan.nf} fragments, {plan.wm}x{plan.wn} warps "
            f"(tile {plan.bm}x{plan.bn}), {plan.stages} stages "
            f"({plan.smem} B), {plan.tiles} tiles, grid {grid}")


def check_cyclic_conv(torch, dev):
    """``cyclic_conv`` on the card at the tower's four small-grid convs
    (``CYCLIC_CONVS``) at each batch of ``CYCLIC_BATCHES``: within TOL_F32
    of the plain version (cuDNN with TF32 off and its pad, bias,
    activation and permute passes); samples 0..2 bit-equal to a B=3 call;
    at B=64 every other build and tile shape of ``_candidates`` bit-equal
    to the plan's; timed (events and profiler device time) against the
    plain version (the composition the layers ran) and cuDNN's
    ``F.conv2d`` alone on an input padded outside the timer, with the
    bound from the operations (3xTF32). With CYCLIC_SWEEP=<file> in the
    environment every candidate plan's device time at B = 1, 8, 64 and
    256 is also written to that JSON file."""
    import torch.nn.functional as F

    from dlwp_torch.kernels import cyclic_conv, cyclic_conv_plain
    from dlwp_torch.kernels._tiling import sm_count
    from dlwp_torch.kernels.cyclic_conv import (ACT_CODES, _candidates,
                                                _fold, _launch, _plan)
    from dlwp_torch.ops.conv import _parity_kernels
    from dlwp_torch.ops.padding import pad_latlon

    g = torch.Generator(device=dev).manual_seed(0)
    sms = sm_count(dev)
    sweep = os.environ.get("CYCLIC_SWEEP")
    rows, sweeps = [], []
    for name, c, h, w, o, ks, up, act in CYCLIC_CONVS:
        for b in CYCLIC_BATCHES:
            x = torch.randn(b, c, h, w, device=dev, generator=g)
            k = torch.randn(o, c, ks, ks, device=dev, generator=g) / (
                ks * ks * c) ** 0.5
            bias = 0.1 * torch.randn(o, device=dev, generator=g)
            y = cyclic_conv(x, k, bias, act, up)
            plan, grid = cyclic_conv.last_launch
            want = cyclic_conv_plain(x, k, bias, act, up)
            torch.cuda.synchronize()
            err = (y - want).abs().max().item()
            if not err <= TOL_F32:
                raise AssertionError(f"cyclic_conv {name} B={b}: max|kernel-"
                                     f"plain| {err} > {TOL_F32}")
            if b >= 3 and not torch.equal(
                    cyclic_conv(x[:3].contiguous(), k, bias, act, up), y[:3]):
                raise AssertionError(f"cyclic_conv {name} B={b}: samples "
                                     "0..2 differ from a B=3 call")
            kt = _fold(k) if up else k
            n = kt.shape[0]
            cands = list(_candidates(b, c, h, w, n))
            if b == B:
                seen = {}
                for p in cands:
                    seen.setdefault((p.mf, p.nf, p.wm, p.wn), p)
                for p in seen.values():
                    if not torch.equal(_launch(x, kt, bias, ACT_CODES[act],
                                               up, p), y):
                        raise AssertionError(f"cyclic_conv {name} B={b}: "
                                             f"plan {p} differs")
            # The yardstick: cuDNN's conv alone, on the input padded (and
            # the kernel folded) outside the timer.
            xp = pad_latlon(x, (1, 1), (1, 1))
            kl = _parity_kernels(k) if up else k

            def library():
                return F.conv2d(xp, kl)

            def kernel():
                return cyclic_conv(x, k, bias, act, up)

            def plain():
                return cyclic_conv_plain(x, k, bias, act, up)

            flops = 2 * b * h * w * n * c * 9
            nbytes = 4 * (x.numel() + k.numel() + o + y.numel())
            row = dict(conv=name, shape=[b, c, h, w, n], plan=list(plan),
                       grid=grid, max_abs_err=err, ms=timed_ms(kernel),
                       device_ms=device_ms_per_call(torch, kernel),
                       kernel_only_ms=kernel_device_ms(
                           torch, [kernel], "cyclic_conv_kernel")[0],
                       plain_ms=timed_ms(plain),
                       plain_device_ms=device_ms_per_call(torch, plain),
                       library_ms=timed_ms(library),
                       library_device_ms=device_ms_per_call(torch, library),
                       flops=flops, bytes=nbytes)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                        PEAK_3XTF32_FLOPS)
            row["roofline_pct"] = 100 * row["bound_ms"] / row["device_ms"]
            row["tflops"] = flops / row["device_ms"] / 1e9
            log(f"check cyclic_conv {name} B={b} ({c}->{n} on {h}x{w}): "
                f"max|kernel-plain| {err:.2e}; kernel {row['ms']:.4f} ms "
                f"(device {row['device_ms']:.4f}, the kernel alone "
                f"{row['kernel_only_ms']:.4f}, {row['tflops']:.1f} "
                f"TFLOP/s, {row['roofline_pct']:.1f}% of {row['bound_ms']:.4f})"
                f"; plain {row['plain_ms']:.4f} (device "
                f"{row['plain_device_ms']:.4f}); F.conv2d alone "
                f"{row['library_ms']:.4f} (device "
                f"{row['library_device_ms']:.4f}); "
                f"{cyclic_conv_plan_text(plan, grid)}")
            rows.append(row)
            if sweep and b in (1, 8, B, 256):
                times = kernel_device_ms(torch, [
                    lambda p=p: _launch(x, kt, bias, ACT_CODES[act], up, p)
                    for p in cands], "cyclic_conv_kernel")
                timed = sorted(zip(times, cands), key=lambda tp: tp[0])
                best = timed[0]
                mine = next(t for t, p in timed if p == plan)
                log(f"  sweep {name} B={b}: {len(timed)} plans; best "
                    f"{best[0]:.4f} ms {list(best[1])}; plan's {mine:.4f} ms;"
                    f" top 5 {[(round(t, 4), list(p)) for t, p in timed[:5]]}")
                sweeps.append(dict(conv=name, batch=b, best=[best[0],
                                                             list(best[1])],
                                   plan=[mine, list(plan)],
                                   all=[(t, list(p)) for t, p in timed]))
            del x, k, y, want, xp
    steps = {}
    for b in CYCLIC_BATCHES:
        at = [r for r in rows if r["shape"][0] == b]
        step = steps[b] = {k: sum(r[k] for r in at) for k in (
            "ms", "device_ms", "kernel_only_ms", "plain_ms",
            "plain_device_ms", "library_ms", "library_device_ms", "bound_ms",
            "flops")}
        log(f"cyclic_conv, a tower step's 4 launches at B={b}: kernel device "
            f"{step['device_ms']:.4f} ms ({100 * step['bound_ms'] / step['device_ms']:.1f}"
            f"% of {step['bound_ms']:.4f}), plain device "
            f"{step['plain_device_ms']:.4f} ({step['plain_device_ms'] / step['device_ms']:.2f}x), "
            f"F.conv2d alone device {step['library_device_ms']:.4f}")
    if sweep:
        os.makedirs(os.path.dirname(sweep) or ".", exist_ok=True)
        with open(sweep, "w") as f:
            json.dump(sweeps, f)
    return {"rows": rows, "steps": steps, "sweeps": [
        {k: v for k, v in s.items() if k != "all"} for s in sweeps]}


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
    if counts != expected_counts(fused_conv_pool=6, lstm_gates=3,
                                 cyclic_conv=12):
        raise AssertionError(f"golden run did not use the kernels: {counts}")
    if not err <= TOL_GOLDEN:
        raise AssertionError(f"golden: {err} > {TOL_GOLDEN}")


def flagship_dataset(n, seed=0):
    """The synthetic 36x144 series: ``n`` 6-hourly samples of two varlevs
    from ``RandomState(seed)``."""
    from dlwp_torch import PredictorDataset

    return PredictorDataset(
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


def flagship_stack(device, seed=0, mesh=None, specs=None):
    """Synthetic dataset -> model -> sampler, as a user builds it; with a
    ``mesh``, the model shards latitude bands over it (``overlap``).
    ``specs``: another model than the flagship."""
    from dlwp_torch import DLWPNeuralNet, SeriesSampler
    from dlwp_torch.flagship import convlstm_specs

    data = flagship_dataset(B + 2 * TD + 2, seed)
    dlwp = DLWPNeuralNet(time_dim=TD, scaler_type=None, is_recurrent=True,
                         device=device)
    dlwp.build_model(specs or convlstm_specs(NLAT, NLON, C, TD), mesh=mesh,
                     batch_spec=SHARD_SPEC if mesh else None,
                     spatial_impl="overlap")
    sampler = SeriesSampler(data, model=dlwp, input_time_steps=TD,
                            output_time_steps=TD, batch_size=B,
                            add_insolation=True)
    return dlwp, sampler


def forecast_vs_cpu(fc, cpu, cpu_sampler, tag, label, gate_dtype=None):
    """Hold the card's forecast ``fc`` (of samples 0..) to the CPU model's
    (plain versions) on its first 4 samples: step-1 max abs and the
    trajectory's relative RMS, to the limits of ``tag``."""
    from dlwp_torch import TimeSeriesEstimator

    t0 = time.perf_counter()
    ref = TimeSeriesEstimator(cpu, cpu_sampler, gate_dtype=gate_dtype) \
        .predict(STEPS, samples=np.arange(4))
    got = fc.values[:, :4]
    step1 = np.abs(got[:TD] - ref.values[:TD]).max()
    rrms = (np.sqrt(np.mean((got - ref.values) ** 2))
            / np.sqrt(np.mean(ref.values ** 2)))
    log(f"{label} vs CPU plain (4 samples, {time.perf_counter() - t0:.1f} s "
        f"on CPU): step-1 max abs {step1:.3e}, {STEPS}-step relative RMS "
        f"{rrms:.3e}")
    if not step1 <= TOL_STEP1[tag]:
        raise AssertionError(f"{label} step 1: {step1} > {TOL_STEP1[tag]}")
    if not rrms <= TOL_TRAJ_RRMS[tag]:
        raise AssertionError(f"{label} trajectory: {rrms}")
    return {"step1_max_abs": float(step1), "rel_rms": float(rrms)}


def run_main_path(torch, dev):
    from dlwp_torch import TimeSeriesEstimator, flax_tree
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    dlwp, sampler = flagship_stack(dev)
    x_sample, _ = sampler.generate(np.arange(1))
    dlwp.init(x_sample, seed=0)
    cpu, cpu_sampler = flagship_stack("cpu")
    cpu.load_flax_params(flax_tree(dlwp.base_model))
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
        need = expected_counts(fused_conv_pool=2 * STEPS, lstm_gates=STEPS,
                               cyclic_conv=4 * STEPS)
        if counts[tag] != need:
            raise AssertionError(f"{tag} launches {counts[tag]} != {need}")
        if fc.values.shape != (STEPS * TD, B, C, NLAT, NLON) or not (
                np.isfinite(fc.values).all()):
            raise AssertionError(f"{tag}: bad forecast {fc.values.shape}")
        forecast_vs_cpu(fc, cpu, cpu_sampler, tag, f"main path {tag}",
                        gate_dtype=gd)

        x0, days, ms, _ = est.prepare_inputs(np.arange(B))
        rollout = est.rollout_fn(STEPS)
        elapsed = timed_ms(lambda: rollout(x0, days, ms), reps=5, inner=1,
                           warmup=1) / 1e3
        gps = B * STEPS * NLAT * NLON / elapsed
        results[tag] = {"elapsed_s": elapsed, "grid_points_per_s": gps}
        log(f"rollout {tag}: {elapsed * 1e3:.2f} ms per predict({STEPS}) "
            f"at B={B} -> {gps / 1e6:.2f} Mgp/s")
        names = {}
        device = results[tag]["device_ms_per_step"] = profile_steps(
            torch, est, x0, days, ms, tag, names=names)
        pool = [(t, n) for k, (t, n) in names.items() if "conv_pool" in k]
        pool_ms = sum(t for t, _ in pool)
        results[tag]["conv_pool_device_ms_per_step"] = pool_ms
        results[tag]["conv_pool_share"] = pool_ms / device
        results[tag]["conv_pool_device_ms_per_launch"] = (
            pool_ms / max(sum(n for _, n in pool), 1))
        results[tag]["idle_share"] = 1 - device / (elapsed * 1e3 / STEPS)
        log(f"rollout {tag}: device {device:.3f} ms a step of "
            f"{elapsed * 1e3 / STEPS:.3f} ms (idle "
            f"{100 * results[tag]['idle_share']:.1f}%); conv_pool_kernel "
            f"{pool_ms:.4f} ms a step ({100 * pool_ms / device:.1f}%), "
            f"{results[tag]['conv_pool_device_ms_per_launch']:.4f} ms a "
            f"launch")
    return counts["fp32"], results


def check_routing(torch, dev):
    """The layers' routing on the card: a float64 flagship predict(2) runs
    the compositions (no kernel launch) and matches the CPU; a ConvLSTM2D
    with 'relu' runs the plain gate chain and matches the CPU; a float32
    FusedConvPool2D at dilation 9 runs the kernel, as the JAX layer runs
    its Pallas kernel there, and matches the CPU; the gates' gradient (the
    kernel's forward, the plain version's VJP) equals autograd through the
    plain version on the card, and a ConvLSTM2D's gradient through the
    kernel matches the same layer's through the plain gate chain;
    fused_conv_pool refuses operands that require grad. Returns the
    largest differences."""
    from unittest import mock

    import dlwp_torch.models.layers as layers_module
    from dlwp_torch import TimeSeriesEstimator, flax_tree
    from dlwp_torch.kernels import (
        fused_conv_pool, launch_counts, lstm_gates, lstm_gates_plain,
        reset_launch_counts,
    )
    from dlwp_torch.models.cnn import SequentialModel
    from dlwp_torch.models.layers import ConvLSTM2D, FusedConvPool2D

    out = {}
    card, sampler = flagship_stack(dev)
    card.init(sampler.generate(np.arange(1))[0], seed=0)
    cpu, cpu_sampler = flagship_stack("cpu")
    tree = flax_tree(card.base_model)
    for net in (card, cpu):
        net.load_flax_params(tree, dtype=torch.float64)
    reset_launch_counts()
    got = TimeSeriesEstimator(card, sampler).predict(
        2, samples=np.arange(4)).values
    torch.cuda.synchronize()
    counts = launch_counts()
    want = TimeSeriesEstimator(cpu, cpu_sampler).predict(
        2, samples=np.arange(4)).values
    out["float64_predict_max_abs"] = float(np.abs(got - want).max())
    log(f"routing: float64 predict(2) at 36x144, 4 samples, on the card: "
        f"{got.dtype} {got.shape}, launches {counts}; max |card - CPU| "
        f"{out['float64_predict_max_abs']:.3e}")
    if got.dtype != np.float64 or counts != expected_counts():
        raise AssertionError(f"float64 predict: {got.dtype}, {counts}")
    if not out["float64_predict_max_abs"] <= TOL_F64:
        raise AssertionError(f"float64 predict: {out}")

    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, TD, C + 1, NLAT, NLON, generator=g)
    layers = {}
    for name in ("cpu", dev):
        layers[name] = SequentialModel(
            [ConvLSTM2D(12, 3, dilation=2, activation="relu")], device=name)
        layers[name].init(x, seed=4)
    reset_launch_counts()
    with torch.inference_mode():
        got = layers[dev](x.to(dev)).cpu()
        want = layers["cpu"](x)
    counts = launch_counts()
    out["relu_convlstm_max_abs"] = (got - want).abs().max().item()
    log(f"routing: ConvLSTM2D(12, activation='relu') on (4, 2, 3, 36, 144) "
        f"on the card: launches {counts}; max |card - CPU| "
        f"{out['relu_convlstm_max_abs']:.3e}")
    if counts != expected_counts() or not (
            out["relu_convlstm_max_abs"] <= TOL_F32):
        raise AssertionError(f"relu ConvLSTM2D: {counts}, {out}")

    xp = torch.randn(4, 24, NLAT, NLON, generator=g)
    pools = {}
    for name in ("cpu", dev):
        pools[name] = SequentialModel(
            [FusedConvPool2D(32, 3, dilation=9)], device=name)
        pools[name].init(xp, seed=5)
    reset_launch_counts()
    with torch.inference_mode():
        got = pools[dev](xp.to(dev)).cpu()
        want = pools["cpu"](xp)
    counts = launch_counts()
    out["conv_pool_d9_max_abs"] = (got - want).abs().max().item()
    log(f"routing: FusedConvPool2D(32, dilation=9) on (4, 24, 36, 144) on "
        f"the card: launches {counts}; max |card - CPU| "
        f"{out['conv_pool_d9_max_abs']:.3e}")
    if counts != expected_counts(fused_conv_pool=1) or not (
            out["conv_pool_d9_max_abs"] <= TOL_F32):
        raise AssertionError(f"FusedConvPool2D at dilation 9: {counts}, {out}")

    # The gates at the flagship's shape: the kernel's forward and the
    # plain VJP against autograd through the plain version, same inputs.
    gd = torch.Generator(device=dev).manual_seed(5)
    ops = [torch.randn(shape, device=dev, generator=gd) for shape in (
        (B, 48, NLAT, NLON), (B, 48, NLAT, NLON), (B, 12, NLAT, NLON))]
    cot = [torch.randn(B, 12, NLAT, NLON, device=dev, generator=gd)
           for _ in range(2)]
    grads = []
    for fn in (lstm_gates, lstm_gates_plain):
        leaves = [t.clone().requires_grad_(True) for t in ops]
        torch.autograd.backward(fn(*leaves, "tanh", "hard_sigmoid"), cot)
        grads.append([t.grad for t in leaves])
    out["gates_grad_max_abs"] = max(
        (a - b).abs().max().item() for a, b in zip(*grads))
    # A ConvLSTM2D's gradient through the kernel against the same layer on
    # the card with the plain gate chain (the convs are the same cuDNN
    # calls on both sides).
    w = torch.randn(2, TD, 12, NLAT, NLON, generator=g).to(dev)
    layer = layers[dev].layers[0]
    layer.activation = "tanh"
    names = ("input_kernel", "recurrent_kernel", "bias")
    start = [getattr(layer, n).detach() for n in names]
    layer_grads = []
    for gates in (lstm_gates, lstm_gates_plain):
        for n, t in zip(names, start):
            setattr(layer, n, torch.nn.Parameter(t.clone()))
        xt = x[:2].to(dev).requires_grad_(True)
        reset_launch_counts()
        with mock.patch.object(layers_module, "lstm_gates", gates):
            (layer(xt) * w).sum().backward()
        if launch_counts()["lstm_gates"] != (1 if gates is lstm_gates else 0):
            raise AssertionError(f"ConvLSTM2D gradient: {launch_counts()}")
        layer_grads.append([getattr(layer, n).grad for n in names]
                           + [xt.grad])
    out["convlstm_grad_rel"] = max(
        ((a - b).abs().max() / b.abs().max()).item()
        for a, b in zip(*layer_grads))
    log(f"routing: lstm_gates gradient at (64, 48, 36, 144) vs autograd "
        f"through the plain version on the card: max abs "
        f"{out['gates_grad_max_abs']:.3e}; ConvLSTM2D(12) gradient on (2, 2, "
        f"3, 36, 144), kernel forward and plain VJP vs the plain gate chain: "
        f"relative {out['convlstm_grad_rel']:.3e}")
    if not (out["gates_grad_max_abs"] <= TOL_F32
            and out["convlstm_grad_rel"] <= TOL_F32):
        raise AssertionError(f"gate gradients: {out}")
    k = torch.randn(7, 5, 3, 3, device=dev, requires_grad=True)
    try:
        fused_conv_pool(torch.randn(2, 5, 8, 16, device=dev), k, None, 1)
    except NotImplementedError as e:
        log(f"routing: fused_conv_pool refuses a kernel that requires grad: "
            f"{e}")
    else:
        raise AssertionError("fused_conv_pool took an operand that "
                             "requires grad")
    return out


def splice_insolation(inp, pred, k):
    """``examples/train_convlstm.py``'s sequence splice in torch: the
    prediction's channels, then the input's last known insolation."""
    import torch

    return torch.cat([pred, inp[:, :, C:]], dim=2)


def gates_per_train_step(S):
    """``lstm_gates`` launches of one train step, from the code: the
    ConvLSTM runs the gates at its steps t >= 1 (TD - 1 launches a model
    call), the loss makes S model calls, and with S > 1 each call runs
    under ``checkpoint`` and again in its recompute."""
    return (TD - 1) * S * (2 if S > 1 else 1)


def train_stack(device, S=1, seed=0, n=TRAIN_N, specs=None, shuffle=True,
                mesh=None):
    """The flagship (or ``specs``) to train and its train and validation
    samplers, as ``examples/train_convlstm.py`` builds them: the last 25%
    of the series held out with ``train_test_split_ind``, shuffle on with
    seed 0 (unless ``shuffle`` is off), insolation, TD input and output
    steps, B=32, a latitude-weighted MSE, adam at 1e-3 and early stopping
    armed; random weights from ``seed``. With a ``mesh``, the model is
    built on it with ``spatial_impl="overlap"`` (:func:`mesh_spec`)."""
    from dlwp_torch import DLWPNeuralNet
    from dlwp_torch.flagship import convlstm_specs
    from dlwp_torch.ops.losses import latitude_weighted_loss, mse

    data = flagship_dataset(n)
    net = DLWPNeuralNet(is_recurrent=True, time_dim=TD, scaler_type=None,
                        device=device)
    net.build_model(
        specs or convlstm_specs(NLAT, NLON, C, TD),
        loss=latitude_weighted_loss(mse, data.lat), optimizer="adam",
        learning_rate=TRAIN_LR, sequence_steps=S,
        splice_fn=splice_insolation if S > 1 else None,
        early_stopping=True, patience=TRAIN_EPOCHS, mesh=mesh,
        batch_spec=mesh_spec(mesh) if mesh else None, spatial_impl="overlap",
    )
    train, val = train_samplers(net, S, n, shuffle)
    net.init(train.generate(np.arange(1))[0], seed=seed)
    return net, train, val


def train_samplers(net, S=1, n=TRAIN_N, shuffle=True):
    """The train (shuffled from seed 0 when ``shuffle``) and validation
    samplers of :func:`train_stack`'s split."""
    from dlwp_torch import SeriesSampler
    from dlwp_torch.utils import train_test_split_ind

    data = flagship_dataset(n)
    tr_idx, val_idx = train_test_split_ind(n, n // 4, method="last")
    kw = dict(input_time_steps=TD, output_time_steps=TD,
              sequence=S if S > 1 else None, add_insolation=True,
              batch_size=TRAIN_B)
    return (SeriesSampler(data.isel_sample(tr_idx), model=net,
                          shuffle=shuffle, seed=0, **kw),
            SeriesSampler(data.isel_sample(val_idx), model=net, **kw))


def state_equal(a, b):
    return a.keys() == b.keys() and all(
        bool((a[k] == b[k]).all()) for k in a)


def state_rel_rms(got, want):
    """sqrt(sum |got - want|^2) / sqrt(sum |want|^2) over a state dict."""
    num = sum(float(((got[k].double().cpu() - want[k].double().cpu()) ** 2)
                    .sum()) for k in want)
    den = sum(float((want[k].double().cpu() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def fit_launches(epochs, n_train, n_val, S=1, pools=2, convs=4):
    """Launches of a fit over ``epochs`` epochs: each train step's gates,
    and each validation batch's S model steps (``pools`` conv-pool stages,
    ``convs`` cyclic convs, TD - 1 gate launches each; the flagship's 2
    and 4, ``train_convlstm``'s tower 1 and 3)."""
    return expected_counts(
        lstm_gates=epochs * (n_train * gates_per_train_step(S)
                             + n_val * (TD - 1) * S),
        fused_conv_pool=epochs * n_val * pools * S,
        cyclic_conv=epochs * n_val * convs * S)


def fit_three_ways(torch, dev, tmp, tag):
    """From one seed: fit_generator for 2 epochs with a checkpoint each
    epoch, then a fresh model resumed from it to epoch 3; and two
    uninterrupted 3-epoch runs. Each fit's launch counts are set to 0
    just before it and read just after, and held to :func:`fit_launches`.
    Returns [(net, history, wall s, launch counts)] in that order."""
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    ckpt = os.path.join(tmp, tag)
    runs = []
    for epochs, kw in ((2, {"checkpoint_dir": ckpt}),
                       (3, {"checkpoint_dir": ckpt, "resume": True}),
                       (3, {}), (3, {})):
        net, train, val = train_stack(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        hist = net.fit_generator(train, validation_data=val, epochs=epochs,
                                 verbose=False, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        need = fit_launches(len(hist.epoch), len(train), len(val))
        if counts != need:
            raise AssertionError(f"fit ({tag}, {epochs} epochs {kw}) "
                                 f"launches {counts} != {need}")
        losses = hist.history["loss"] + hist.history["val_loss"]
        if not np.isfinite(losses).all():
            raise AssertionError(f"fit: non-finite losses {hist.history}")
        runs.append((net, hist, wall, counts))
    return runs


def fit_resume_forecast(torch, dev, tmp):
    """fit_generator with checkpoints, a resumed run against the
    uninterrupted one and a second uninterrupted run against the first
    (the card's own run-to-run spread); where the default run is not
    bit-equal, the same under cuDNN's deterministic algorithms, which
    must be; then TimeSeriesEstimator.predict on the trained model."""
    from dlwp_torch import (SeriesSampler, TimeSeriesEstimator,
                            device_prefetch, flax_tree)
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    out = {}
    runs = fit_three_ways(torch, dev, tmp, "default")
    (_, hist, wall, counts) = runs[0]
    out["fit_launches"] = counts
    log(f"train fit_generator: 2 epochs at B={TRAIN_B}, {wall:.2f} s host "
        f"clock (epochs {[round(t, 3) for t in hist.history['time']]} s; the "
        f"process's first fit, which imports torch._dynamo on building the "
        f"optimizer); launches {counts}; loss "
        f"{hist.history['loss']}, val_loss {hist.history['val_loss']}")

    def compare(runs, tag):
        resumed, hist_r = runs[1][:2]
        straight, hist_s = runs[2][:2]
        again = runs[3][0]
        s_state = straight.base_model.state_dict()
        row = {
            "resume_bit_equal": (
                hist_r.epoch == [2]
                and state_equal(resumed.base_model.state_dict(), s_state)
                and hist_r.history["loss"] == hist_s.history["loss"][2:]),
            "resume_rel_rms": state_rel_rms(resumed.base_model.state_dict(),
                                            s_state),
            "rerun_bit_equal": state_equal(again.base_model.state_dict(),
                                           s_state),
            "rerun_rel_rms": state_rel_rms(again.base_model.state_dict(),
                                           s_state),
        }
        log(f"train resume ({tag}): epoch 3 resumed from the epoch-2 "
            f"checkpoint vs 3 epochs straight: bit-equal "
            f"{row['resume_bit_equal']}, parameter relative RMS "
            f"{row['resume_rel_rms']:.3e}; a second straight run: bit-equal "
            f"{row['rerun_bit_equal']}, relative RMS "
            f"{row['rerun_rel_rms']:.3e}; epoch-3 loss "
            f"{hist_r.history['loss']} vs {hist_s.history['loss'][2:]}")
        return row

    out["default"] = compare(runs, "default cuDNN algorithms")
    if not out["default"]["resume_bit_equal"]:
        if not out["default"]["resume_rel_rms"] <= TOL_RESUME_RRMS:
            raise AssertionError(f"resumed run differs: {out}")
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            det = fit_three_ways(torch, dev, tmp, "deterministic")
        out["deterministic"] = compare(det, "cuDNN deterministic")
        if not (out["deterministic"]["resume_bit_equal"]
                and out["deterministic"]["rerun_bit_equal"]):
            raise AssertionError(f"resumed run differs: {out}")

    straight = runs[2][0]
    sampler = SeriesSampler(flagship_dataset(TRAIN_N), model=straight,
                            input_time_steps=TD, output_time_steps=TD,
                            batch_size=B, add_insolation=True)
    reset_launch_counts()
    fc = TimeSeriesEstimator(straight, sampler).predict(STEPS,
                                                        samples=np.arange(B))
    torch.cuda.synchronize()
    out["forecast_launches"] = launch_counts()
    log(f"train: TimeSeriesEstimator.predict({STEPS}) at B={B} on the "
        f"trained model: {fc.values.shape}, launches "
        f"{out['forecast_launches']}")
    need = expected_counts(fused_conv_pool=2 * STEPS, lstm_gates=STEPS,
                           cyclic_conv=4 * STEPS)
    if out["forecast_launches"] != need:
        raise AssertionError(f"forecast after fit: {out} != {need}")
    if fc.values.shape != (STEPS * TD, B, C, NLAT, NLON) or not (
            np.isfinite(fc.values).all()):
        raise AssertionError(f"forecast after fit: {fc.values.shape}")
    cpu, cpu_sampler = flagship_stack("cpu")  # the same first samples
    cpu.load_flax_params(flax_tree(straight.base_model))
    out["forecast_vs_cpu"] = forecast_vs_cpu(
        fc, cpu, cpu_sampler, "fp32", "train: forecast after fit")

    # device_prefetch: the side-stream copies equal the sampler's batches.
    want = list(sampler)
    got = [tuple(t.cpu().numpy() for t in pair)
           for pair in device_prefetch(sampler, device=dev)]
    out["prefetch_equal"] = len(got) == len(want) and all(
        np.array_equal(a, b) for g, w in zip(got, want)
        for a, b in zip(g, w))
    log(f"train: device_prefetch of {len(want)} batches of B={B}: equal to "
        f"the sampler's {out['prefetch_equal']}")
    if not out["prefetch_equal"]:
        raise AssertionError("device_prefetch changed the batches")
    return out


def leaf_modules(model):
    return {n: m for n, m in model.named_modules()
            if n and not any(True for _ in m.children())}


def forced_gradient(torch, S, specs, weights, batch, card_out, mesh=None):
    """The first step's gradient on the CPU from ``weights``, its backward
    evaluated at the card's forward values ``card_out`` (each leaf
    module's output, by name): each output keeps the CPU's graph and takes
    the card's value, so a max whose argmax the two forwards' last-bit
    differences flip (a near tie) routes the gradient as on the card.
    ``mesh``: a CPU mesh the reference is built on (the card model's
    layers, hence its leaf names, are a mesh model's)."""
    ref, _, _ = train_stack("cpu", S, specs=specs, mesh=mesh)
    ref.base_model.load_state_dict(weights)
    for p in ref.base_model.parameters():
        p.requires_grad_(True)

    def force(out, card):
        if isinstance(out, tuple):
            return tuple(force(o, c) for o, c in zip(out, card))
        return out + (card.to(out.dtype) - out).detach()

    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: force(out, card_out[n]))
        for n, m in leaf_modules(ref.base_model).items()]
    x, y = (ref.trainer._to_device(a) for a in batch)
    ref.trainer._forward_loss(x, y)[0].backward()
    for h in hooks:
        h.remove()
    return {n: p.grad.detach().clone()
            for n, p in ref.base_model.named_parameters()}


def pool_decisions(a, b):
    """A 2x2 max pool over (B, C, H, W) on ``a`` and on ``b``: the windows
    whose argmax differs, the windows, and the smallest gap between the
    two largest values of a window of ``b``."""
    def windows(t):
        B, C, H, W = t.shape
        return (t.double().reshape(B, C, H // 2, 2, W // 2, 2)
                .permute(0, 1, 2, 4, 3, 5).reshape(-1, 4))

    wa, wb = windows(a), windows(b)
    top = wb.topk(2, dim=1).values
    return (int((wa.argmax(1) != wb.argmax(1)).sum()), wa.shape[0],
            float((top[:, 0] - top[:, 1]).min()))


def train_vs_cpu(torch, dev, S, make_specs=None, pools=2, label="train",
                 force=False, pooled=None, convs=4):
    """The first TRAIN_CHECK_STEPS train steps on the card and, from the
    same weights and batches, in fp32 on the CPU (plain versions): each
    step's loss, the first step's gradient and the parameters after the
    steps. Before them, ``evaluate`` of the first batch on those weights
    (on the card through both kernels) against the CPU's. One train
    step's launches, and one evaluated batch's (``pools`` conv-pool and
    ``convs`` cyclic conv launches a model step: 2 and 4 for the
    flagship). ``make_specs``: a
    function returning another model's specs, called for each model.
    ``force``: hold the first gradient to :func:`forced_gradient` (the
    CPU's backward at the card's forward values), and report its
    difference to the CPU's own as ``grad_rel_rms_unforced``; with it,
    ``pooled`` ({leaf module: channels a 2x2 max pool takes from its
    output}) reports those pools' :func:`pool_decisions`, card against
    CPU, in the first step."""
    from dlwp_torch import flax_tree
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    specs = make_specs or (lambda: None)
    card, train, _ = train_stack(dev, S, specs=specs())
    cpu, _, _ = train_stack("cpu", S, specs=specs())
    cpu.load_flax_params(flax_tree(card.base_model))
    batches = [train[i] for i in range(TRAIN_CHECK_STEPS)]
    runs, outs = {}, {"card": {}, "cpu": {}}
    for name, net in (("card", card), ("cpu", cpu)):
        tr = net.trainer
        tr.init(batches[0][0])
        before = {k: v.detach().cpu().clone()
                  for k, v in net.base_model.state_dict().items()}
        if name == "card":
            reset_launch_counts()
        eval_loss = tr.evaluate([batches[0]])["loss"]
        if name == "card":
            torch.cuda.synchronize()
            eval_counts = launch_counts()
        losses, grads, t0 = [], None, time.perf_counter()
        for k, (xb, yb) in enumerate(batches):
            hooks = []
            if name == "card" and k == 0:
                reset_launch_counts()
            if force and k == 0:
                hooks = [m.register_forward_hook(
                    lambda mod, inp, out, n=n: outs[name].__setitem__(
                        n, tuple(o.detach().cpu() for o in out)
                        if isinstance(out, tuple) else out.detach().cpu()))
                    for n, m in leaf_modules(net.base_model).items()]
            losses.append(tr.train_step(xb, yb)["loss"].item())
            for h in hooks:
                h.remove()
            if name == "card" and k == 0:
                step_counts = launch_counts()
            if k == 0:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in net.base_model.named_parameters()}
        params = {k: v.detach().cpu().clone()
                  for k, v in net.base_model.state_dict().items()}
        runs[name] = (losses, grads, params, time.perf_counter() - t0,
                      eval_loss)
    (l_card, g_card, p_card, _, e_card), (l_cpu, g_cpu, p_cpu, cpu_s,
                                          e_cpu) = runs["card"], runs["cpu"]
    moved = {k: p_cpu[k] - before[k] for k in p_cpu}
    if force:
        g_ref = forced_gradient(torch, S, specs(), before, batches[0],
                                outs["card"])
    out = {
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu)),
        "eval_loss_rel": abs(e_card - e_cpu) / abs(e_cpu),
        "grad_rel_rms": state_rel_rms(g_card, g_ref if force else g_cpu),
        "params_rel_rms": state_rel_rms(p_card, p_cpu),
        "params_diff_over_update_rms": state_rel_rms(
            {k: p_card[k] - before[k] for k in p_card}, moved),
        "losses_card": l_card, "losses_cpu": l_cpu,
        "step_launches": step_counts, "eval_launches": eval_counts,
    }
    if force:
        out["grad_rel_rms_unforced"] = state_rel_rms(g_card, g_cpu)
        out["pool_decisions"] = {
            n: pool_decisions(outs["card"][n][:, :c], outs["cpu"][n][:, :c])
            for n, c in (pooled or {}).items()}
    forced = ("against the CPU's backward at the card's forward values "
              if force else "")
    unforced = (f"; against the CPU's own {out['grad_rel_rms_unforced']:.3e}"
                + "".join(f"; the max pool on {n}: {d} of {w} windows' argmax "
                          f"differ, the CPU's smallest top-two gap {g:.3e}"
                          for n, (d, w, g) in out["pool_decisions"].items())
                if force else "")
    log(f"{label} S={S} card vs CPU fp32 ({TRAIN_CHECK_STEPS} steps at B="
        f"{TRAIN_B}, {cpu_s:.1f} s on the CPU): loss relative "
        f"{out['loss_rel']:.3e} (limit {TOL_TRAIN['loss']}), evaluate's "
        f"loss relative {out['eval_loss_rel']:.3e} (same limit), first "
        f"gradient {forced}relative RMS {out['grad_rel_rms']:.3e} (limit "
        f"{TOL_TRAIN['grad']}{unforced}),"
        f" parameters relative RMS {out['params_rel_rms']:.3e} (limit "
        f"{TOL_TRAIN['params']}; the difference is "
        f"{out['params_diff_over_update_rms']:.3e} of the update's RMS); "
        f"launches a train step {step_counts}, an evaluated batch "
        f"{eval_counts}")
    need_step = expected_counts(lstm_gates=gates_per_train_step(S))
    need_eval = expected_counts(lstm_gates=(TD - 1) * S,
                                fused_conv_pool=pools * S,
                                cyclic_conv=convs * S)
    if step_counts != need_step or eval_counts != need_eval:
        raise AssertionError(f"S={S} launches: {out}")
    for key, lim in (("loss_rel", "loss"), ("eval_loss_rel", "loss"),
                     ("grad_rel_rms", "grad"),
                     ("params_rel_rms", "params")):
        if not out[key] <= TOL_TRAIN[lim]:
            raise AssertionError(f"S={S} {key}: {out[key]} > {TOL_TRAIN[lim]}")
    return out


# Parts of a train step's split that run in its backward. A sharded
# conv's backward on the kernel paths recomputes the conv through the plain
# exchange (SHARDED_RECOMPUTE) and differentiates that recompute (the
# other two "sharded conv backward" parts).
SHARDED_RECOMPUTE = "sharded conv backward: plain-exchange forward recomputed"
BACKWARD_PARTS = ("lstm_gates kernel (recompute)", "plain gate VJP",
                  "conv data-gradient", "conv weight-gradient",
                  "conv backward, other kernels", "conv forward (recompute)",
                  "other backward", SHARDED_RECOMPUTE,
                  "sharded conv backward: conv gradients",
                  "sharded conv backward: exchange, wrap and copy gradients")


def train_step_split(torch, fn):
    """Device time of one call of ``fn`` (a train step) by part, from a
    ``torch.profiler`` trace: each kernel goes to the part its name or the
    ops that launched it name. Returns {part: [ms, kernels, top names]}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def part(event, kname):
        chain, e = [], event
        while e is not None:
            chain.append(e.name)
            e = e.cpu_parent
        ops = " | ".join(chain)
        backward = "autograd::engine" in ops
        if "_FastConvBackward" in ops:
            # Inside the sharded conv's backward: its plain-exchange
            # forward, then (a nested engine call) that forward's backward.
            if sum(c.startswith("autograd::engine::evaluate_function")
                   for c in chain) < 2:
                return SHARDED_RECOMPUTE
            if "aten::convolution_backward" in ops:
                return "sharded conv backward: conv gradients"
            return "sharded conv backward: exchange, wrap and copy gradients"
        if "halo_kernel" in kname:
            return "halo_exchange kernel"
        if "overlap" in kname and "kernel" in kname:
            return "overlap conv kernels"
        if "lstm_gates" in kname:
            return "lstm_gates kernel" + (" (recompute)" if backward else "")
        if "Optimizer.step" in ops:
            return "optimizer update"
        if "_GatesBackward" in ops:
            return "plain gate VJP"
        if "aten::convolution_backward" in ops:
            if "dgrad" in kname:
                return "conv data-gradient"
            if "wgrad" in kname:
                return "conv weight-gradient"
            return "conv backward, other kernels"
        if "aten::cudnn_convolution" in ops or "aten::convolution" in ops:
            return "conv forward" + (" (recompute)" if backward else "")
        return "other backward" if backward else "other forward"

    split = {}
    for event in prof.events():
        for k in getattr(event, "kernels", ()):
            row = split.setdefault(part(event, k.name), [0.0, 0, {}])
            row[0] += k.duration / 1e3
            row[1] += 1
            row[2][k.name] = row[2].get(k.name, 0.0) + k.duration / 1e3
    for row in split.values():
        row[2] = [f"{t:.4f} ms {n[:70]}" for n, t in
                  sorted(row[2].items(), key=lambda kv: -kv[1])[:3]]
    return split


def time_train(torch, dev, S):
    """Train steps/s and samples/s at B=32 on device-resident batches (CUDA
    events, median after warm-up), the device time of one step by kernel
    and by part (torch.profiler), and the idle share."""
    net, train, _ = train_stack(dev, S)
    tr = net.trainer
    xb, yb = train[0]
    tr.init(xb)
    xd, yd = tr._to_device(xb), tr._to_device(yb)
    step = lambda: tr.train_step(xd, yd)  # noqa: E731
    ms = timed_ms(step, reps=5, inner=5, warmup=3)
    profile_device(torch, step, f"train step S={S} B={TRAIN_B}")
    split = train_step_split(torch, step)
    device = sum(v[0] for v in split.values())
    out = {"ms_per_step": ms, "steps_per_s": 1e3 / ms,
           "samples_per_s": TRAIN_B * 1e3 / ms, "device_ms_per_step": device,
           "idle_share": 1 - device / ms,
           "split_ms": {k: v[0] for k, v in split.items()},
           "split_launches": {k: v[1] for k, v in split.items()},
           "split_top": {k: v[2] for k, v in split.items()}}
    log(f"train S={S} B={TRAIN_B}: {ms:.3f} ms a step (CUDA events) -> "
        f"{out['steps_per_s']:.2f} steps/s, {out['samples_per_s']:.1f} "
        f"samples/s; device {device:.3f} ms a step (idle "
        f"{100 * out['idle_share']:.1f}%)")
    total = sum(out["split_ms"].values())
    for k, v in sorted(split.items(), key=lambda kv: -kv[1][0]):
        log(f"  {v[0]:8.4f} ms {100 * v[0] / max(total, 1e-9):5.1f}% "
            f"x{v[1]:<4d} {k}: {'; '.join(v[2])}")
    return out


def time_fit_generator(torch, dev, device_ms_per_step=None,
                       epochs=FIT_TIME_EPOCHS):
    """fit_generator's train samples/s at B=32 over ``epochs`` epochs of a
    FIT_TIME_N-sample series, without validation, after a one-epoch
    warm-up; then its host-clock time split into its serial parts, each
    timed alone over the same number of epochs: the sampler's batch
    assembly, each batch's copy to the card (pinning included; synchronized
    once at the end) and the train steps on batches already on the card.
    The rest is the fit loop's own. The native batch gather's calls in the
    timed fit are counted (two a batch when the sampler takes it: inputs
    and targets). The device's idle share in the fit takes the train
    step's device time (``device_ms_per_step``, from torch.profiler) for
    each step, where given."""
    from dlwp_torch.data import native

    net, train, _ = train_stack(dev, n=FIT_TIME_N)
    tr, E = net.trainer, epochs
    net.fit_generator(train, epochs=1, verbose=False)
    torch.cuda.synchronize()
    calls = native.assemble.launches
    t0 = time.perf_counter()
    hist = net.fit_generator(train, epochs=E, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    calls = native.assemble.launches - calls
    if len(hist.epoch) != E:
        raise AssertionError(f"timed fit ran {len(hist.epoch)} epochs")
    steps, windows = E * len(train), E * len(train._indices)

    t0 = time.perf_counter()
    for _ in range(E):
        batches = list(train)
    assembly_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(E):
        on_card = [(tr._to_device(x), tr._to_device(y)) for x, y in batches]
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(E):
        for x, y in on_card:
            tr.train_step(x, y)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    out = {"fit_s": fit_s, "epochs": E, "steps": steps, "windows": windows,
           "samples_per_s": windows / fit_s, "steps_per_s": steps / fit_s,
           "assembly_s": assembly_s, "copy_s": copy_s, "step_s": step_s,
           "rest_s": fit_s - assembly_s - copy_s - step_s,
           "native_calls": calls,
           "idle_share": None if device_ms_per_step is None
           else 1 - steps * device_ms_per_step / 1e3 / fit_s}
    idle = ("" if out["idle_share"] is None
            else f", device idle {100 * out['idle_share']:.1f}%")
    log(f"train fit_generator timed: {E} epochs of {windows // E} windows "
        f"({steps} steps at B={TRAIN_B}, no validation) in {fit_s:.3f} s "
        f"host clock: {out['samples_per_s']:.1f} train samples/s, "
        f"{out['steps_per_s']:.2f} steps/s{idle}; native gather calls "
        f"{calls}. Alone over the same epochs: "
        f"sampler assembly {assembly_s:.3f} s "
        f"({100 * assembly_s / fit_s:.1f}%), copies to the card "
        f"{copy_s:.3f} s ({100 * copy_s / fit_s:.1f}%), train steps on "
        f"card-resident batches {step_s:.3f} s "
        f"({100 * step_s / fit_s:.1f}%); the rest {out['rest_s']:.3f} s")
    return out


def time_backward_candidates(torch, dev):
    """What a hand backward kernel could save in a train step at B=32:
    the device time of the plain gate VJP (after the kernel's forward) and
    of each conv-pool stage's composition backward (conv data and weight
    gradients, tanh and pool backward), each beside the bound of the same
    function (bytes once each way; for the convs also 3 TF32 products a
    multiply-add, the hand convs' arithmetic), and the composition's
    forward beside the kernel's (torch.profiler, mean of 10 calls)."""
    from dlwp_torch.kernels import lstm_gates
    from dlwp_torch.models.cnn import SequentialModel
    from dlwp_torch.models.layers import FusedConvPool2D

    g = torch.Generator().manual_seed(11)
    F4, n = 4 * 4 * (C + 1), TRAIN_B * NLAT * NLON
    zx, zh = (torch.randn(TRAIN_B, F4, NLAT, NLON, generator=g).to(dev)
              .requires_grad_(True) for _ in range(2))
    c0 = torch.randn(TRAIN_B, F4 // 4, NLAT, NLON, generator=g).to(dev) \
        .requires_grad_(True)
    grads = [torch.randn(TRAIN_B, F4 // 4, NLAT, NLON, generator=g).to(dev)
             for _ in range(2)]
    fwd = device_ms_per_call(torch, lambda: lstm_gates(zx, zh, c0, "tanh"))
    both = device_ms_per_call(torch, lambda: torch.autograd.grad(
        lstm_gates(zx, zh, c0, "tanh"), (zx, zh, c0), grads))
    # read zx, zh, c, dh, dc; write dzx, dzh, dc: 20 F-channel planes.
    bound, by = bound_ms(4 * 20 * (F4 // 4) * n, 0)
    out = {"gate_vjp": {"ms": both - fwd, "forward_kernel_ms": fwd,
                        "bound_ms": bound, "bound_by": by}}
    log(f"backward candidates: plain gate VJP {both - fwd:.4f} ms device at "
        f"({TRAIN_B}, {F4}, {NLAT}, {NLON}), bound {bound:.4f} ms ({by}); "
        f"the kernel's forward {fwd:.4f} ms")
    for name, (Cin, H, W, O, d) in (("stage 1", (TD * F4 // 4, NLAT, NLON,
                                                 32, 2)),
                                    ("stage 2", (32, NLAT // 2, NLON // 2,
                                                 64, 1))):
        x = torch.randn(TRAIN_B, Cin, H, W, generator=g).to(dev)
        model = SequentialModel([FusedConvPool2D(O, 3, dilation=d)],
                                device=dev).init(x, seed=3)
        layer = model.layers[0]
        with torch.no_grad():
            kernel_fwd = device_ms_per_call(torch, lambda: layer(x))
        x.requires_grad_(True)
        for p in (layer.kernel, layer.bias):
            p.requires_grad_(True)
        dy = torch.randn(TRAIN_B, O, H // 2, W // 2, generator=g).to(dev)
        comp_fwd = device_ms_per_call(torch, lambda: layer(x))
        comp_all = device_ms_per_call(torch, lambda: torch.autograd.grad(
            layer(x), (x, layer.kernel, layer.bias), dy))
        flops = 2 * 2 * TRAIN_B * O * Cin * 9 * H * W  # data + weight grads
        nbytes = 4 * (2 * x.numel() + 2 * layer.kernel.numel() + O
                      + dy.numel())
        b_fp32, by32 = bound_ms(nbytes, flops)
        b_tc, bytc = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOPS)
        out[name] = {"shape": [TRAIN_B, Cin, H, W, O, d],
                     "backward_ms": comp_all - comp_fwd,
                     "composition_forward_ms": comp_fwd,
                     "kernel_forward_ms": kernel_fwd,
                     "bound_fp32_ms": b_fp32, "bound_tc_ms": b_tc}
        log(f"backward candidates: conv-pool {name} ({TRAIN_B}, {Cin}, {H},"
            f" {W})->{O} d={d}: composition backward {comp_all - comp_fwd:.4f}"
            f" ms device (bound fp32 {b_fp32:.4f} ({by32}), 3xTF32 "
            f"{b_tc:.4f} ({bytc})); composition forward {comp_fwd:.4f} ms, "
            f"the kernel's {kernel_fwd:.4f} ms")
    return out


def run_train_phase(torch, dev):
    """The training path at full width (the flow of
    examples/train_convlstm.py): fit, checkpoint and resume, the forecast
    after fit, S=1 and S=2 against the CPU, and the train rates."""
    import tempfile

    torch.set_num_threads(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as tmp:
        out = fit_resume_forecast(torch, dev, tmp)
    for S in (1, 2):
        out[f"S{S}"] = train_vs_cpu(torch, dev, S)
        out[f"S{S}"].update(time_train(torch, dev, S))
    out["fit_timed"] = time_fit_generator(
        torch, dev, out["S1"]["device_ms_per_step"])
    out["backward_candidates"] = time_backward_candidates(torch, dev)
    return out


# ---------------------------------------------------------------------------
# Device-resident training, the remaining layers, SkipTower, verification.
def chain_optimizer(steps, lr=TRAIN_LR):
    """``examples/train_convlstm.py --cosine-decay``'s optimizer in the
    port: the global norm clipped at 1, then adam on a cosine decay from
    the learning rate ``lr`` over ``steps`` to 5% of it."""
    from dlwp_torch.train import chain, clip_by_global_norm
    from dlwp_torch.train import cosine_decay_schedule
    from dlwp_torch.train.optim import adam

    return chain(clip_by_global_norm(1.0),
                 adam(cosine_decay_schedule(lr, steps, 0.05)))


def device_stack(device, S=1, shuffle=True):
    """:func:`train_stack` with its samplers wrapped in
    ``DeviceSeriesSampler``s on ``device``, and the trainer's optimizer
    :func:`chain_optimizer` over TRAIN_EPOCHS epochs of the device
    sampler's batches (known once the sampler exists)."""
    from dlwp_torch import DeviceSeriesSampler

    net, train, val = train_stack(device, S, shuffle=shuffle)
    train = DeviceSeriesSampler(train, device=device)
    val = DeviceSeriesSampler(val, device=device)
    net.trainer.make_optimizer = chain_optimizer(len(train) * TRAIN_EPOCHS)
    return net, train, val


def probe_step_loop(torch, trainer, guard, record):
    """Wrap ``trainer._device_epoch`` (an epoch's step loop): with
    ``guard`` it runs under ``torch.cuda.set_sync_debug_mode('error')``,
    where anything that waits for the card raises; its host time and step
    count go to ``record``."""
    real = trainer._device_epoch

    def probed(sampler, idx):
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            out = real(sampler, idx)
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(0)
        record.append((time.perf_counter() - t0, len(out)))
        return out

    trainer._device_epoch = probed


_TRAINED = {}  # the card's model after device_train's S=1 fit, for verify


def device_batches_equal(torch, dev, S):
    """Every batch of two shuffled epochs of a ``DeviceSeriesSampler`` on
    the card against the host ``SeriesSampler``'s, bit for bit."""
    from dlwp_torch import DeviceSeriesSampler

    net, host, _ = train_stack(dev, S)
    dsam = DeviceSeriesSampler(train_samplers(net, S)[0], device=dev)
    n = 0
    for _ in range(2):
        for i, (x, y) in enumerate(dsam):
            xh, yh = host[i]
            if not (torch.equal(x, torch.from_numpy(xh).to(dev))
                    and torch.equal(y, torch.from_numpy(yh).to(dev))):
                raise AssertionError(f"S={S}: device batch {i} differs")
            n += 1
        host.on_epoch_end()
    log(f"device_train S={S}: {n} batches of B={TRAIN_B} over 2 epochs "
        f"({len(dsam)} an epoch, the ragged tail dropped) equal the host "
        f"sampler's bit for bit")
    return n


def fit_device_vs_cpu(torch, dev, S):
    """fit_device for TRAIN_EPOCHS epochs with the example's chain and a
    device validation sampler, on the card (every epoch's step loop under
    sync-debug 'error', launches counted) and on the CPU from the same
    weights: epoch losses to TOL_TRAIN['loss'] relative, parameters to
    TOL_TRAIN['params'] relative RMS."""
    from dlwp_torch import flax_tree
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    runs = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        net, train, val = device_stack(device, S)
        if name == "card":
            tree0, record = flax_tree(net.base_model), []
            n_train, n_val = len(train), len(val)
            probe_step_loop(torch, net.trainer, True, record)
            reset_launch_counts()
        else:
            net.load_flax_params(tree0)
        t0 = time.perf_counter()
        hist = net.fit_generator(train, validation_data=val,
                                 epochs=TRAIN_EPOCHS, verbose=False)
        if name == "card":
            torch.cuda.synchronize()
            counts = launch_counts()
        runs[name] = (net, hist, time.perf_counter() - t0,
                      {k: v.detach().cpu().clone()
                       for k, v in net.base_model.state_dict().items()})
    (card, h_card, wall, p_card), (_, h_cpu, cpu_s, p_cpu) = (
        runs["card"], runs["cpu"])
    need = fit_launches(len(h_card.epoch), n_train, n_val, S)
    out = {
        "epochs": h_card.epoch, "loss_card": h_card.history["loss"],
        "loss_cpu": h_cpu.history["loss"],
        "loss_rel": max(abs(a - b) / abs(b) for k in ("loss", "val_loss")
                        for a, b in zip(h_card.history[k], h_cpu.history[k])),
        "params_rel_rms": state_rel_rms(p_card, p_cpu),
        "launches": counts, "launches_need": need,
        "guarded_epochs": len(record), "steps": [n for _, n in record],
        "wall_s": wall, "cpu_s": cpu_s,
        "schedule_count": card.trainer.optimizer.param_groups[0][
            "schedule_count"],
    }
    log(f"device_train S={S}: fit_device {TRAIN_EPOCHS} epochs x "
        f"{n_train} steps (chain: clip 1.0, adam on a cosine decay) on "
        f"the card, {wall:.2f} s, every step loop under sync-debug 'error' "
        f"({len(record)} epochs, no sync); vs the CPU ({cpu_s:.1f} s): "
        f"epoch losses relative {out['loss_rel']:.3e} (limit "
        f"{TOL_TRAIN['loss']}), parameters relative RMS "
        f"{out['params_rel_rms']:.3e} (limit {TOL_TRAIN['params']}); "
        f"launches {counts}; loss {h_card.history['loss']}, val_loss "
        f"{h_card.history['val_loss']}")
    if counts != need:
        raise AssertionError(f"fit_device S={S} launches {counts} != {need}")
    if not out["loss_rel"] <= TOL_TRAIN["loss"]:
        raise AssertionError(f"fit_device S={S} losses: {out}")
    if not out["params_rel_rms"] <= TOL_TRAIN["params"]:
        raise AssertionError(f"fit_device S={S} parameters: {out}")
    if S == 1:
        _TRAINED["net"] = card
    return out


def fit_device_vs_per_batch(torch, dev):
    """Shuffle off, S=1, the chain: fit_device against per-batch fit over
    the same device sampler (forced by a BatchHistory callback), on the
    card from one seed: bit for bit under cuDNN's deterministic
    algorithms, within TOL_RESUME_RRMS under its default ones."""
    from dlwp_torch.train import BatchHistory

    def both():
        got = []
        for cbs in ([], [BatchHistory()]):
            net, train, _ = device_stack(dev, shuffle=False)
            hist = net.fit_generator(train, epochs=TRAIN_EPOCHS,
                                     verbose=False, callbacks=cbs)
            got.append((net.base_model.state_dict(), hist.history["loss"]))
        (a, la), (b, lb) = got
        return state_equal(a, b) and la == lb, state_rel_rms(a, b)

    out = {}
    out["default_bit_equal"], out["default_rel_rms"] = both()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out["deterministic_bit_equal"], _ = both()
    log(f"device_train: fit_device vs per-batch fit ({TRAIN_EPOCHS} epochs, "
        f"shuffle off): default cuDNN bit-equal {out['default_bit_equal']} "
        f"(relative RMS {out['default_rel_rms']:.3e}), deterministic cuDNN "
        f"bit-equal {out['deterministic_bit_equal']}")
    if not (out["deterministic_bit_equal"]
            and out["default_rel_rms"] <= TOL_RESUME_RRMS):
        raise AssertionError(f"fit_device vs per-batch fit: {out}")
    return out


def time_fit_device(torch, dev):
    """fit_generator and fit_device at B=32 over FIT_TIME_EPOCHS epochs of
    the FIT_TIME_N-sample series (adam, no validation), in turns
    (generator, device, generator, device) after a warm-up epoch of each,
    on one model: train samples/s (the windows each trains on: fit_device
    drops the ragged batch), the device's idle share (device time an
    epoch of each driver from torch.profiler) and fit_device's host time
    a step (its step loop, which does not wait for the card)."""
    from dlwp_torch import DeviceSeriesSampler

    net, train, _ = train_stack(dev, n=FIT_TIME_N)
    dtrain = DeviceSeriesSampler(train_samplers(net, n=FIT_TIME_N)[0],
                                 device=dev)
    record, E = [], FIT_TIME_EPOCHS
    probe_step_loop(torch, net.trainer, False, record)
    fits = {"fit_generator": (train, len(train), len(train._indices)),
            "fit_device": (dtrain, len(dtrain), len(dtrain) * TRAIN_B)}
    for sampler, _, _ in fits.values():
        net.fit_generator(sampler, epochs=1, verbose=False)
    out = {k: {"fit_s": [], "samples_per_s": []} for k in fits}
    for name in ("fit_generator", "fit_device") * 2:
        sampler, steps, windows = fits[name]
        record.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = net.fit_generator(sampler, epochs=E, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        if len(hist.epoch) != E:
            raise AssertionError(f"{name} ran {len(hist.epoch)} epochs")
        out[name]["fit_s"].append(fit_s)
        out[name]["samples_per_s"].append(E * windows / fit_s)
        if name == "fit_device":
            out[name]["host_ms_per_step"] = [
                1e3 * sum(t for t, _ in record) / sum(n for _, n in record)]
    for name, (sampler, steps, windows) in fits.items():
        dev_ms = profile_device(
            torch, lambda: net.fit_generator(sampler, epochs=1,
                                             verbose=False),
            f"{name} epoch", per=steps, unit="step")
        r = out[name]
        r.update(steps_per_epoch=steps, windows_per_epoch=windows,
                 device_ms_per_step=dev_ms,
                 idle_share=[1 - E * steps * dev_ms / 1e3 / t
                             for t in r["fit_s"]])
        extra = (f"; its step loop {r['host_ms_per_step'][0]:.3f} ms of "
                 f"host time a step" if "host_ms_per_step" in r else "")
        log(f"device_train timed {name}: {E} epochs of {windows} windows "
            f"({steps} steps at B={TRAIN_B}, no validation), two runs in "
            f"turns: {', '.join(f'{t:.3f}' for t in r['fit_s'])} s host "
            f"clock -> {', '.join(f'{v:.1f}' for v in r['samples_per_s'])} "
            f"train samples/s; device {dev_ms:.3f} ms a step (torch."
            f"profiler), idle {', '.join(f'{100 * v:.1f}' for v in r['idle_share'])}%"
            f"{extra}")
    return out


def run_device_train(torch, dev):
    """Device-resident training at full width: batch equality at S=1 and
    S=2, fit_device against the CPU at S=1 and S=2, against per-batch fit,
    and timed beside fit_generator."""
    torch.set_num_threads(os.cpu_count() or 1)
    out = {"batches_equal": {S: device_batches_equal(torch, dev, S)
                             for S in (1, 2)}}
    for S in (1, 2):
        out[f"S{S}"] = fit_device_vs_cpu(torch, dev, S)
    out["per_batch"] = fit_device_vs_per_batch(torch, dev)
    out["timed"] = time_fit_device(torch, dev)
    return out


# Every layer name of the registry the flagship does not use, in one
# model on a (B, 3, 36, 144) input.
LAYER_SPECS = [
    ("slice_layer", (0, 2, 1), None),
    ("CyclicConv2D", (16, 3), {"impl": "edgefix", "dilation": 2,
                               "activation": "tanh"}),
    ("PeriodicPadding2D", ((0, 2),), None),
    ("ZeroPadding2D", ((1, 0),), None),
    ("Conv2D", (16, 5), {"activation": "tanh"}),
    ("TFPadding2D", (((1, 1), (0, 0)),), {"mode": "SYMMETRIC"}),
    ("Conv2D", (32, 4), {"strides": (2, 2), "padding": "same",
                         "activation": "tanh"}),
    ("RowConv2D", (16, 3), {"activation": "tanh"}),
    ("FillPadding2D", (((1, 1), (1, 1)),), None),
    ("RowConnected2D", (16, 3), {"lat_mode": "edge", "use_bias": False}),
    ("Conv2D", (16, 3), {"activation": "tanh"}),
    ("AveragePooling2D", (2,), None),
    ("TFPadding2D", (((0, 1), (0, 0)),), {"mode": "REFLECT"}),
    ("TFPadding2D", (((0, 0), (1, 1)),), {"constant_values": 0.5}),
    ("AveragePooling2D", (2,), None),
    ("Reshape", ((-1,),), None),
    ("Dense", (64,), {"activation": "tanh"}),
    ("Linear", (64, 32), None),
    ("TorchReshape", ((-1, 2, 16),), None),
]


def check_layers(torch, dev):
    """The model of LAYER_SPECS at B=16 from a seed on the card against
    the CPU with the same weights, fp32 forward within TOL_F32; its
    forward time; no kernel launch."""
    from dlwp_torch import build_sequential, flax_tree, load_flax_params
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    x = np.random.RandomState(12).randn(16, 3, NLAT, NLON).astype(np.float32)
    card = build_sequential(LAYER_SPECS, device=dev)
    card.init(torch.from_numpy(x), seed=5)
    cpu = build_sequential(LAYER_SPECS, device="cpu")
    load_flax_params(cpu, flax_tree(card))
    xd = torch.from_numpy(x).to(dev)
    reset_launch_counts()
    with torch.inference_mode():
        got = card(xd).cpu().numpy()
        want = cpu(torch.from_numpy(x)).numpy()
        ms = timed_ms(lambda: card(xd), reps=5, inner=5)
    counts = launch_counts()
    err = float(np.abs(got - want).max())
    out = {"shape": list(got.shape), "max_abs_err": err, "ms": ms,
           "launches": counts,
           "layers": [type(l).__name__ for l in card.layers]}
    log(f"layers: {len(LAYER_SPECS)} specs ({', '.join(out['layers'])}) "
        f"at B=16 on (3, {NLAT}, {NLON}) -> {tuple(got.shape)}: card vs CPU "
        f"max abs {err:.3e} (limit {TOL_F32}), {ms:.3f} ms a forward")
    if not np.isfinite(got).all() or not err <= TOL_F32:
        raise AssertionError(f"layers: {out}")
    if set(counts.values()) != {0}:
        raise AssertionError(f"layers launched kernels: {counts}")
    return out


def skip_specs():
    """SkipTower(c_out=4, width=32, time_steps=2, lstm_features=8) on the
    flagship input, its output shaped (B, TD, C, H, W) as the flagship's."""
    from dlwp_torch import SkipTower

    return [SkipTower(TD * C, width=32, time_steps=TD, lstm_features=8),
            ("Reshape", ((TD, C, NLAT, NLON),), None)]


def run_skip_tower(torch, dev):
    """SkipTower at the flagship's shapes: predict(32) at B=64 on the card
    (gate launches counted, no conv-pool) against the CPU with the
    forecast's fp32 limits, timed (grid points/s, device time, idle);
    then 3 train steps against the CPU with the training phase's limits,
    ``TOL_TRAIN``."""
    from dlwp_torch import TimeSeriesEstimator, flax_tree
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    torch.set_num_threads(os.cpu_count() or 1)
    net, sampler = flagship_stack(dev, specs=skip_specs())
    net.init(sampler.generate(np.arange(1))[0], seed=0)
    cpu, cpu_sampler = flagship_stack("cpu", specs=skip_specs())
    cpu.load_flax_params(flax_tree(net.base_model))
    est = TimeSeriesEstimator(net, sampler)
    reset_launch_counts()
    fc = est.predict(STEPS, samples=np.arange(B))
    torch.cuda.synchronize()
    counts = launch_counts()
    # SkipTower's 3x3 convs 1 and 2 and its dilation-1 UpConv2D take the
    # cyclic conv; the dilation-2 UpConv2D and the 5x5 conv do not.
    need = expected_counts(lstm_gates=STEPS, cyclic_conv=3 * STEPS)
    log(f"skip_tower: predict({STEPS}) at B={B}: {fc.values.shape}, "
        f"launches {counts}")
    if counts != need:
        raise AssertionError(f"skip_tower launches {counts} != {need}")
    if fc.values.shape != (STEPS * TD, B, C, NLAT, NLON) or not (
            np.isfinite(fc.values).all()):
        raise AssertionError(f"skip_tower forecast {fc.values.shape}")
    out = {"launches": counts, "forecast_vs_cpu": forecast_vs_cpu(
        fc, cpu, cpu_sampler, "fp32", "skip_tower forecast")}
    x0, days, ms, _ = est.prepare_inputs(np.arange(B))
    rollout = est.rollout_fn(STEPS)
    elapsed = timed_ms(lambda: rollout(x0, days, ms), reps=5, inner=1,
                       warmup=1) / 1e3
    device = profile_steps(torch, est, x0, days, ms, "skip_tower")
    out.update(elapsed_s=elapsed,
               grid_points_per_s=B * STEPS * NLAT * NLON / elapsed,
               device_ms_per_step=device,
               idle_share=1 - device / (elapsed * 1e3 / STEPS))
    log(f"skip_tower rollout: {elapsed * 1e3:.2f} ms per predict({STEPS}) at "
        f"B={B} -> {out['grid_points_per_s'] / 1e6:.2f} Mgp/s; device "
        f"{device:.3f} ms a step (idle {100 * out['idle_share']:.1f}%)")
    # The first gradient against the CPU's backward at the card's forward
    # values: a max-pool window with a near tie, which the two fp32
    # forwards' last bits resolve differently, routes the gradient to
    # another input; on an H100 that moves SkipTower's first gradient
    # 8.5e-5 (relative RMS) from the CPU's own, and 4.2e-7 from the
    # forced one (both printed, with the pool's differing windows).
    out["train"] = train_vs_cpu(
        torch, dev, 1, make_specs=skip_specs, pools=0, convs=3,
        label="skip_tower train", force=True,
        pooled={"layers.0.CyclicConv2D_1": 32})
    return out


VERIFY_FRACTION, VERIFY_ITERS, VERIFY_LATS = 0.2, 6, (20.0, 70.0)
VERIFY_INIT_BATCH = 256
TOL_VERIFY = 1e-4


def validate_rows(torch, dlwp, data=None, fraction=VERIFY_FRACTION,
                  iters=VERIFY_ITERS, barotropic=None, device=None):
    """``examples/validate.py``'s scoring on ``dlwp`` (by default with its
    defaults on the flagship dataset: the last 20% held out, 12 model
    steps): the forecast from every validation window in init batches of
    256, the verification of ``verification_from_series``, and the
    forecast, persistence, constant-climatology, (over a year or more)
    monthly-climatology and, with ``barotropic`` (a form), barotropic
    RMSE rows of HGT/500 over 20-70N, in the data's scaled units. Returns
    (f_hour, rows, inits, predict seconds, masked (init, lead) pairs)."""
    from dlwp_torch import SeriesSampler, TimeSeriesEstimator
    from dlwp_torch.forecast import verify

    data = flagship_dataset(TRAIN_N) if data is None else data
    n = data.predictors.shape[0]
    val_data = data.isel_sample(np.arange(n - int(n * fraction), n))
    val_gen = SeriesSampler(val_data, model=dlwp, input_time_steps=TD,
                            output_time_steps=TD, batch_size=64,
                            add_insolation=True)
    est = TimeSeriesEstimator(dlwp, val_gen)
    t0 = time.perf_counter()
    forecast = est.predict(iters, init_batch_size=VERIFY_INIT_BATCH)
    predict_s = time.perf_counter() - t0
    steps_out = forecast.values.shape[0]
    ver, f_hour = verify.verification_from_series(
        val_data, forecast_steps=steps_out, dt_hours=int(est._dt_hours),
        init_times=forecast.times, all_data=data)
    out_idx = val_data.varlev_index(forecast.varlev)
    ver = ver[:, :, out_idx]
    v = forecast.varlev.index("HGT/500")
    lat = np.asarray(data.lat)
    lat_sel = np.where((lat >= VERIFY_LATS[0]) & (lat <= VERIFY_LATS[1]))[0]
    fc_v = forecast.values[:, :, v][..., lat_sel, :]
    ver_v = ver[:, :, v][..., lat_sel, :]
    axis = tuple(range(1, ver_v.ndim))
    rows = {"forecast_rmse": verify.forecast_error(fc_v, ver_v, "rmse",
                                                   axis)}
    init_idx = [int(np.where(np.asarray(val_data.sample) == t)[0][0])
                for t in forecast.times]
    init = np.asarray(val_data.predictors)[init_idx][:, out_idx][:, v]
    rows["persistence_rmse"] = verify.forecast_error(
        np.repeat(init[..., lat_sel, :][None], steps_out, axis=0), ver_v,
        "rmse", axis)
    series = np.asarray(val_data.predictors)[:, out_idx][:, v][..., lat_sel, :]
    rows["climatology_rmse"] = verify.forecast_error(
        np.broadcast_to(np.nanmean(series, axis=0),
                        (steps_out,) + ver_v.shape[1:]), ver_v, "rmse", axis)
    times = np.asarray(data.sample, dtype="datetime64[ns]")
    if (times.max() - times.min()) / np.timedelta64(1, "D") >= 360.0:
        full = np.asarray(data.predictors)[:, out_idx][:, v][..., lat_sel, :]
        months = times.astype("datetime64[M]").astype(int) % 12
        climo12 = np.stack([np.nanmean(full[months == m], axis=0)
                            if (months == m).any()
                            else np.full(full.shape[1:], np.nan)
                            for m in range(12)])
        lead = ((np.arange(steps_out) + 1)
                * int(round(est._dt_hours * 60))).astype("timedelta64[m]")
        ver_m = (np.asarray(forecast.times, dtype="datetime64[ns]")[None]
                 + lead[:, None]).astype("datetime64[M]").astype(int) % 12
        rows["monthly_climo_rmse"] = verify.forecast_error(
            climo12[ver_m], ver_v, "rmse", axis)
    if barotropic:
        rows["barotropic_rmse"] = barotropic_baseline(
            data, val_data, forecast, ver, v, est._dt_hours, steps_out,
            lat_sel, form=barotropic, device=device)
    masked = int(np.isnan(ver).all(axis=(2, 3, 4)).sum())
    return f_hour, rows, len(forecast.times), predict_s, masked


def barotropic_baseline(*args, **kwargs):
    """``validate``'s barotropic physics baseline
    (:func:`dlwp_torch.examples.validate.barotropic_baseline`): from the
    unscaled variable at each init time, a float32 core (T42 or
    ``truncation``) run to every lead on ``device`` (None -> ``cuda``),
    scaled back and scored as the RMSE row over ``lat_sel``."""
    from dlwp_torch.examples.validate import barotropic_baseline as baseline

    return baseline(*args, **kwargs)


def trained_flagship(torch, dev):
    """device_train's trained model, or the same fit_device run (S=1, the
    chain, TRAIN_EPOCHS epochs) when that phase did not run."""
    if "net" not in _TRAINED:
        net, train, val = device_stack(dev)
        net.fit_generator(train, validation_data=val, epochs=TRAIN_EPOCHS,
                          verbose=False)
        _TRAINED["net"] = net
    return _TRAINED["net"]


def run_verify(torch, dev):
    """``examples/validate.py``'s flow on the model fit_device trained, on
    the card and on the CPU with its weights: every RMSE row within
    TOL_VERIFY relative; the table printed."""
    from dlwp_torch import flax_tree
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    torch.set_num_threads(os.cpu_count() or 1)
    card = trained_flagship(torch, dev)
    cpu, _, _ = train_stack("cpu")
    cpu.load_flax_params(flax_tree(card.base_model))
    reset_launch_counts()
    f_hour, rows, n_init, card_s, _ = validate_rows(torch, card)
    counts = launch_counts()
    _, rows_cpu, _, cpu_s, _ = validate_rows(torch, cpu)
    rel = max(float(np.max(np.abs(rows[k] - rows_cpu[k])
                           / np.abs(rows_cpu[k]))) for k in rows)
    log(f"verify: validate.py's flow on the trained flagship, {n_init} "
        f"inits x {len(f_hour)} leads, predict {card_s:.2f} s on the card "
        f"(launches {counts}), {cpu_s:.1f} s on the CPU; rows card vs CPU "
        f"max relative {rel:.3e} (limit {TOL_VERIFY})"
        + ("" if "monthly_climo_rmse" in rows else "; the series spans "
           "under a year, so no monthly-climatology row (as validate.py)"))
    log(f"  {'f_hour':>8} " + " ".join(f"{k:>18}" for k in rows))
    for i, fh in enumerate(f_hour):
        log(f"  {int(fh):8d} " + " ".join(f"{rows[k][i]:18.6f}"
                                           for k in rows))
    if not all(np.isfinite(v).all() for v in rows.values()):
        raise AssertionError(f"verify rows not finite: {rows}")
    if not rel <= TOL_VERIFY:
        raise AssertionError(f"verify rows card vs CPU: {rel}")
    need = expected_counts(fused_conv_pool=2 * VERIFY_ITERS,
                           lstm_gates=VERIFY_ITERS,
                           cyclic_conv=4 * VERIFY_ITERS)
    if counts != need:
        raise AssertionError(f"verify launches {counts} != {need}")
    return {"f_hour": f_hour.tolist(),
            "rows": {k: v.tolist() for k, v in rows.items()},
            "rows_max_rel": rel, "launches": counts, "inits": n_init,
            "predict_s": card_s}


def profile_steps(torch, est, x0, days, ms, tag, steps=4, names=None):
    """Device time by kernel over a short rollout (torch.profiler); returns
    the device kernel ms per step."""
    rollout = est.rollout_fn(steps)
    return profile_device(torch, lambda: rollout(x0, days, ms),
                          f"rollout({steps}) {tag}", per=steps, unit="step",
                          names=names)


def profile_device(torch, fn, label, per=1, unit="call", names=None):
    """Device kernel time by name over one call of ``fn`` after a warm-up
    call (torch.profiler); returns the device kernel ms per ``unit``, of
    which one call holds ``per``, and fills ``names`` (if given) with
    {kernel name: (device ms, launches) per unit}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # torch.optim's step annotation spans its kernels on the device
    # timeline; it is a range, not a kernel, and is left out.
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type.name == "CUDA"
            and not e.key.startswith("Optimizer.")]
    total = sum(e.device_time_total for e in rows)
    if names is not None:
        names.update({e.key: (e.device_time_total / 1e3 / per, e.count / per)
                      for e in rows})
    log(f"profile of {label}: device kernel time {total / 1e3:.3f} ms")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:12]:
        log(f"  {e.device_time_total / 1e3 / per:9.4f} ms/{unit} "
            f"{100 * e.device_time_total / max(total, 1):5.1f}%  "
            f"x{e.count // per:<3d} {e.key[:90]}")
    return total / 1e3 / per


def bench_height(grid):
    """The analytic 500 hPa height that ``bench.py:190-194`` integrates."""
    lat = np.radians(grid.lat)[:, None]
    lon = np.radians(grid.lon)[None, :]
    return (5500.0 - 300.0 * np.sin(lat) ** 2
            + 80.0 * np.cos(lat) ** 3 * np.cos(3 * lon)).astype(np.float32)


def perturbed_height(grid, seed=7):
    """The bench height plus smooth random waves in zonal wavenumbers
    1..24, so that more than the bench's m = 0 and 3 carry signal; stable
    for the 40-step checks."""
    rng = np.random.RandomState(seed)
    lat = np.radians(grid.lat)[:, None]
    lon = np.radians(grid.lon)[None, :]
    pert = sum(10.0 * rng.randn() * np.cos(lat) ** m
               * np.sin((m % 5 + 1) * lat + rng.rand())
               * np.cos(m * lon + 2 * np.pi * rng.rand())
               for m in range(1, 25))
    return (bench_height(grid) + pert).astype(np.float32)


def example_heights(grid, n_init=4):
    """The 500 hPa heights of the example's synthetic source
    (``examples/_synthetic.py``) at its first ``n_init`` 6-hourly times,
    without its per-time noise."""
    lat = np.radians(grid.lat)[:, None]
    lon = np.radians(grid.lon)[None, :]
    t = np.arange(n_init)[:, None, None] * 6 / 24.0  # days
    return (5500.0 - 300.0 * np.sin(lat) ** 2
            + 120.0 * np.cos(lat) ** 3 * np.cos(3 * (lon - 0.12 * t))
            + 60.0 * np.cos(lat) ** 2 * np.sin(2 * (lon + 0.07 * t) + 1.0)
            + 30.0 * np.sin(2 * np.pi * t / 365.0) * np.sin(lat)
            ).astype(np.float32)


def baro_model(form, nlat, nlon, T, device, **kw):
    """``form``: 'psi', 'psi_no_sh' (correct_sh=False) or 'vrt'."""
    from dlwp_torch import BarotropicModel, BarotropicModelPsi, LatLonGrid

    grid = LatLonGrid.regular(nlat, nlon)
    kw = dict(dt=1800.0, damping_coefficient=5e-6, device=device, **kw)
    if form == "vrt":
        return BarotropicModel(grid, T, **kw)
    return BarotropicModelPsi(grid, T, correct_sh=form == "psi", **kw)


def state_parts(state):
    return [x.contiguous() for x in (
        state.vrt_spec.real, state.vrt_spec.imag,
        state.vrt_spec_prev.real, state.vrt_spec_prev.imag)]


def baro_work(form, M, J, L, n_steps):
    """(bytes, flops) of one launch of ``n_steps``: every table and the
    state read once, the state written once; per step the Legendre
    contractions over the valid (m, n >= m) pairs, the dense DFT products,
    the grid products and the update."""
    from dlwp_torch.kernels.barotropic_step import table_shapes

    tri = M * (M + 1) // 2
    if form == "vrt":
        step = (12 * tri * J + 12 * L * M * J + 4 * L * J + 8 * M * L * J
                + 8 * tri * J + 20 * tri)
    else:
        step = (16 * tri * J + 16 * L * M * J + 3 * L * J + 4 * M * L * J
                + 4 * tri * J + 20 * tri)
    tables = sum(int(np.prod(s)) for s in table_shapes(
        "vrt" if form == "vrt" else "psi", M, J, L).values())
    return 4 * (tables + 8 * M * M), step * n_steps


def check_barotropic_kernel(torch, dev):
    """Kernel vs plain version at T24 and T72, and bit-equal resume; a
    plain dict of tables (not packed) refused; returns the largest max |dz|
    in metres."""
    from dlwp_torch.kernels import barotropic_step, barotropic_step_plain

    worst = 0.0
    for nlat, nlon, T, n in ((37, 72, 24, 20), (73, 144, 72, 40)):
        for form in ("psi", "psi_no_sh", "vrt"):
            m = baro_model(form, nlat, nlon, T, dev, step_impl="kernel")
            z0 = (100.0 * np.random.RandomState(1).randn(nlat, nlon)
                  if T == 24 else perturbed_height(m.grid))
            s0 = m.from_z(z0)
            args = (m._kernel_form, m._kernel_tables, *state_parts(s0), 0, n,
                    m.dt, m.robert_coefficient)
            got = barotropic_step(*args)
            torch.cuda.synchronize()
            want = barotropic_step_plain(*args)
            zs = [m.z_grid(type(s0)(torch.complex(v[0], v[1]), s0.vrt_spec,
                                    n, s0.t)) for v in (got, want)]
            dz = (zs[0] - zs[1]).abs().max().item()
            rel = dz / zs[1].abs().max().item()
            s20 = m.run(s0, 20)
            s2 = m.run(m.run(s0, 7), 13)
            torch.cuda.synchronize()
            same = (torch.equal(s2.vrt_spec, s20.vrt_spec)
                    and torch.equal(s2.vrt_spec_prev, s20.vrt_spec_prev))
            log(f"check barotropic_step T{T} {nlat}x{nlon} {form} {n} steps: "
                f"max|dz| {dz:.3e} m, relative {rel:.3e}; 7+13 == 20: {same}; "
                f"{barotropic_step.grid_blocks} blocks")
            if not (np.isfinite(rel) and rel <= TOL_BARO[T]):
                raise AssertionError(f"barotropic_step T{T} {form}: {rel}")
            if not same:
                raise AssertionError(f"barotropic_step T{T} {form}: resume")
            worst = max(worst, dz)
    try:
        barotropic_step(args[0], dict(args[1]), *args[2:])
    except ValueError as e:
        log(f"check barotropic_step refuses unpacked tables: {e}")
    else:
        raise AssertionError("barotropic_step took a plain dict of tables")
    return worst


def rel_rms(got, want):
    return ((got - want).abs().pow(2).mean().sqrt()
            / want.abs().pow(2).mean().sqrt()).item()


def run_barotropic_path(torch, dev):
    """The bench configuration through ``run_with_snapshots(24, 12)`` on the
    card (kernel) and on the CPU (plain engine), then its wall and device
    time on the card; returns the launches and the times by form."""
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    launches, profiles = {}, {}
    for form in ("psi", "vrt"):
        card = baro_model(form, 73, 144, 72, None, step_impl="kernel")
        z = bench_height(card.grid)
        reset_launch_counts()
        t0 = time.perf_counter()
        final, times, zs = card.run_with_snapshots(card.from_z(z), BARO_SNAPS,
                                                   BARO_EVERY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        launches[form] = counts["barotropic_step"]
        log(f"barotropic path {form}: run_with_snapshots({BARO_SNAPS}, "
            f"{BARO_EVERY}) in {wall * 1e3:.1f} ms (first call, host clock), "
            f"launches {counts}")
        need = expected_counts(barotropic_step=BARO_SNAPS)
        if counts != need:
            raise AssertionError(f"barotropic {form} launches {counts}")
        if zs.shape != (BARO_SNAPS, 73, 144) or not (
                torch.isfinite(zs).all() and torch.isfinite(final.vrt_spec)
                .all()):
            raise AssertionError(f"barotropic {form}: bad output {zs.shape}")
        cpu = baro_model(form, 73, 144, 72, "cpu")
        c_final, c_times, c_zs = cpu.run_with_snapshots(cpu.from_z(z),
                                                        BARO_SNAPS, BARO_EVERY)
        if not torch.equal(times, c_times):
            raise AssertionError(f"barotropic {form}: snapshot times differ")
        per_snap = [rel_rms(zs[i].cpu(), c_zs[i]) for i in range(BARO_SNAPS)]
        final_rrms = rel_rms(final.vrt_spec.cpu(), c_final.vrt_spec)
        log(f"barotropic path {form} vs CPU plain engine, relative RMS of z "
            f"at each 6-hourly snapshot: "
            + " ".join(f"{x:.2e}" for x in per_snap))
        log(f"barotropic path {form}: final vrt_spec relative RMS "
            f"{final_rrms:.3e} after {BARO_SNAPS * BARO_EVERY} steps; times "
            f"equal the plain engine's ({float(times[-1]) / 3600:.0f} h)")
        if not final_rrms <= TOL_BARO_RRMS:
            raise AssertionError(f"barotropic {form}: {final_rrms}")
        s0 = card.from_z(z)

        def path():
            return card.run_with_snapshots(s0, BARO_SNAPS, BARO_EVERY)

        wall = timed_ms(path, reps=3, inner=1, warmup=1)
        device = profile_device(
            torch, path, f"barotropic run_with_snapshots({BARO_SNAPS}, "
            f"{BARO_EVERY}) {form}")
        log(f"barotropic path {form}: {wall:.3f} ms per run_with_snapshots "
            f"(CUDA events, median of 3), device kernel time {device:.3f} "
            f"ms: idle {100 * (1 - device / wall):.1f}%")
        profiles[form] = {"wall_ms": wall, "device_ms": device}
    return launches, profiles


def run_example_flow(torch, dev):
    """``examples/run_barotropic.py``'s default flow: 4 batched init times
    at T42 through the plain engine, on the card and on the CPU."""
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    card = baro_model("psi", 73, 144, 42, dev)
    cpu = baro_model("psi", 73, 144, 42, "cpu")
    z0 = example_heights(card.grid)
    reset_launch_counts()
    card.run_with_snapshots(card.from_z(z0), 1, 1)  # warm-up (cuFFT plans)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, times, zs = card.run_with_snapshots(card.from_z(z0), BARO_SNAPS,
                                           BARO_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, c_times, c_zs = cpu.run_with_snapshots(cpu.from_z(z0), BARO_SNAPS,
                                              BARO_EVERY)
    rrms = rel_rms(zs.cpu(), c_zs)
    steps = z0.shape[0] * BARO_SNAPS * BARO_EVERY
    log(f"example flow (4 init times, T42, plain engine): {zs.shape} in "
        f"{wall:.3f} s on the card ({steps / wall:.0f} member-steps/s, "
        f"host clock); relative RMS of z vs the CPU {rrms:.3e}; launches "
        f"{launch_counts()}")
    if launch_counts()["barotropic_step"] != 0:
        raise AssertionError("batched states must run the plain engine")
    if zs.shape != (BARO_SNAPS, 4, 73, 144) or not torch.isfinite(zs).all():
        raise AssertionError(f"example flow: bad output {zs.shape}")
    if not (torch.equal(times, c_times) and rrms <= TOL_BARO_RRMS):
        raise AssertionError(f"example flow vs CPU: {rrms}")
    return {"wall_s": wall, "member_steps_per_s": steps / wall,
            "rel_rms_vs_cpu": rrms}


def slope_ms(fn, reps=3):
    """ms per step of ``fn(k)``: the two-point slope of BARO_SLOPE_N and
    4x as many steps (CUDA events, median of ``reps`` after warm-up)."""
    n = BARO_SLOPE_N
    t1 = timed_ms(lambda: fn(n), reps=reps, inner=1, warmup=1)
    t4 = timed_ms(lambda: fn(4 * n), reps=reps, inner=1, warmup=1)
    return (t4 - t1) / (3 * n)


def ptxas_resources(name):
    """{entry: {registers, spill_stores, spill_loads, stack}} from the
    ``-Xptxas -v`` report kept beside the library of ``csrc/<name>.cu``."""
    import re

    from dlwp_torch.kernels import _build

    out, entry = {}, None
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            out[entry] = {}
        elif entry and "spill stores" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            out[entry].update(stack=nums[0], spill_stores=nums[1],
                              spill_loads=nums[2])
        elif entry and "registers" in line:
            out[entry]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


# Stages of a kernel step between block 0's clock stamps (STAMPS of them,
# kernels/barotropic_step.py): (name, from stamp, to stamp); "sync 1"
# runs from stamp 11 to the next step's stamp 0.
BARO_STAGES = (
    ("B load modes", 0, 1), ("B inverse DFT", 1, 2),
    ("B sums, products", 2, 3), ("B forward DFT", 3, 4),
    ("B sums, store", 4, 5), ("sync 2", 5, 6), ("C load", 6, 7),
    ("C analysis", 7, 8), ("C sums, step", 8, 9), ("A sums", 9, 10),
    ("A combine, store", 10, 11))


def stage_split(torch, launch, ms_per_step, n=64):
    """us a step in each stage of the kernel, from block 0's clock64()
    stamps over ``n`` steps of the timing build (steps 4..n-2), scaled so
    that a step's cycles take ``ms_per_step``."""
    from dlwp_torch.kernels.barotropic_step import STAMPS

    clocks = torch.zeros(n, STAMPS, dtype=torch.int64, device="cuda")
    launch(n, clocks)
    torch.cuda.synchronize()
    c = clocks.cpu().numpy().astype(np.float64)[4:n - 1]
    cyc = {name: float(np.mean(c[:, b] - c[:, a]))
           for name, a, b in BARO_STAGES}
    cyc["sync 1"] = float(np.mean(c[1:, 0] - c[:-1, 11]))
    per_step = float(np.mean(c[1:, 0] - c[:-1, 0]))
    return {k: 1e3 * ms_per_step * v / per_step for k, v in cyc.items()}


def time_barotropic(torch, dev):
    """ms per step (two-point slope of BARO_SLOPE_N and 4x as many steps)
    of the kernel, its plain version and the plain engine, per form; the
    kernel's sync probe on the kernel's grid and on other block counts;
    the same at T24 on 37x72; the kernel's registers and spills."""
    from dlwp_torch.kernels import barotropic_step, barotropic_step_plain
    from dlwp_torch.kernels.barotropic_step import FORMS, _launch, sync_probe

    resources = ptxas_resources("barotropic_step")
    rows = {}
    for form in ("psi", "vrt"):
        m = baro_model(form, 73, 144, 72, dev, step_impl="kernel")
        plain = baro_model(form, 73, 144, 72, dev)
        s0 = m.from_z(bench_height(m.grid))
        parts = state_parts(s0)
        tabs = m._kernel_tables
        M, J, L = 73, 73, 144

        def kernel(k):
            return barotropic_step(m._kernel_form, tabs, *parts, 0, k, m.dt,
                                   m.robert_coefficient)

        def plain_version(k):
            return barotropic_step_plain(m._kernel_form, tabs, *parts, 0, k,
                                         m.dt, m.robert_coefficient)

        def plain_engine(k):
            return plain.run(s0, k)

        row = {name: slope_ms(fn) for name, fn in (
            ("ms", kernel), ("plain_ms", plain_version),
            ("plain_engine_ms", plain_engine))}
        row["grid_blocks"] = barotropic_step.grid_blocks
        # The sync probe: the kernel's two grid syncs a step alone, on the
        # same grid with the same shared memory; kernel - probe = phases.
        row["sync_ms"] = slope_ms(lambda k: sync_probe(form, M, J, L, k))
        row["phase_ms"] = row["ms"] - row["sync_ms"]
        row["sync_ms_by_blocks"] = {
            b: slope_ms(lambda k: sync_probe(form, M, J, L, k, b))
            for b in SYNC_PROBE_BLOCKS}
        row["stage_us"] = stage_split(torch, lambda k, clk: _launch(
            m._kernel_form, tabs, parts, 0, k, m.dt, m.robert_coefficient,
            clocks=clk), row["ms"])
        row["phase_us"] = {ph: sum(v for k, v in row["stage_us"].items()
                                   if k.startswith(ph))
                           for ph in ("A ", "B ", "C ", "sync ")}
        row["launch_ms_12_steps"] = timed_ms(lambda: kernel(BARO_EVERY),
                                             reps=5, inner=20, warmup=3)
        nbytes, flops = baro_work(form, M, J, L, BARO_EVERY)
        # Per step at the main path's launch of BARO_EVERY steps.
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes / BARO_EVERY,
                                                    flops / BARO_EVERY)
        row["bytes_per_launch"], row["flops_per_step"] = (
            nbytes, flops // BARO_EVERY)
        # The same kernel at T24 on 37x72 (~11x less work a step): what
        # does not shrink with the work is the fixed cost.
        small = baro_model(form, 37, 72, 24, dev, step_impl="kernel")
        sp = state_parts(small.from_z(bench_height(small.grid)))

        def kernel_t24(k):
            return barotropic_step(small._kernel_form, small._kernel_tables,
                                   *sp, 0, k, small.dt,
                                   small.robert_coefficient)

        row["ms_T24"] = slope_ms(kernel_t24)
        row["grid_blocks_T24"] = barotropic_step.grid_blocks
        row["sync_ms_T24"] = slope_ms(
            lambda k: sync_probe(form, 25, 37, 72, k))
        row["ptxas"] = {e: r for e, r in resources.items()
                        if f"barotropic_kernelILi{FORMS[form]}E" in e}
        log(f"timing barotropic_step {form} T72 73x144, ms per step: kernel "
            f"{row['ms']:.5f} ({1e3 / row['ms']:.0f} steps/s, "
            f"{row['grid_blocks']} blocks), of which the sync probe "
            f"{row['sync_ms']:.5f} ({100 * row['sync_ms'] / row['ms']:.1f}%) "
            f"and the phases {row['phase_ms']:.5f}; sync probe by blocks "
            + ", ".join(f"{b}: {t:.5f}" for b, t in
                        row["sync_ms_by_blocks"].items())
            + f"; plain version {row['plain_ms']:.5f}, plain engine "
            f"{row['plain_engine_ms']:.5f}, bound {row['bound_ms']:.6f} "
            f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.2f}% "
            f"of it); one {BARO_EVERY}-step launch "
            f"{row['launch_ms_12_steps']:.4f} ms")
        log(f"timing barotropic_step {form} T24 37x72, ms per step: kernel "
            f"{row['ms_T24']:.5f} ({row['grid_blocks_T24']} blocks), sync "
            f"probe {row['sync_ms_T24']:.5f}")
        log(f"barotropic_step {form} T72 stages, us a step (block 0's "
            f"clocks): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     row["stage_us"].items())
            + "; by phase " + ", ".join(f"{k.strip()} {v:.3f}" for k, v in
                                        row["phase_us"].items()))
        log(f"barotropic_step {form} -Xptxas -v: {row['ptxas']}")
        rows[form] = row
    return rows


def virtual_mesh(dev, data, lat, lon=1):
    """A (data, lat) mesh, or (data, lat, lon) with ``lon`` > 1, whose
    entries all name ``dev``."""
    from dlwp_torch.parallel import MeshConfig, build_mesh

    return build_mesh(MeshConfig(data=data, lat=lat, lon=lon),
                      devices=[dev] * (data * lat * lon))


def mesh_spec(mesh):
    """The flagship input's batch spec on ``mesh``: SHARD_SPEC, with the
    longitude axis named when the mesh has one."""
    return SHARD_SPEC[:-1] + ("lon" if "lon" in mesh.axis_names else None,)


def max_err(got, want):
    return max((a - b).abs().max().item()
               for ra, rb in zip(got, want) for a, b in zip(ra, rb))


def check_parallel_kernels(torch, dev):
    """The lat-band kernels against their plain versions on every mesh of
    PAR_MESHES; returns the largest |kernel - plain| per kernel."""
    from dlwp_torch.kernels import (
        halo_exchange, halo_exchange_plain, overlap_conv, overlap_conv_db,
        overlap_conv_plain,
    )
    from dlwp_torch.parallel.mesh import split_shards

    g = torch.Generator(device=dev).manual_seed(1)
    errs = {"halo_exchange": 0.0, "overlap_conv": 0.0, "overlap_conv_db": 0.0}
    halo_cases = [(name, shape, kh, d, torch.float32)
                  for name, shape, _, kh, d in HALO_CONVS]
    halo_cases += [("odd W=18", (5, 3, 8, 18), 3, 1, torch.float32),
                   ("odd 0-sided (0, 1)", (5, 3, 8, 18), None, (0, 1),
                    torch.float32),
                   ("odd 0-sided (1, 0) bf16", (3, 2, 8, 18), None, (1, 0),
                    torch.bfloat16),
                   ("odd bf16 (1, 2)", (3, 2, 8, 18), None, (1, 2),
                    torch.bfloat16)]
    # (name, x shape, O, chunk of overlap_conv_db): the flagship's, then
    # ragged widths (18, 72, 144), channels (3, 12, 32, 128) and outputs
    # (7, 48, 64), padded chunks.
    conv_cases = [(name, shape, o, ch) for (name, shape, o), ch in
                  zip(OVERLAP_CONVS, (5, 11, 4))]
    conv_cases += [("odd W=18 B=5 chunk 2", (5, 3, 8, 18), 7, 2),
                   ("odd W=72 B=6 chunk 4", (6, 12, 8, 72), 48, 4),
                   ("odd W=144 C=128 O=7 chunk 3", (4, 128, 8, 144), 7, 3),
                   ("odd W=18 C=32 O=64 chunk 5", (6, 32, 8, 18), 64, 5)]
    for data, lat in PAR_MESHES:
        mesh = virtual_mesh(dev, data, lat)
        tag = f"data={data} lat={lat}"
        for name, shape, kh, d, dtype in halo_cases:
            if shape[2] % lat or shape[0] % data:
                continue
            halo = d if kh is None else ((kh - 1) * d // 2,
                                         (kh - 1) * d - (kh - 1) * d // 2)
            x = torch.randn(shape, device=dev, generator=g).to(dtype)
            shards = split_shards(x, mesh, "data", "lat")
            got = halo_exchange(shards, halo)
            torch.cuda.synchronize()
            want = halo_exchange_plain(shards, halo)
            same = all_equal(got, want)
            log(f"check halo_exchange {tag} {name} {shape} halo {halo} "
                f"{dtype}: bit-equal {same}")
            if not same:
                raise AssertionError(f"halo_exchange {tag} {name} differs")
        for name, shape, o, chunk in conv_cases:
            if shape[2] % lat or shape[2] // lat < 2 or shape[0] % data:
                continue
            x = torch.randn(shape, device=dev, generator=g)
            k = torch.randn(o, shape[1], 3, 3, device=dev,
                            generator=g) / (9 * shape[1]) ** 0.5
            shards = split_shards(x, mesh, "data", "lat")
            want = overlap_conv_plain(shards, k)
            outs = {}
            for kname, wrapper, fn in (
                    ("overlap_conv", overlap_conv, overlap_conv),
                    ("overlap_conv_db", overlap_conv_db,
                     lambda s, kk: overlap_conv_db(s, kk, chunk))):
                got = outs[kname] = fn(shards, k)
                plan, grid = wrapper.last_launch
                # The same shards from a base 4 bytes past 16-byte
                # alignment: the 4-byte copy path, the same sums.
                odd = fn(unaligned(torch, shards), k)
                torch.cuda.synchronize()
                err = max_err(got, want)
                same = all_equal(got, odd)
                log(f"check {kname} {tag} {name} {shape}->{o}"
                    f"{f' chunk {chunk}' if kname.endswith('db') else ''}: "
                    f"max|kernel-plain| = {err:.3e}; unaligned copy "
                    f"bit-equal {same}; tile {plan.bb}x{plan.rb}, "
                    f"{plan.warps} warps, {plan.stages} stages, "
                    f"{plan.tiles} tiles, grid {grid}")
                if not (err <= TOL_F32 and same):
                    raise AssertionError(f"{kname} {tag} {name}: {err}, "
                                         f"unaligned equal {same}")
                errs[kname] = max(errs[kname], err)
            if not all_equal(outs["overlap_conv"], outs["overlap_conv_db"]):
                raise AssertionError(f"overlap_conv != overlap_conv_db bit "
                                     f"for bit: {tag} {name}")
    return errs


def all_equal(got, want):
    import torch

    return all(torch.equal(a, b) for ra, rb in zip(got, want)
               for a, b in zip(ra, rb))


def unaligned(torch, shards):
    """Contiguous copies of ``shards`` whose data starts one float past a
    16-byte boundary (as a batch-piece view can)."""
    out = []
    for row in shards:
        out.append([])
        for s in row:
            buf = torch.empty(s.numel() + 4, device=s.device, dtype=s.dtype)
            view = buf[1:1 + s.numel()].view(s.shape)
            view.copy_(s)
            out[-1].append(view)
    return out


def dispatch_launches(torch, cpu_model, batch):
    """Kernel launches of one forward of the lat=2 sharded flagship on one
    card, derived from the port's own dispatch: one forward of the same
    model on the CPU (plain versions) with every kernel wrapper's call
    sites recorded; on a one-card mesh each call is one launch."""
    from unittest import mock

    import dlwp_torch.models.layers as layers
    import dlwp_torch.parallel.pallas_halo as ph
    import dlwp_torch.parallel.pallas_overlap as po

    calls = expected_counts()

    def recorded(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return mock.patch.object(module, name, wrapper)

    x = torch.zeros(batch, TD, C + 1, NLAT, NLON)
    with recorded(layers, "lstm_gates"), recorded(layers, "fused_conv_pool"), \
            recorded(layers, "cyclic_conv"), \
            recorded(ph, "halo_exchange"), recorded(po, "overlap_conv"), \
            recorded(po, "overlap_conv_db"), torch.inference_mode():
        cpu_model.base_model(x)
    return calls


def run_sharded_path(torch, dev):
    """The lat=2 spatial-parallel forecast on the card (the slice's main
    path) against the unsharded forecast and the CPU; then B=8, rates and
    the profile. Returns the launches per run and the measurements."""
    from dlwp_torch import TimeSeriesEstimator, flax_tree
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    card, sampler = flagship_stack(dev)
    card.init(sampler.generate(np.arange(1))[0], seed=0)
    sharded, sh_sampler = flagship_stack(dev, mesh=virtual_mesh(dev, 1, 2))
    sharded.base_model.share_params_from(card.base_model)
    cpu, cpu_sampler = flagship_stack(
        "cpu", mesh=virtual_mesh(torch.device("cpu"), 1, 2))
    cpu.load_flax_params(flax_tree(card.base_model))
    per_step = {b: dispatch_launches(torch, cpu, b) for b in (B, B_SMALL)}
    log(f"sharded path: launches per step from the dispatch: {per_step}")
    if per_step[B_SMALL]["overlap_conv"] == 0:
        raise AssertionError("B=8 does not reach overlap_conv")

    est = TimeSeriesEstimator(sharded, sh_sampler)
    reset_launch_counts()
    fc = est.predict(STEPS, samples=np.arange(B))
    torch.cuda.synchronize()
    counts = {"B64": launch_counts()}
    need = {k: STEPS * v for k, v in per_step[B].items()}
    log(f"sharded path: predict({STEPS}) at B={B} on data=1 x lat=2 of "
        f"one card: values {fc.values.shape}, launches {counts['B64']}")
    if counts["B64"] != need:
        raise AssertionError(f"sharded launches {counts['B64']} != {need}")
    if fc.values.shape != (STEPS * TD, B, C, NLAT, NLON) or not (
            np.isfinite(fc.values).all()):
        raise AssertionError(f"sharded: bad forecast {fc.values.shape}")
    ref = TimeSeriesEstimator(card, sampler).predict(STEPS,
                                                     samples=np.arange(B))
    result = {}
    for tag, want, got in (
            ("unsharded card", ref.values, fc.values),
            ("sharded CPU", None, fc.values[:, :4])):
        t0 = time.perf_counter()
        if want is None:
            want = TimeSeriesEstimator(cpu, cpu_sampler).predict(
                STEPS, samples=np.arange(4)).values
        step1 = float(np.abs(got[:TD] - want[:TD]).max())
        rrms = float(np.sqrt(np.mean((got - want) ** 2))
                     / np.sqrt(np.mean(want ** 2)))
        log(f"sharded path vs {tag} ({time.perf_counter() - t0:.1f} s): "
            f"step-1 max abs {step1:.3e}, {STEPS}-step relative RMS "
            f"{rrms:.3e}")
        if not (step1 <= TOL_STEP1["fp32"] and rrms <= TOL_TRAJ_RRMS["fp32"]):
            raise AssertionError(f"sharded vs {tag}: {step1}, {rrms}")
        result[f"vs {tag}"] = {"step1_max_abs": step1, "rel_rms": rrms}

    reset_launch_counts()
    small = est.predict(STEPS_SMALL, samples=np.arange(B_SMALL))
    torch.cuda.synchronize()
    counts["B8"] = launch_counts()
    need = {k: STEPS_SMALL * v for k, v in per_step[B_SMALL].items()}
    log(f"sharded path: predict({STEPS_SMALL}) at B={B_SMALL}: launches "
        f"{counts['B8']}")
    if counts["B8"] != need or not np.isfinite(small.values).all():
        raise AssertionError(f"sharded B={B_SMALL}: {counts['B8']} != {need}")

    # Rates in turns (unsharded, sharded, sharded, unsharded) on one card.
    rolls = {}
    for tag, e in (("unsharded", TimeSeriesEstimator(card, sampler)),
                   ("sharded", est)):
        x0, days, ms, _ = e.prepare_inputs(np.arange(B))
        rolls[tag] = (e, e.rollout_fn(STEPS), x0, days, ms)
    elapsed = {"unsharded": [], "sharded": []}
    for tag in ("unsharded", "sharded", "sharded", "unsharded"):
        _, roll, x0, days, ms = rolls[tag]
        elapsed[tag].append(timed_ms(lambda: roll(x0, days, ms), reps=3,
                                     inner=1, warmup=1) / 1e3)
    for tag, ts in elapsed.items():
        sec = float(np.mean(ts))
        result[f"{tag}_rollout"] = {"elapsed_s": sec,
                                    "grid_points_per_s":
                                    B * STEPS * NLAT * NLON / sec}
        log(f"rollout {tag} fp32: {sec * 1e3:.2f} ms per predict({STEPS}) at "
            f"B={B} -> {B * STEPS * NLAT * NLON / sec / 1e6:.2f} Mgp/s")
    e, _, x0, days, ms = rolls["sharded"]
    names = {}
    device = profile_steps(torch, e, x0, days, ms, "sharded fp32",
                           names=names)
    wall = result["sharded_rollout"]["elapsed_s"] * 1e3 / STEPS
    result["sharded_device_ms_per_step"] = device
    # Device time per launch of the lat-band kernels on the path: their
    # event timings below include the wrappers' host work.
    result["device_ms_per_launch"] = {
        kernel: sum(t for k, (t, _) in names.items() if kernel in k)
        / max(sum(n for k, (_, n) in names.items() if kernel in k), 1)
        for kernel in ("halo_kernel", "overlap_db_kernel")}
    result["device_ms_per_step_by_kernel"] = {
        kernel: sum(t for k, (t, _) in names.items() if kernel in k)
        for kernel in ("halo_kernel", "overlap_db_kernel")}
    log(f"sharded rollout: device ms per launch of the lat-band kernels "
        f"{result['device_ms_per_launch']}, per step "
        f"{result['device_ms_per_step_by_kernel']}")
    result["sharded_idle_share"] = 1 - device / wall
    log(f"sharded rollout: device {device:.3f} ms a step of {wall:.3f} ms: "
        f"idle {100 * (1 - device / wall):.1f}%")
    return counts, per_step, result


def overlap_dispatch(torch, shape, o):
    """``[(batch, chunk), ...]``: the overlap kernel launches the port's
    dispatch makes for one conv of global ``shape`` on the lat=2 mesh of
    one card (chunk None: the single-shot kernel), read off the dispatch
    with meta tensors."""
    from unittest import mock

    import dlwp_torch.parallel.pallas_overlap as po

    plan = []

    def record(shards, kernel, chunk=None):
        plan.append((shards[0][0].shape[0], chunk))
        return [[torch.empty((s.shape[0], o) + s.shape[2:], device="meta")
                 for s in r] for r in shards]

    b, c, h, w = shape
    shards = [[torch.empty(b, c, h // 2, w, device="meta")] * 2]
    with mock.patch.object(po, "_overlap_local_db", record), \
            mock.patch.object(po, "overlap_conv", record):
        po._overlap_local(shards, torch.empty(o, c, 3, 3, device="meta"))
    return plan


def time_parallel_kernels(torch, dev):
    """Each lat-band kernel, its plain version and (for the convs) cuDNN's
    F.conv2d on the pre-padded shards, at the shapes the sharded path gives
    it on the lat=2 mesh of one card: the halo at its four convs, the
    pipelined conv at its five launches a step at B=64, the single-shot
    conv at its three at B=8."""
    import torch.nn.functional as F

    from dlwp_torch.kernels import (
        halo_exchange, halo_exchange_plain, overlap_conv, overlap_conv_db,
        overlap_conv_plain,
    )
    from dlwp_torch.kernels.halo_exchange import halo_rows_plain
    from dlwp_torch.ops.padding import pad_latlon
    from dlwp_torch.parallel.mesh import split_shards

    mesh = virtual_mesh(dev, 1, 2)
    g = torch.Generator(device=dev).manual_seed(2)
    rows = {"halo_exchange": [], "overlap_conv": [], "overlap_conv_db": []}
    for name, shape, _, kh, d in HALO_CONVS:
        eh = (kh - 1) * d
        halo = (eh // 2, eh - eh // 2)
        shards = split_shards(torch.randn(shape, device=dev, generator=g),
                              mesh, "data", "lat")
        out = halo_exchange(shards, halo)
        nbytes = 4 * sum(s.numel() for r in shards + out for s in r)
        rows["halo_exchange"].append(dict(
            conv=name, shape=list(shape), halo=list(halo),
            ms=timed_ms(lambda: halo_exchange(shards, halo)),
            plain_ms=timed_ms(lambda: halo_exchange_plain(shards, halo)),
            library_ms=None, bytes=nbytes, flops=0))
    for name, shape, o, batch, chunk in [
            (name, shape, o, batch, chunk)
            for b_run in (B, B_SMALL)
            for name, shape, o in OVERLAP_CONVS
            for batch, chunk in overlap_dispatch(
                torch, (b_run,) + shape[1:], o)]:
        shape = (batch,) + shape[1:]
        shards = split_shards(torch.randn(shape, device=dev, generator=g),
                              mesh, "data", "lat")
        k = torch.randn(o, shape[1], 3, 3, device=dev,
                        generator=g) / (9 * shape[1]) ** 0.5
        blocks = torch.cat([pad_latlon(p, (0, 0), (1, 1))
                            for r in shards for p in halo_rows_plain(r, (1, 1))])
        if chunk is None:
            kname, fn = "overlap_conv", lambda: overlap_conv(shards, k)
        else:
            kname, fn = "overlap_conv_db", (
                lambda: overlap_conv_db(shards, k, chunk))
        b_, c_, h_, w_ = shape
        fn()
        plan, grid = (overlap_conv if chunk is None
                      else overlap_conv_db).last_launch
        rows[kname].append(dict(
            conv=name, shape=list(shape), out_channels=o, chunk=chunk,
            ms=timed_ms(fn),
            plain_ms=timed_ms(lambda: overlap_conv_plain(shards, k)),
            library_ms=timed_ms(lambda: F.conv2d(blocks, k)),
            device_ms=device_ms_per_call(torch, fn),
            library_device_ms=device_ms_per_call(
                torch, lambda: F.conv2d(blocks, k)),
            bytes=4 * (b_ * c_ * h_ * w_ + k.numel() + b_ * o * h_ * w_),
            flops=2 * b_ * o * h_ * w_ * c_ * 9,
            plan=plan._asdict(), grid=grid))
    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["flops"])
            lib = ("" if r["library_ms"] is None
                   else f", cuDNN {r['library_ms']:.4f} ms")
            if name != "halo_exchange":
                # The kernel's own arithmetic: three TF32 tensor-core
                # products per multiply-add. bound_fp32_ms: fp32 FMA.
                r["bound_fp32_ms"] = r["bound_ms"]
                r["bound_ms"], r["bound_by"] = bound_ms(
                    r["bytes"], 3 * r["flops"], PEAK_TF32_FLOPS)
                lib += (f" (device {r['library_device_ms']:.4f}); device "
                        f"{r['device_ms']:.4f} ms: "
                        f"{r['library_device_ms'] / r['device_ms']:.2f}x "
                        f"cuDNN's speed, {100 * r['bound_ms'] / r['device_ms']:.1f}"
                        f"% of the 3xTF32 bound, "
                        f"{100 * r['bound_fp32_ms'] / r['device_ms']:.1f}% "
                        f"of the fp32 bound {r['bound_fp32_ms']:.4f} ms; "
                        f"tile {r['plan']['bb']}x{r['plan']['rb']}, "
                        f"{r['plan']['warps']} warps, {r['plan']['stages']} "
                        f"stages, {r['plan']['tiles']} tiles, grid {r['grid']}")
            log(f"timing {name} {r['conv']} {r['shape']}"
                f"{'' if r.get('chunk') is None else ' chunk %d' % r['chunk']}"
                f": kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
                f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def device_ms_per_call(torch, fn, calls=10):
    """Device kernel time of one call of ``fn`` (torch.profiler, mean of
    ``calls`` after a warm-up call): the kernels alone, without the host
    work that the event timings of a short call include."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A profiler session around a hand kernel, the first of its process,
    # has come back without device time; it is repeated before failing.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if getattr(e, "device_time_total", 0) > 0
                    and e.device_type.name == "CUDA")
        if total > 0:
            return total / 1e3 / calls
    raise AssertionError("the profiler saw no device time")


# ------------------------------------------------------------------ fold
# Folded against unfolded engines (fp32 on the card): T72 on the archive's
# 73x144 grid and T170 on the 0.5-degree 361x720 grid. Limits, each as max
# abs over the output's max abs: fold vs unfolded 1e-5 (the fold adds the
# mirrored rows before the contraction: another fp32 summation order);
# round trips grid -> spec -> grid -> spec and winds -> (vrt, div) ->
# winds -> (vrt, div) 1e-4 (fp32 transforms; the JAX package measured
# 2.5e-7 at T170 for one scalar round trip at full precision).
FOLD_GRIDS = ((73, 144, 72), (361, 720, 170))
TOL_FOLD, TOL_FOLD_TRIP = 1e-5, 1e-4
FOLD_BATCH = 16


def scaled_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def random_spec(torch, dev, lead, T, seed=0):
    """Band-limited random coefficients (real m = 0 column), complex64."""
    rs = np.random.RandomState(seed)
    M = T + 1
    c = rs.randn(*lead, M, M) + 1j * rs.randn(*lead, M, M)
    c = c * (np.arange(M)[None, :] >= np.arange(M)[:, None])
    c[..., 0, :] = c[..., 0, :].real
    return torch.as_tensor(c.astype(np.complex64), device=dev)


def run_fold(torch, dev):
    """``fold=True`` against the unfolded engine on the card: every public
    transform, the two round trips, and the time of a scalar round trip
    (synthesize + analyze) and of a vector one (winds and back) for one
    field and for FOLD_BATCH fields, both engines in turns."""
    from dlwp_torch import LatLonGrid, SphericalHarmonics
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = {}
    for nlat, nlon, T in FOLD_GRIDS:
        grid = LatLonGrid.regular(nlat, nlon)
        t0 = time.perf_counter()
        eng = {f: SphericalHarmonics.build(grid, T, fold=f, device=dev)
               for f in (False, True)}
        build_s = time.perf_counter() - t0
        spec = random_spec(torch, dev, (2,), T)
        field = torch.randn(2, nlat, nlon, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
        res = {}
        for name, fn in (
                ("synthesize", lambda e: (e.synthesize(spec),)),
                ("analyze", lambda e: (e.analyze(field),)),
                ("gradients", lambda e: e.gradients(spec)),
                ("uv_from_vrtdiv", lambda e: e.uv_from_vrtdiv(spec,
                                                              0.5 * spec)),
                ("vrtdiv_from_uv", lambda e: e.vrtdiv_from_uv(field,
                                                              field.flip(-1)))):
            res[name] = max(scaled_err(a, b) for a, b in
                            zip(fn(eng[True]), fn(eng[False])))
        # Round trips as projections: analysis is the weighted pseudo-
        # inverse of synthesis, so analyze(synthesize(analyze(f))) equals
        # analyze(f) on any grid, also where the grid cannot resolve every
        # coefficient (m = 1 at T = nlat - 1 on a pole-inclusive grid); the
        # winds' the same below the Nyquist wavenumber, whose imaginary
        # part irfft drops (m = 72 at T72 on 144 columns).
        u, v = field, field.flip(-1)
        sub = (torch.arange(T + 1, device=dev) < nlon // 2)[:, None]
        trips = {}
        for f, e in eng.items():
            s1 = e.analyze(field)
            vrt, div = (w * sub for w in e.vrtdiv_from_uv(u, v))
            vrt2, div2 = e.vrtdiv_from_uv(*e.uv_from_vrtdiv(vrt, div))
            trips[f] = max(scaled_err(e.analyze(e.synthesize(s1)), s1),
                           scaled_err(vrt2, vrt), scaled_err(div2, div))
        times = {}
        for batch in (1, FOLD_BATCH):
            s = random_spec(torch, dev, (batch,), T, seed=2)
            for f in (False, True, True, False):
                e = eng[f]
                key = f"{'fold' if f else 'unfolded'} B={batch}"
                times.setdefault(key, []).append(dict(
                    scalar_ms=timed_ms(lambda: e.analyze(e.synthesize(s)),
                                       reps=3, inner=5),
                    vector_ms=timed_ms(lambda: e.vrtdiv_from_uv(
                        *e.uv_from_vrtdiv(s, s)), reps=3, inner=5)))
        times = {k: {m: float(np.mean([r[m] for r in v])) for m in v[0]}
                 for k, v in times.items()}
        tag = f"T{T} {nlat}x{nlon}"
        log(f"fold {tag}: tables built in {build_s:.1f} s (both engines); "
            f"fold vs unfolded max err / scale "
            + ", ".join(f"{k} {v:.2e}" for k, v in res.items())
            + f" (limit {TOL_FOLD}); round trips unfolded "
            f"{trips[False]:.2e}, fold {trips[True]:.2e} (limit "
            f"{TOL_FOLD_TRIP})")
        for k, v in times.items():
            log(f"  fold timing {tag} {k}: scalar round trip "
                f"{v['scalar_ms']:.4f} ms, vector round trip "
                f"{v['vector_ms']:.4f} ms (CUDA events, mean of 2 turns)")
        bad = {k: v for k, v in res.items() if not v <= TOL_FOLD}
        if bad or not max(trips.values()) <= TOL_FOLD_TRIP:
            raise AssertionError(f"fold {tag}: {res} {trips}")
        out[tag] = {"fold_vs_unfolded": res, "round_trip": {
            "unfolded": trips[False], "fold": trips[True]},
            "times_ms": times, "build_s": build_s}
    out["launches"] = launch_counts()
    if out["launches"] != expected_counts():
        raise AssertionError(f"fold launches {out['launches']}")
    return out


# ------------------------------------------------------------- spherical
# bench.py's spherical stack (examples/train_spherical.py's architecture,
# train_torch.py:100-114) at its width: B=64, 3 channels on 73x144, b_in
# 36, truncation 12, 16 features, Linear 9216 -> 31536 (290.6 M
# parameters). Card vs CPU (fp32, same weights): the forward to 1e-5 x its
# scale, and 3 Adam steps (lr 1e-3) at TOL_TRAIN's limits.
SPH = dict(b=64, c=3, nlat=73, nlon=144, b_in=36, trunc=12, feat=16)
SPH_STEPS, TOL_SPH = 3, 1e-5


def spherical_specs():
    """``examples/train_spherical.py``'s ``build_layer_specs`` at
    bench_spherical's sizes."""
    from dlwp_torch.models import s2_near_identity_grid

    s = SPH
    g = s2_near_identity_grid(max_beta=0.2, n_alpha=12, n_beta=1)
    flat = s["feat"] * (2 * s["trunc"]) ** 2
    return [
        ("S2Convolution", (s["c"], s["feat"], s["b_in"], s["trunc"], g),
         {"mean_gamma": True, "activation": "tanh"}),
        ("S2Convolution", (s["feat"], s["feat"], s["trunc"], s["trunc"], g),
         {"mean_gamma": True, "activation": "tanh"}),
        ("TorchReshape", ((-1, flat),), None),
        ("Linear", (flat, s["c"] * s["nlat"] * s["nlon"]), None),
        ("TorchReshape", ((-1, s["c"], s["nlat"], s["nlon"]),), None),
    ]


def spherical_net(device):
    from dlwp_torch import DLWPNeuralNet

    net = DLWPNeuralNet(is_convolutional=True, time_dim=1, scaler_type=None,
                        device=device)
    net.build_model(spherical_specs(), loss="mse", optimizer="adam",
                    learning_rate=1e-3, seed=0)
    return net


def run_spherical(torch, dev):
    """The spherical stack on the card: forward and 3 train steps against
    the CPU from the same weights; the forward rate, the train step's time
    and its device time by kernel (no hand kernel: cuBLAS with TF32 off)."""
    from dlwp_torch import flax_tree
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    torch.set_num_threads(os.cpu_count() or 1)
    s = SPH
    rs = np.random.RandomState(0)
    shape = (s["b"], s["c"], s["nlat"], s["nlon"])
    x = rs.randn(*shape).astype(np.float32)
    ys = [(0.5 * x + 0.1 * rs.randn(*shape)).astype(np.float32)
          for _ in range(SPH_STEPS)]
    reset_launch_counts()
    card = spherical_net(dev)
    card.init(x[:1], seed=0)
    tree = flax_tree(card.base_model)
    n_params = sum(p.numel() for p in card.base_model.parameters())
    cpu = spherical_net("cpu")
    cpu.load_flax_params(tree)
    xd = torch.as_tensor(x, device=dev)
    with torch.no_grad():
        y_card = card.base_model(xd)
        y_cpu = cpu.base_model(torch.as_tensor(x))
    fwd_err = scaled_err(y_card.cpu(), y_cpu)
    losses = {"card": [], "cpu": []}
    grads = {}
    for name, net in (("card", card), ("cpu", cpu)):
        tr = net.trainer
        tr.init(x[:1])
        for k, y in enumerate(ys):
            losses[name].append(float(tr.train_step(x, y)["loss"]))
            if k == 0:
                grads[name] = {n: p.grad.detach().cpu().clone()
                               for n, p in net.base_model.named_parameters()}
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["card"], losses["cpu"]))
    grad_rel = state_rel_rms(grads["card"], grads["cpu"])
    params_rel = state_rel_rms(
        {k: v.detach() for k, v in card.base_model.state_dict().items()},
        cpu.base_model.state_dict())
    counts = launch_counts()
    with torch.no_grad():
        fwd_ms = timed_ms(lambda: card.base_model(xd), reps=3, inner=5)
    yd = torch.as_tensor(ys[0], device=dev)
    step_ms = timed_ms(lambda: card.trainer.train_step(xd, yd), reps=3,
                       inner=3, warmup=1)
    names = {}
    dev_ms = profile_device(torch, lambda: card.trainer.train_step(xd, yd),
                            "spherical train step", names=names)
    opt_ms = sum(ms for k, (ms, _) in names.items()
                 if "foreach" in k or "elementwise" in k or "vectorized" in k)
    gemm_ms = sum(ms for k, (ms, _) in names.items()
                  if "gemm" in k.lower() or "sgemm" in k or "cutlass" in k)
    mgps = s["b"] * s["nlat"] * s["nlon"] / fwd_ms / 1e3
    out = {"params": n_params, "forward_err": fwd_err,
           "losses_card": losses["card"], "losses_cpu": losses["cpu"],
           "loss_rel": loss_rel, "grad_rel_rms": grad_rel,
           "params_rel_rms": params_rel, "launches": counts,
           "forward_ms": fwd_ms, "forward_mgps": mgps,
           "train_step_ms": step_ms, "train_step_device_ms": dev_ms,
           "elementwise_device_ms": opt_ms, "gemm_device_ms": gemm_ms,
           "param_bytes": 4 * n_params}
    log(f"spherical: {n_params} parameters ({4 * n_params / 1e9:.3f} GB "
        f"fp32), B={s['b']} {s['c']}x{s['nlat']}x{s['nlon']}; forward card vs "
        f"CPU {fwd_err:.2e} of scale (limit {TOL_SPH}); {SPH_STEPS} adam "
        f"steps: loss {loss_rel:.2e} (limit {TOL_TRAIN['loss']}), first "
        f"gradient {grad_rel:.2e} (limit {TOL_TRAIN['grad']}), parameters "
        f"{params_rel:.2e} (limit {TOL_TRAIN['params']}) relative RMS; "
        f"forward {fwd_ms:.3f} ms = {mgps:.2f} Mgp/s, train step "
        f"{step_ms:.3f} ms (device {dev_ms:.3f}: GEMMs {gemm_ms:.3f}, "
        f"elementwise {opt_ms:.3f}); launches {counts}")
    if counts != expected_counts():
        raise AssertionError(f"spherical launches {counts}")
    if not (fwd_err <= TOL_SPH and loss_rel <= TOL_TRAIN["loss"]
            and grad_rel <= TOL_TRAIN["grad"]
            and params_rel <= TOL_TRAIN["params"]):
        raise AssertionError(f"spherical card vs CPU: {out}")
    return out


# -------------------------------------------------------- sharded spectral
# A lat=2 mesh repeating the card, on a 72x144 Gaussian grid at T71 (72
# rows and 72 wavenumbers both divide by 2). Sharded vs unsharded on the
# card, fp32: transforms 1e-6 x the output's scale (only where the sums
# run differs), 20 barotropic steps 1e-5 relative RMS.
SHARD_GRID, TOL_SHARD, TOL_SHARD_BARO, SHARD_STEPS = (72, 144, 71), 1e-6, \
    1e-5, 20


def run_sharded_spectral(torch, dev):
    """ShardedSphericalHarmonics and ShardedBarotropicModel on two virtual
    lat shards of the card, folded and not, against the unsharded engine
    and model; ms a step of each."""
    from dlwp_torch import BarotropicModel, LatLonGrid, SphericalHarmonics
    from dlwp_torch.kernels import launch_counts, reset_launch_counts
    from dlwp_torch.parallel import (ShardedBarotropicModel,
                                     ShardedSphericalHarmonics)

    reset_launch_counts()
    nlat, nlon, T = SHARD_GRID
    grid = LatLonGrid.gaussian(nlat, nlon)
    mesh = virtual_mesh(dev, 1, 2)
    out = {}
    for fold in (False, True):
        sh = SphericalHarmonics.build(grid, T, fold=fold, device=dev)
        ssh = ShardedSphericalHarmonics(sh, mesh)
        spec = random_spec(torch, dev, (4,), T)
        field = sh.synthesize(spec)
        errs = {
            "analyze": scaled_err(ssh.analyze(field), sh.analyze(field)),
            "synthesize": scaled_err(ssh.synthesize(spec),
                                     sh.synthesize(spec)),
            "uv_from_vrtdiv": max(scaled_err(a, b) for a, b in zip(
                ssh.uv_from_vrtdiv(spec, spec), sh.uv_from_vrtdiv(spec, spec))),
            "vrtdiv_from_uv": max(scaled_err(a, b) for a, b in zip(
                ssh.vrtdiv_from_uv(field, field), sh.vrtdiv_from_uv(field,
                                                                   field))),
        }
        kw = dict(dt=1800.0, damping_coefficient=5e-6, fold=fold, device=dev)
        ref = BarotropicModel(grid, T, **kw)
        shd = ShardedBarotropicModel(grid, T, mesh=mesh, **kw)
        state = ref.from_z(bench_height(grid))
        want = ref.run(state, SHARD_STEPS)
        got = shd.run_sharded(state, SHARD_STEPS)
        baro = rel_rms(got.vrt_spec, want.vrt_spec)
        finite = bool(torch.isfinite(torch.view_as_real(got.vrt_spec)).all())
        ms = {"unsharded": timed_ms(lambda: ref.run(state, SHARD_STEPS),
                                    reps=3, inner=1) / SHARD_STEPS,
              "sharded": timed_ms(lambda: shd.run_sharded(state, SHARD_STEPS),
                                  reps=3, inner=1) / SHARD_STEPS}
        key = "fold" if fold else "unfolded"
        log(f"sharded_spectral {key}: lat=2 on one card, Gaussian "
            f"{nlat}x{nlon} T{T}; sharded vs unsharded max err / scale "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (limit {TOL_SHARD}); {SHARD_STEPS} barotropic steps relative "
            f"RMS {baro:.2e} (limit {TOL_SHARD_BARO}), finite {finite}; ms a "
            f"step: unsharded {ms['unsharded']:.4f}, sharded "
            f"{ms['sharded']:.4f} (CUDA events)")
        if not (max(errs.values()) <= TOL_SHARD and baro <= TOL_SHARD_BARO
                and finite):
            raise AssertionError(f"sharded_spectral {key}: {errs} {baro}")
        out[key] = {"errors": errs, "barotropic_rel_rms": baro,
                    "ms_per_step": ms}
    out["launches"] = launch_counts()
    if out["launches"] != expected_counts():
        raise AssertionError(f"sharded_spectral launches {out['launches']}")
    return out


# ------------------------------------------------------------- paper run
# docs/DEPLOY.md's paper run: the two-truth archive (T72 truth on 73x144,
# band-limited to T42 on 73x144, vrt form, dt 1800 s, 92-day segments),
# Preprocessor.data_to_series(HGT/500, VRT/500), the pole crop to 72x144,
# train_convlstm.py's tower with --device-resident --sequence 2
# --cosine-decay at 2e-3, B=32, latitude-weighted MSE, the last 25% held
# out, early stopping (min 20 epochs, patience 6); validate.py's rows with
# 12 forecast steps and the vrt-form barotropic baseline over 20-70N. Cut
# (by default) to PAPER_YEARS and PAPER_EPOCHS: --paper-years 4
# --paper-epochs 50 runs the full configuration.
PAPER_ARCHIVE = dict(nlat=73, nlon=144, truncation=42, truth_truncation=72,
                     truth_nlat=73, truth_nlon=144, dt=1800.0,
                     segment_days=92, form="vrt", seed=0)
PAPER = {"years": 1.0, "epochs": 10}
PAPER_B, PAPER_LR, PAPER_VAL, PAPER_LEADS = 32, 2e-3, 0.25, 12
# The card's archive vs the CPU's: 2 segments of 3 days, relative RMS of
# the difference over the field's anomaly RMS (fp32, summation order, grown
# by 240 steps of chaotic dynamics).
TOL_ARCHIVE_RRMS = 1e-3


def paper_specs(c_in, c_out, nlat, nlon, lstm_features):
    """``train_convlstm``'s ``convlstm_tower``, its reshapes fixed to the
    grid as the script fixes them."""
    from dlwp_torch.examples.train_convlstm import convlstm_tower

    specs = convlstm_tower(TD, c_in, TD * c_out, lstm_features)
    specs[1] = ("Reshape", ((TD * lstm_features, nlat, nlon),), None)
    specs.append(("Reshape", ((TD, c_out, nlat, nlon),), None))
    return specs


def archive_vs_cpu(torch, dev):
    """A short archive (2 segments of 3 days) on the card and on the CPU:
    NaN rows in the same places, fields within TOL_ARCHIVE_RRMS."""
    from dlwp_torch.data import BarotropicArchiveSource

    kw = dict(PAPER_ARCHIVE, n_samples=25, segment_days=3)
    srcs = {d: BarotropicArchiveSource(device=d, **kw) for d in (dev, "cpu")}
    out = {}
    for var in ("HGT", "VRT"):
        got, want = (srcs[d].field(var, 500) for d in (dev, "cpu"))
        nan = np.isnan(want)
        same_nan = bool((np.isnan(got) == nan).all())
        ok = want[~nan]
        rrms = float(np.sqrt(np.mean((got[~nan] - ok) ** 2))
                     / np.sqrt(np.mean((ok - ok.mean()) ** 2)))
        out[var] = {"same_nan_rows": same_nan, "rel_rms": rrms,
                    "marker_rows": nan.all(axis=(1, 2)).nonzero()[0].tolist()}
    log(f"paper_run archive card vs CPU (2 segments of 3 days, "
        f"{srcs[dev].n_segments} segments): {out} (limit {TOL_ARCHIVE_RRMS})")
    if not all(v["same_nan_rows"] and v["rel_rms"] <= TOL_ARCHIVE_RRMS
               and v["marker_rows"] == [12] for v in out.values()):
        raise AssertionError(f"paper_run archive vs CPU: {out}")
    return out


def paper_kernels(torch, dev, nlat, nlon, c_pool, lstm_features):
    """Both kernels against their plain versions at the 72x144 shapes the
    paper run gives them: B=32 (train steps, validation batches) and the
    forecast's init batch."""
    from dlwp_torch.kernels import (fused_conv_pool, fused_conv_pool_plain,
                                    lstm_gates, lstm_gates_plain)

    g = torch.Generator(device=dev).manual_seed(3)
    errs = {}
    for b in (PAPER_B, VERIFY_INIT_BATCH):
        x = torch.randn(b, c_pool, nlat, nlon, device=dev, generator=g)
        k = torch.randn(32, c_pool, 3, 3, device=dev,
                        generator=g) / (9 * c_pool) ** 0.5
        bias = 0.1 * torch.randn(32, device=dev, generator=g)
        y = fused_conv_pool(x, k, bias, 2)
        err = (y - fused_conv_pool_plain(x, k, bias, 2)).abs().max().item()
        errs[f"fused_conv_pool B={b}"] = err
        f = lstm_features
        zx, zh = (torch.randn(b, 4 * f, nlat, nlon, device=dev, generator=g)
                  for _ in range(2))
        cc = torch.randn(b, f, nlat, nlon, device=dev, generator=g)
        h1, c1 = lstm_gates(zx, zh, cc, "tanh", "hard_sigmoid", None)
        h2, c2 = lstm_gates_plain(zx, zh, cc, "tanh", "hard_sigmoid", None)
        errs[f"lstm_gates B={b}"] = max((h1 - h2).abs().max().item(),
                                        (c1 - c2).abs().max().item())
    log(f"paper_run kernels at {nlat}x{nlon} (conv-pool ({c_pool} -> 32, "
        f"d=2), gates F={lstm_features}): max|kernel - plain| {errs} "
        f"(limit {TOL_F32})")
    if not max(errs.values()) <= TOL_F32:
        raise AssertionError(f"paper_run kernels: {errs}")
    return errs


def run_paper_run(torch, dev):
    """The paper run on the card (see PAPER_ARCHIVE): archive, series,
    fit_device, validation with the baseline; the skill criterion, the
    chaos check, launch counts, the kernels at 72x144 and the archive
    against the CPU."""
    from dlwp_torch import DeviceSeriesSampler, DLWPNeuralNet, SeriesSampler
    from dlwp_torch.data import BarotropicArchiveSource, Preprocessor
    from dlwp_torch.kernels import launch_counts, reset_launch_counts
    from dlwp_torch.ops.losses import latitude_weighted_loss, mse
    from dlwp_torch.utils import train_test_split_ind

    torch.set_num_threads(os.cpu_count() or 1)
    out = {"config": dict(PAPER_ARCHIVE, **PAPER)}
    out["archive_vs_cpu"] = archive_vs_cpu(torch, dev)
    n_samples = int(PAPER["years"] * 365.25 * 4)
    src = BarotropicArchiveSource(n_samples=n_samples, device=dev,
                                  **PAPER_ARCHIVE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src.field("HGT", 500)
    archive_s = time.perf_counter() - t0
    model = src._model()
    state = model.from_z(src._initial_z())
    step_ms = timed_ms(lambda: model.run(state, 24), reps=3, inner=1) / 24
    n_steps = (int(round(src.spinup_days * 86400.0 / src.dt))
               + src.per_segment * int(round(src.snapshot_hours * 3600.0
                                             / src.dt)))
    log(f"paper_run archive: {n_samples} rows, {src.n_segments} segments "
        f"integrated as one batch at T{src._run_truncation} on "
        f"{src._run_grid.nlat}x{src._run_grid.nlon} ({n_steps} steps), "
        f"band-limited to T{src.truncation}: {archive_s:.2f} s; plain engine "
        f"{step_ms:.4f} ms a step of the {src.n_segments}-member state")
    t0 = time.perf_counter()
    data = Preprocessor(src).data_to_series(["HGT", "VRT"], [500, 500],
                                            pairwise=True)
    series_s = time.perf_counter() - t0
    data.predictors = data.predictors[..., 1:, :]  # the pole crop
    data.lat = data.lat[1:]
    n = data.predictors.shape[0]
    tr_idx, _ = train_test_split_ind(n, int(n * PAPER_VAL), method="last")
    train_data = data.isel_sample(tr_idx)
    val_data = data.isel_sample(np.arange(len(tr_idx), n))
    net = DLWPNeuralNet(is_recurrent=True, time_dim=TD, scaler_type=None,
                        device=dev)
    kw = dict(input_time_steps=TD, output_time_steps=TD, sequence=2,
              add_insolation=True, batch_size=PAPER_B)
    train = SeriesSampler(train_data, model=net, shuffle=True, seed=0, **kw)
    val = SeriesSampler(val_data, model=net, **kw)
    T_, c_in, nlat, nlon = train.convolution_shape
    c_out = train.output_convolution_shape[1]
    lstm_features = 4 * c_in
    net.build_model(paper_specs(c_in, c_out, nlat, nlon, lstm_features),
                    loss=latitude_weighted_loss(mse, train_data.lat),
                    learning_rate=PAPER_LR, sequence_steps=2,
                    splice_fn=splice_insolation, early_stopping=True,
                    min_epochs=20, patience=6)
    net.init(train.generate(np.arange(1))[0], seed=0)
    dtrain = DeviceSeriesSampler(train, device=dev)
    dval = DeviceSeriesSampler(val, device=dev)
    net.trainer.make_optimizer = chain_optimizer(len(dtrain) * PAPER["epochs"],
                                                 PAPER_LR)
    record = []
    probe_step_loop(torch, net.trainer, False, record)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = net.fit_generator(dtrain, validation_data=dval,
                             epochs=PAPER["epochs"], verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = launch_counts()
    epochs = len(hist.epoch)
    need = fit_launches(epochs, len(dtrain), len(dval), S=2, pools=1,
                        convs=3)
    loop_s = sum(t for t, _ in record)
    samples_s = epochs * len(dtrain) * PAPER_B / loop_s
    log(f"paper_run fit_device: {epochs} epochs x {len(dtrain)} steps (B="
        f"{PAPER_B}, S=2) + {len(dval)} validation batches, {fit_s:.2f} s "
        f"(the step loops {loop_s:.2f} s: {samples_s:.1f} train samples/s); "
        f"loss {hist.history['loss'][0]:.4e} -> {hist.history['loss'][-1]:.4e},"
        f" val_loss {hist.history['val_loss'][-1]:.4e}; launches "
        f"{fit_counts} (need {need})")
    reset_launch_counts()
    t0 = time.perf_counter()
    f_hour, rows, n_init, predict_s, masked = validate_rows(
        torch, net, data, PAPER_VAL, PAPER_LEADS // TD, barotropic="vrt",
        device=dev)
    val_s = time.perf_counter() - t0
    val_counts = launch_counts()
    std = float(data.std[data.varlev.index("HGT/500")])
    rows = {k[:-len("_rmse")]: np.asarray(r) * std for k, r in rows.items()}
    chunks = -(-n_init // VERIFY_INIT_BATCH)
    val_need = expected_counts(
        fused_conv_pool=chunks * PAPER_LEADS // TD,
        lstm_gates=chunks * (TD - 1) * PAPER_LEADS // TD,
        cyclic_conv=3 * chunks * PAPER_LEADS // TD)
    log(f"paper_run validation: {n_init} inits x {len(f_hour)} leads "
        f"(forecast {predict_s:.2f} s, launches {val_counts}; the rows "
        f"with the barotropic baseline {val_s:.2f} s), {masked} (init, "
        f"lead) pairs across "
        f"a restart masked; RMSE of HGT/500 over 20-70N, m:")
    log(f"  {'f_hour':>8} " + " ".join(f"{k:>14}" for k in rows))
    for i, fh in enumerate(f_hour):
        log(f"  {int(fh):8d} " + " ".join(f"{rows[k][i]:14.3f}"
                                           for k in rows))
    lead12 = np.asarray(f_hour) >= 12
    skill = bool(np.all(rows["forecast"][lead12]
                        < rows["persistence"][lead12])
                 and np.all(rows["forecast"] < rows["climatology"]))
    chaos = bool(np.all(np.diff(rows["barotropic"]) > 0))
    log(f"paper_run criterion: forecast below persistence at every lead >= "
        f"12 h and below climatology at every lead: {skill}; barotropic row "
        f"grows with lead: {chaos}")
    # The idle share: one more epoch timed, then its device time.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit_generator(dtrain, epochs=1, verbose=False)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    dev_ms = profile_device(torch, lambda: net.fit_generator(
        dtrain, epochs=1, verbose=False), "paper_run fit_device epoch",
        per=len(dtrain), unit="step")
    idle = 1 - len(dtrain) * dev_ms / 1e3 / epoch_s
    log(f"paper_run epoch alone: {epoch_s:.3f} s, device {dev_ms:.3f} ms a "
        f"step, idle {100 * idle:.1f}%")
    kernels = paper_kernels(torch, dev, nlat, nlon, TD * lstm_features,
                            lstm_features)
    out.update({
        "archive_s": archive_s, "archive_step_ms": step_ms,
        "archive_steps": n_steps, "segments": src.n_segments,
        "series_s": series_s, "epochs": epochs, "fit_s": fit_s,
        "step_loop_s": loop_s, "train_samples_per_s": samples_s,
        "loss": hist.history["loss"], "val_loss": hist.history["val_loss"],
        "fit_launches": fit_counts, "validation_launches": val_counts,
        "f_hour": np.asarray(f_hour).tolist(),
        "rows_m": {k: r.tolist() for k, r in rows.items()},
        "inits": n_init, "masked_pairs": masked, "skill": skill,
        "barotropic_grows": chaos, "epoch_s": epoch_s,
        "device_ms_per_step": dev_ms, "idle_share": idle,
        "kernel_errs": kernels,
        "launches": {k: fit_counts[k] + val_counts[k] for k in fit_counts},
    })
    if fit_counts != need or val_counts != val_need:
        raise AssertionError(f"paper_run launches {fit_counts} / "
                             f"{val_counts} != {need} / {val_need}")
    if not all(np.isfinite(r).all() for r in rows.values()):
        raise AssertionError(f"paper_run rows not finite: {rows}")
    if not (skill and chaos):
        raise AssertionError(f"paper_run skill {skill}, chaos {chaos}")
    return out


# ----------------------------------------------------------------- serve
# Servables against the eager path on the card: the program runs the same
# ops (and kernels) in the same order, so the relative RMS limit is 1e-6
# (the JAX package's tests hold their servables to rtol 1e-6); against the
# CPU, the forecast's and the barotropic path's limits.
TOL_SERVE_RRMS = 1e-6
SERVE_BATCHES = (1, 7, B)
SERVE_REPS = 5
# The barotropic servable: bench.py's T72 psi configuration through the
# plain engine, members 1 and 4, at the reference's run_with_snapshots(24,
# 12): rolled, two programs of one 12-step interval each.
SERVE_BARO_BATCHES = (1, 4)


def turns(torch, fns, reps=SERVE_REPS):
    """Median ms per call of each of ``fns`` (a name -> call dict), timed
    with CUDA events one call at a time in turns, after a warm-up call."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: float(np.median(t)) for name, t in times.items()}


def serve_forecast(torch, dev):
    """The flagship forecast's rollout (``TimeSeriesEstimator.rollout_fn``,
    the program ``bench.py`` times) exported with ``export_program`` on the
    CPU from CPU weights and on the card, each serialized and loaded on the
    card: launches per call equal to the eager path's, the output against
    eager on the card (B=1, 7, 64 from one artifact) and against the CPU
    plain run, export / load seconds and size, and the rate in turns with
    the eager rollout, with the servable's idle share."""
    from torch.export import Dim

    from dlwp_torch import TimeSeriesEstimator, flax_tree
    from dlwp_torch.kernels import launch_counts, reset_launch_counts
    from dlwp_torch.serve import Servable, export_program

    dlwp, sampler = flagship_stack(dev)
    dlwp.init(sampler.generate(np.arange(1))[0], seed=0)
    cpu, cpu_sampler = flagship_stack("cpu")
    cpu.load_flax_params(flax_tree(dlwp.base_model))
    est = TimeSeriesEstimator(dlwp, sampler)
    cpu_est = TimeSeriesEstimator(cpu, cpu_sampler)
    batch = Dim("b", max=est.precompute_batch_limit(STEPS))
    out, servables = {}, {}
    for where, e in (("cpu", cpu_est), ("card", est)):
        args = e.prepare_inputs(np.arange(B))[:3]
        t0 = time.perf_counter()
        # x0 and the insolation days are batched; mean_state is not.
        sv = export_program(e.rollout_fn(STEPS), args, batch=batch,
                            batched=(0, 1),
                            meta={"kind": "forecast", "steps": STEPS})
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        blob = sv.serialize()
        serialize_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        servables[where] = Servable.load(blob)
        load_s = time.perf_counter() - t0
        tensors = (*sv.program.state_dict.values(),
                   *sv.program.constants.values())
        out[f"exported_on_{where}"] = dict(
            export_s=export_s, serialize_s=serialize_s, load_s=load_s,
            artifact_mb=len(blob) / 1e6, batch_range=sv.meta["batch_range"],
            nodes=len(sv.program.graph.nodes),
            tensor_mb=sum(t.numel() * t.element_size() for t in tensors) / 1e6)
        log(f"serve forecast exported on the {where}: export {export_s:.2f} "
            f"s ({out[f'exported_on_{where}']['nodes']} nodes), serialize "
            f"{serialize_s:.2f} s, {len(blob) / 1e6:.2f} MB (weights and "
            f"constants {out[f'exported_on_{where}']['tensor_mb']:.2f} MB), "
            f"load on the card {load_s:.2f} s; batch in "
            f"{sv.meta['batch_range']}")
    loaded = servables["cpu"].program
    where = {t.device.type for t in (*loaded.state_dict.values(),
                                     *loaded.constants.values())}
    if where != {dev.type}:
        raise AssertionError(f"serve: weights or constants on {where}")
    x0, days, ms, _ = est.prepare_inputs(np.arange(B))
    eager = est.rollout_fn(STEPS)
    need = expected_counts(fused_conv_pool=2 * STEPS, lstm_gates=STEPS,
                           cyclic_conv=4 * STEPS)
    errs = {}
    for b in SERVE_BATCHES:
        args = (x0[:b], days[:b], ms)
        reset_launch_counts()
        want = eager(*args)
        torch.cuda.synchronize()
        counts = {"eager": launch_counts()}
        for name, sv in servables.items():
            reset_launch_counts()
            t0 = time.perf_counter()
            got = sv.call(*args)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            counts[name] = launch_counts()
            rrms = rel_rms(got, want)
            equal = bool(torch.equal(got, want))
            errs[f"{name} B={b}"] = {"rel_rms": rrms, "bit_equal": equal,
                                     "first_call_ms": first_ms}
            log(f"serve forecast ({name} export) B={b}: {tuple(got.shape)}, "
                f"relative RMS vs eager {rrms:.3e}, bit-equal {equal}, "
                f"first call {first_ms:.1f} ms (host clock), launches "
                f"{counts[name]}")
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"serve {name} B={b}: {got.shape}")
            if not rrms <= TOL_SERVE_RRMS:
                raise AssertionError(f"serve {name} B={b}: {rrms}")
        if any(c != need for c in counts.values()):
            raise AssertionError(f"serve B={b}: launches {counts} != {need}")
    out["vs_eager"] = errs
    # The main path of this phase, counted from 0: one call of the
    # program exported on the CPU at B=64.
    reset_launch_counts()
    got = servables["cpu"].call(x0, days, ms)
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    t0 = time.perf_counter()
    cx0, cdays, _, _ = cpu_est.prepare_inputs(np.arange(4))
    ref = cpu_est.rollout_fn(STEPS)(cx0, cdays, ms.cpu())
    got = got[:, :4].cpu()
    step1 = (got[0] - ref[0]).abs().max().item()
    rrms = rel_rms(got, ref)
    log(f"serve forecast (cpu export, on the card) vs the CPU plain rollout "
        f"(4 samples, {time.perf_counter() - t0:.1f} s on CPU): step-1 max "
        f"abs {step1:.3e}, {STEPS}-step relative RMS {rrms:.3e}")
    if not (step1 <= TOL_STEP1["fp32"] and rrms <= TOL_TRAJ_RRMS["fp32"]):
        raise AssertionError(f"serve vs CPU: {step1}, {rrms}")
    out["vs_cpu"] = {"step1_max_abs": step1, "rel_rms": rrms}
    args = (x0, days, ms)
    ms_call = turns(torch, {
        "eager": lambda: eager(*args),
        "servable (cpu export)": lambda: servables["cpu"].call(*args),
        "servable (card export)": lambda: servables["card"].call(*args)})
    out["ms_per_predict"] = ms_call
    out["mgps"] = {k: B * STEPS * NLAT * NLON / (v / 1e3) / 1e6
                   for k, v in ms_call.items()}
    device = {
        "eager": profile_device(torch, lambda: eager(*args),
                                f"eager rollout({STEPS})"),
        "servable (cpu export)": profile_device(
            torch, lambda: servables["cpu"].call(*args),
            f"servable rollout({STEPS})")}
    out["device_ms_per_predict"] = device
    out["idle_share"] = {k: 1 - v / ms_call[k] for k, v in device.items()}
    for k, v in ms_call.items():
        idle = out["idle_share"].get(k)
        log(f"serve forecast {k}: {v:.3f} ms per predict({STEPS}) at B={B} "
            f"(CUDA events, median of {SERVE_REPS} in turns) -> "
            f"{out['mgps'][k]:.2f} Mgp/s"
            + (f"; device {device[k]:.3f} ms, idle {100 * idle:.1f}%"
               if idle is not None else ""))
    return out


def serve_rollout(torch, dev):
    """``export_rollout`` of a recurrent ``DLWPNeuralNet`` with the
    flagship's layers fed two channels (in equals out), a standard scaler
    fitted on synthetic data, time_steps=64 (32 iterations) at B=64:
    ``predict_timeseries`` of the loaded servable against the eager one."""
    from dlwp_torch import DLWPNeuralNet
    from dlwp_torch.flagship import convlstm_specs
    from dlwp_torch.kernels import launch_counts, reset_launch_counts
    from dlwp_torch.serve import Servable, export_rollout

    rng = np.random.RandomState(11)
    x = rng.randn(B, TD, C, NLAT, NLON).astype(np.float32)
    y = (1.5 * rng.randn(B, TD, C, NLAT, NLON) + 0.5).astype(np.float32)
    net = DLWPNeuralNet(is_recurrent=True, time_dim=TD,
                        scaler_type="standard", device=dev)
    net.build_model(convlstm_specs(NLAT, NLON, C, TD))
    net.init(x, seed=0)
    net.init_fit(x, y)
    t0 = time.perf_counter()
    sv = export_rollout(net, x, TD * STEPS)
    export_s = time.perf_counter() - t0
    blob = sv.serialize()
    t0 = time.perf_counter()
    sv = Servable.load(blob)
    load_s = time.perf_counter() - t0
    reset_launch_counts()
    got = sv.predict_timeseries(x)
    counts = launch_counts()
    want = net.predict_timeseries(x, TD * STEPS)
    rrms = float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))
    log(f"serve export_rollout: {sv}, export {export_s:.2f} s, "
        f"{len(blob) / 1e6:.2f} MB, load {load_s:.2f} s; predict_timeseries "
        f"{got.shape} vs eager relative RMS {rrms:.3e}, bit-equal "
        f"{np.array_equal(got, want)}, launches {counts}")
    need = expected_counts(fused_conv_pool=2 * STEPS, lstm_gates=STEPS,
                           cyclic_conv=4 * STEPS)
    if counts != need:
        raise AssertionError(f"serve export_rollout launches {counts}")
    if got.shape != want.shape or not rrms <= TOL_SERVE_RRMS:
        raise AssertionError(f"serve export_rollout: {got.shape}, {rrms}")
    return {"export_s": export_s, "load_s": load_s,
            "artifact_mb": len(blob) / 1e6, "rel_rms": rrms,
            "bit_equal": bool(np.array_equal(got, want)), "launches": counts}


def serve_barotropic(torch, dev):
    """``export_barotropic`` of the psi form at T72 on 73x144 (plain
    engine, symbolic members) at ``run_with_snapshots(24, 12)``, rolled,
    exported on the CPU and loaded on the card: bit-equal to the eager
    plain engine on the card, and against the CPU, members 1 and 4;
    export seconds, size, load seconds and ms a call."""
    from dlwp_torch.grid import LatLonGrid
    from dlwp_torch.serve import Servable, export_barotropic

    cpu = baro_model("psi", 73, 144, 72, "cpu")
    card = baro_model("psi", 73, 144, 72, None)
    t0 = time.perf_counter()
    sv = export_barotropic(cpu, BARO_SNAPS, BARO_EVERY, batch="b")
    export_s = time.perf_counter() - t0
    blob = sv.serialize()
    t0 = time.perf_counter()
    sv = Servable.load(blob)
    load_s = time.perf_counter() - t0
    out = {"export_s": export_s, "load_s": load_s,
           "artifact_mb": len(blob) / 1e6,
           "nodes": {k: len(p.graph.nodes) for k, p in sv.programs.items()}}
    log(f"serve barotropic run_with_snapshots({BARO_SNAPS}, {BARO_EVERY}), "
        f"rolled: export on the CPU {export_s:.1f} s ({out['nodes']} "
        f"nodes), {len(blob) / 1e6:.2f} MB, load on the card {load_s:.1f} s")
    grid = LatLonGrid.regular(73, 144)
    for m in SERVE_BARO_BATCHES:
        z0 = torch.as_tensor(np.stack([perturbed_height(grid, seed=s)
                                       for s in range(m)]), device=dev)
        got = sv.call(z0)
        want = card.run_with_snapshots(card.from_z(z0), BARO_SNAPS,
                                       BARO_EVERY)[2]
        ref = cpu.run_with_snapshots(cpu.from_z(z0.cpu()), BARO_SNAPS,
                                     BARO_EVERY)[2]
        card_rrms, cpu_rrms = rel_rms(got, want), rel_rms(got.cpu(), ref)
        calls = turns(torch, {
            "servable": lambda: sv.call(z0),
            "eager": lambda: card.run_with_snapshots(
                card.from_z(z0), BARO_SNAPS, BARO_EVERY)}, reps=3)
        out[f"members {m}"] = {"rel_rms_vs_card": card_rrms,
                               "rel_rms_vs_cpu": cpu_rrms,
                               "bit_equal": bool(torch.equal(got, want)),
                               "ms_per_call": calls}
        log(f"serve barotropic {m} member(s): {tuple(got.shape)}, relative "
            f"RMS vs eager on the card {card_rrms:.3e}, vs the CPU "
            f"{cpu_rrms:.3e}; ms a call (CUDA events, median of 3 in turns): "
            + ", ".join(f"{k} {v:.2f}" for k, v in calls.items()))
        if got.shape != (BARO_SNAPS, m, 73, 144) or not torch.equal(
                got, want) or not cpu_rrms <= TOL_BARO_RRMS:
            raise AssertionError(f"serve barotropic {m}: {card_rrms}, "
                                 f"{cpu_rrms}")
    return out


def serve_ops(torch, dev):
    """``torch.library.opcheck`` of both ops on the card at the flagship's
    shapes (the gates with operands that require grad: the registered
    backward too), and ``entry()``'s forward exported and run."""
    import functools

    from dlwp_torch.entry import entry
    from dlwp_torch.serve import export_program

    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for b, c, h, w, o, d in CONV_POOL_CASES[:2]:
        x = torch.randn(b, c, h, w, device=dev, generator=g)
        k = torch.randn(o, c, 3, 3, device=dev, generator=g) / (9 * c) ** 0.5
        bias = torch.randn(o, device=dev, generator=g)
        out[f"fused_conv_pool {(b, c, h, w, o, d)}"] = torch.library.opcheck(
            torch.ops.dlwp_torch.fused_conv_pool.default, (x, k, bias, d))
    zx, zh = (torch.randn(B, 4 * 12, NLAT, NLON, device=dev, generator=g)
              .requires_grad_() for _ in range(2))
    cc = torch.randn(B, 12, NLAT, NLON, device=dev,
                     generator=g).requires_grad_()
    out[f"lstm_gates {(B, 12, NLAT, NLON)}"] = torch.library.opcheck(
        torch.ops.dlwp_torch.lstm_gates.default,
        (zx, zh, cc, "tanh", "hard_sigmoid", None))
    for name, res in out.items():
        log(f"serve opcheck {name}: {res}")
        if set(res.values()) != {"SUCCESS"}:
            raise AssertionError(f"opcheck {name}: {res}")
    forward, (params, x) = entry()
    t0 = time.perf_counter()
    sv = export_program(functools.partial(forward, params), (x,))
    export_s = time.perf_counter() - t0
    xb = torch.randn(x.shape, device=dev, generator=g)
    got, want = sv.call(xb), forward(params, xb)
    equal = bool(torch.equal(got, want))
    log(f"serve entry(): exported in {export_s:.2f} s, {sv}; output "
        f"{tuple(got.shape)} bit-equal to the forward {equal}")
    if not equal:
        raise AssertionError("entry servable differs from its forward")
    out["entry"] = {"export_s": export_s, "bit_equal": equal}
    return out


def run_serve(torch, dev):
    """The serving phase: the flagship forecast servable, export_rollout,
    export_barotropic and the ops' checks."""
    torch.set_num_threads(os.cpu_count() or 1)
    out = serve_forecast(torch, dev)
    out["export_rollout"] = serve_rollout(torch, dev)
    out["barotropic"] = serve_barotropic(torch, dev)
    out["ops"] = serve_ops(torch, dev)
    return out


# ---------------------------------------------------------------------------
# The host data path: the native batch gather, predictor files, acquisition.
# The gather is checked at the flagship's batch (B=32, offsets 0..3, two
# channels) on 36x144 and on the paper run's 72x144, over a series of
# HOST_GATHER_N samples; fit_generator is timed in four turns (numpy,
# native, native, numpy) of HOST_FIT_EPOCHS epochs each.
HOST_GATHER_GRIDS = (("flagship 36x144", NLAT, NLON), ("paper run 72x144",
                                                      72, 144))
HOST_GATHER_N, HOST_GATHER_REPS, HOST_FIT_EPOCHS = 400, 30, 3
HOST_GATHER_THREADS = (1, 2, 4, 8)


def host_ms(fn, reps=HOST_GATHER_REPS, warmup=3):
    """Median host-clock ms of ``fn()`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def numpy_route():
    """Within this context the samplers gather as where no C compiler
    exists: the numpy version."""
    from unittest import mock

    from dlwp_torch.data import native

    return mock.patch.object(native, "have_native", lambda: False)


def stacked_route():
    """Within this context the series sampler gathers as it did before the
    native gather: a fancy index and a channel index a time step, a stack,
    and a cast that copies."""
    from unittest import mock

    from dlwp_torch.data.sampler import SeriesSampler

    def gather(self, samples, offsets, chan_idx):
        return np.stack([self._series[samples + n][:, chan_idx]
                         for n in offsets], axis=1).astype(self._dtype)

    return mock.patch.object(SeriesSampler, "_gather", gather)


def check_host_gather(torch):
    """(a) The native gather against its numpy version, bit for bit, at the
    flagship's batch on both grids, with duplicated and unsorted samples
    and channels; (b) one batch's assembly both ways (host clock, median
    of HOST_GATHER_REPS): the gather alone and the sampler's ``generate``
    of a B=32 flagship batch (insolation, casts, shaping)."""
    from dlwp_torch import SeriesSampler
    from dlwp_torch.data import native

    if not native.have_native():
        raise AssertionError("host_data: no C compiler for the native gather")
    rng = np.random.RandomState(11)
    out = {}
    offsets = np.arange(2 * TD)
    for name, h, w in HOST_GATHER_GRIDS:
        series = rng.randn(HOST_GATHER_N, C, h, w).astype(np.float32)
        samples = rng.randint(0, HOST_GATHER_N - len(offsets) + 1, TRAIN_B)
        samples[1::7] = samples[0]  # duplicates, in no order
        for chans in ([0, 1], [1, 0, 1]):
            before = native.assemble.launches
            got = native.assemble(series, samples, offsets, chans)
            want = native.assemble_plain(series, samples, offsets, chans)
            if native.assemble.launches != before + 1:
                raise AssertionError(f"host_data {name}: native did not run")
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"host_data {name} {chans}: differs")
        chans = [0, 1]
        ms = host_ms(lambda: native.assemble(series, samples, offsets, chans))
        plain = host_ms(
            lambda: native.assemble_plain(series, samples, offsets, chans))
        # The sampler's numpy gather before the native one (a fancy index
        # and a channel index a time step, a stack, a cast that copies).
        stacked = host_ms(lambda: np.stack(
            [series[samples + n][:, chans] for n in offsets],
            axis=1).astype(np.float32))
        threads = {n: host_ms(lambda: native.assemble(
            series, samples, offsets, chans, n_threads=n))
            for n in HOST_GATHER_THREADS}
        mb = 4 * TRAIN_B * len(offsets) * len(chans) * h * w / 1e6
        out[name] = {"ms": ms, "plain_ms": plain, "stacked_ms": stacked,
                     "ms_by_threads": threads, "batch_mb": mb,
                     "native_gb_per_s": 2 * mb / ms, "bit_equal": True}
        log(f"host_data gather {name}: B={TRAIN_B} x offsets 0..3 x "
            f"{len(chans)} channels ({mb:.2f} MB) bit-equal to numpy "
            f"(also with duplicated, unsorted samples and channels [1, 0, "
            f"1]); host clock, median of {HOST_GATHER_REPS}: native "
            f"{ms:.3f} ms ({2 * mb / ms:.2f} GB/s read + written), numpy "
            f"{plain:.3f} ms ({plain / ms:.2f}x), the sampler's earlier "
            f"stacked numpy form {stacked:.3f} ms ({stacked / ms:.2f}x); "
            f"native by threads " + ", ".join(
                f"{n}: {t:.3f} ms" for n, t in threads.items()))
    sampler = SeriesSampler(flagship_dataset(FIT_TIME_N), input_time_steps=TD,
                            output_time_steps=TD, add_insolation=True,
                            batch_size=TRAIN_B, shuffle=True, seed=0,
                            is_recurrent=True)
    batch = sampler._indices[:TRAIN_B]
    native_x, native_y = sampler.generate(batch)
    ms = host_ms(lambda: sampler.generate(batch))
    with numpy_route():
        plain_x, plain_y = sampler.generate(batch)
        plain = host_ms(lambda: sampler.generate(batch))
    if not (np.array_equal(native_x, plain_x)
            and np.array_equal(native_y, plain_y)):
        raise AssertionError("host_data: sampler batches differ by route")
    with stacked_route():
        stacked_x, stacked_y = sampler.generate(batch)
        stacked = host_ms(lambda: sampler.generate(batch))
    if not (np.array_equal(native_x, stacked_x)
            and np.array_equal(native_y, stacked_y)):
        raise AssertionError("host_data: the earlier gather's batch differs")
    out["generate"] = {"ms": ms, "plain_ms": plain, "stacked_ms": stacked,
                       "split_ms": generate_split(sampler, batch)}
    log(f"host_data one flagship batch's generate (B={TRAIN_B}, insolation, "
        f"inputs {native_x.shape}, targets {native_y.shape}): native "
        f"{ms:.3f} ms, numpy {plain:.3f} ms, the earlier stacked form "
        f"{stacked:.3f} ms (host clock, median of {HOST_GATHER_REPS}); "
        f"batches bit-equal; its parts alone: "
        + ", ".join(f"{k} {v:.3f} ms"
                    for k, v in out["generate"]["split_ms"].items()))
    return out


def generate_split(sampler, batch):
    """The parts of ``SeriesSampler.generate`` for one batch, each timed
    alone (host clock, median of HOST_GATHER_REPS): the two native
    gathers, the insolation channel's stack and its concatenation to the
    inputs, and the NaN check of inputs and targets."""
    s, n = sampler, len(batch)
    t0 = s._in_ts + s._interval - 1
    p = s._gather(batch, range(s._in_ts), s._input_idx)
    y = s._gather(batch, range(t0, t0 + s._out_ts), s._output_idx)
    sol = np.stack([s._insolation[batch + k] for k in range(s._in_ts)],
                   axis=1)[:, :, None]
    return {
        "gather inputs": host_ms(
            lambda: s._gather(batch, range(s._in_ts), s._input_idx)),
        "gather targets": host_ms(
            lambda: s._gather(batch, range(t0, t0 + s._out_ts),
                              s._output_idx)),
        "insolation stack": host_ms(lambda: np.stack(
            [s._insolation[batch + k] for k in range(s._in_ts)],
            axis=1)[:, :, None]),
        "concatenate": host_ms(lambda: np.concatenate([p, sol], axis=2)),
        "NaN check": host_ms(lambda: np.isnan(p.reshape(n, -1)).any(1)
                             | np.isnan(y.reshape(n, -1)).any(1)),
    }


def host_fit_turns(torch, dev):
    """(c) fit_generator in turns, the earlier stacked numpy gather,
    native, native, stacked (``time_fit_generator`` over
    HOST_FIT_EPOCHS epochs): each turn's native call count (two a batch,
    or none) and its split into sampler, copies, steps and the rest."""
    out = {"stacked": [], "native": []}
    for route in ("stacked", "native", "native", "stacked"):
        if route == "stacked":
            with stacked_route():
                r = time_fit_generator(torch, dev, epochs=HOST_FIT_EPOCHS)
        else:
            r = time_fit_generator(torch, dev, epochs=HOST_FIT_EPOCHS)
        want = 2 * r["steps"] if route == "native" else 0
        if r["native_calls"] != want:
            raise AssertionError(f"host_data fit ({route}): native calls "
                                 f"{r['native_calls']} != {want}")
        r["split"] = {k: r[f"{k}_s"] / r["fit_s"]
                      for k in ("assembly", "copy", "step", "rest")}
        out[route].append(r)
        log(f"host_data fit_generator ({route} gather): "
            f"{r['samples_per_s']:.1f} samples/s; sampler / copies / steps "
            f"/ rest = " + " / ".join(f"{100 * v:.1f}%"
                                       for v in r["split"].values()))
    return out


def host_main_path(torch, dev):
    """The phase's path, counted from 0: one fit_generator epoch of the
    timed flagship (B=32, no validation) through the native gather."""
    from dlwp_torch.data import native
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    net, train, _ = train_stack(dev, n=FIT_TIME_N)
    net.trainer.init(train[0][0])  # else the fit reads a batch to init
    reset_launch_counts()
    native.assemble.launches = 0
    net.fit_generator(train, epochs=1, verbose=False)
    torch.cuda.synchronize()
    counts, calls = launch_counts(), native.assemble.launches
    if counts != expected_counts(lstm_gates=len(train)):
        raise AssertionError(f"host_data fit launches {counts}")
    if calls != 2 * len(train):
        raise AssertionError(f"host_data native calls {calls} != "
                             f"{2 * len(train)} (two a batch)")
    log(f"host_data fit_generator epoch: {len(train)} batches, native "
        f"gather calls {calls} (inputs and targets), launches {counts}")
    return counts, calls, len(train)


class SyntheticSource:
    """A DataSource at the flagship's grid: two varlevs of ``n`` 6-hourly
    fields from ``RandomState(seed)``, in physical units."""

    def __init__(self, n, seed=0):
        self.times = (np.datetime64("2007-01-01")
                      + np.arange(n) * np.timedelta64(6, "h"))
        self.lat = np.linspace(87.5, 0.0, NLAT)
        self.lon = np.arange(NLON) * (360.0 / NLON)
        rng = np.random.RandomState(seed)
        self._f = {("HGT", 500): 5500.0 + 50.0 * rng.randn(n, NLAT, NLON),
                   ("THICK", "300-700"): 4000.0
                   + 30.0 * rng.randn(n, NLAT, NLON)}

    def field(self, variable, level):
        return self._f[variable, level]


def host_file_flow(torch, dev):
    """(d) Where h5py imports: the Preprocessor streams a synthetic 36x144
    source to a predictor file, ``from_file(load='lazy')``, a shuffled
    SeriesSampler over it yields the in-memory sampler's batches bit for
    bit, and one fit_generator epoch trains on the card from it. Where it
    does not: writing and reading raise the JAX package's RuntimeError."""
    import tempfile

    from dlwp_torch import PredictorDataset
    from dlwp_torch.data import Preprocessor, SeriesSampler

    args = (["HGT", "THICK"], [500, "300-700"])
    src = SyntheticSource(TRAIN_N)
    try:
        import h5py
    except ImportError:
        h5py = None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "series.h5")
        if h5py is None:
            memory = Preprocessor(src).data_to_series(*args, pairwise=True)
            for call in (lambda: memory.to_file(path),
                         lambda: PredictorDataset.from_file(path),
                         lambda: Preprocessor(src).data_to_series(
                             *args, pairwise=True, output_file=path)):
                try:
                    call()
                except RuntimeError as e:
                    if "h5py" not in str(e):
                        raise
                else:
                    raise AssertionError("host_data: file I/O without h5py")
            log("host_data file flow: h5py does not import on this host; "
                "to_file, from_file and Preprocessor(output_file=) raise "
                "RuntimeError('h5py is required for predictor-file I/O'), "
                "as the JAX package does")
            return {"h5py": False}
        t0 = time.perf_counter()
        lazy = Preprocessor(src).data_to_series(*args, pairwise=True,
                                                output_file=path)
        write_s = time.perf_counter() - t0
        memory = Preprocessor(src).data_to_series(*args, pairwise=True)
        net, _, _ = train_stack(dev)
        kw = dict(input_time_steps=TD, output_time_steps=TD,
                  add_insolation=True, batch_size=TRAIN_B, shuffle=True,
                  seed=0)
        from_file = SeriesSampler(lazy, model=net, **kw)
        if not isinstance(from_file._series, h5py.Dataset):
            raise AssertionError("host_data: the lazy series was read")
        for (x, y), (mx, my) in zip(
                list(SeriesSampler(lazy, model=net, **kw)),
                list(SeriesSampler(memory, model=net, **kw))):
            if not (np.array_equal(x, mx) and np.array_equal(y, my)):
                raise AssertionError("host_data: lazy batches differ")
        t0 = time.perf_counter()
        hist = net.fit_generator(from_file, epochs=1, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        loss = hist.history["loss"][-1]
        lazy.close()
    if not np.isfinite(loss):
        raise AssertionError(f"host_data: loss {loss}")
    log(f"host_data file flow: {TRAIN_N} samples streamed to a predictor "
        f"file in {write_s:.2f} s, read lazily; batches equal to the "
        f"in-memory sampler's; one fit_generator epoch on the card in "
        f"{fit_s:.2f} s, loss {loss:.4e}")
    return {"h5py": True, "write_s": write_s, "fit_s": fit_s, "loss": loss}


def host_retrieve(torch=None, dev=None):
    """(e) ``CFSReanalysis.retrieve`` against a local ``http.server``
    fixture (no network): each file fetched, one failing once and retried,
    one missing (two attempts and a warning, no file left), and a second
    retrieve sending requests only for the missing one (the present files
    are skipped)."""
    import http.server
    import tempfile
    import threading
    import warnings
    from datetime import datetime

    from dlwp_torch.data.cfs import CFSReanalysis

    requests, files, fail = [], {}, {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            requests.append(self.path)
            if fail.get(self.path, 0) > 0:
                fail[self.path] -= 1
                self.send_error(500, "scripted transient failure")
                return
            body = files.get(self.path)
            if body is None:
                self.send_error(404, "not found")
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with tempfile.TemporaryDirectory() as root:
            cfs = CFSReanalysis(root_directory=root)
            cfs.set_dates([datetime(2000, 1, 1), datetime(2000, 1, 2)])
            cfs._root_url = f"http://127.0.0.1:{httpd.server_address[1]}"
            rels = [cfs.grib_path(d) for d in cfs.dataset_dates]
            files.update({f"/{r}": f"grib {r}".encode() for r in rels[1:]})
            fail[f"/{rels[-1]}"] = 1
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                cfs.retrieve(n_proc=2)
                first = list(requests)
                cfs.retrieve(n_proc=2)
            again = requests[len(first):]
            present = [os.path.exists(os.path.join(root, r)) for r in rels]
            ok = all(open(os.path.join(root, r), "rb").read()
                     == f"grib {r}".encode() for r in rels[1:])
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    want = sorted([f"/{rels[0]}"] * 2 + [f"/{rels[-1]}"] * 2
                  + [f"/{r}" for r in rels[1:-1]])
    warned = [str(w.message) for w in caught
              if "failed to download" in str(w.message)]
    if not (ok and present == [False] + [True] * (len(rels) - 1)
            and sorted(first) == want and again == [f"/{rels[0]}"] * 2
            and len(warned) == 2 and all(rels[0] in w for w in warned)):
        raise AssertionError(f"host_data retrieve: {present} {first} {again} "
                             f"{warned}")
    log(f"host_data CFSReanalysis.retrieve against a local HTTP fixture: "
        f"{len(rels) - 1} of {len(rels)} files fetched ({len(first)} "
        f"requests: one transient failure retried, one missing file tried "
        f"twice with a warning), then a second retrieve re-asked only for "
        f"the missing file")
    return {"files": len(rels), "requests": len(first),
            "second_requests": len(again)}


def run_host_data(torch, dev):
    """``--only host_data``: the host data path (a)-(e)."""
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    out = {"gather": check_host_gather(torch)}
    out["fit_turns"] = host_fit_turns(torch, dev)
    out["launches"], out["native_calls"], out["batches"] = host_main_path(
        torch, dev)
    out["file_flow"] = host_file_flow(torch, dev)
    out["retrieve"] = host_retrieve()
    out["seconds"] = time.perf_counter() - t0
    log(f"host_data: {out['seconds']:.1f} s")
    return out


# The sharded training phase: the flagship train step at B=32 (the
# training phase's stack) on meshes of virtual shards of the one card,
# (data, lat) or (data, lat, lon), built with spatial_impl="overlap"; a
# lon axis sends every conv through the plain ring.
TRAIN_MESHES = ((1, 2), (2, 2), (1, 2, 2))
DRYRUN_ENTRIES = (8, 4)


def mesh_name(shape):
    return " x ".join(f"{a} {n}" for a, n in zip(("data", "lat", "lon"),
                                                  shape))


def step_run(torch, net, batches, dev=None):
    """TRAIN_CHECK_STEPS train steps of ``net`` on ``batches``: each step's
    loss, the first step's gradient and leaf modules' outputs (by name),
    the parameters before and after, and (on the card, ``dev``) each
    step's launches."""
    from dlwp_torch.kernels import launch_counts

    tr = net.trainer
    tr.init(batches[0][0])
    state = {k: v.detach().cpu().clone()
             for k, v in net.base_model.state_dict().items()}
    losses, grads, launches, outs = [], None, [], {}
    for k, (xb, yb) in enumerate(batches):
        hooks = [] if k else [m.register_forward_hook(
            lambda mod, inp, out, n=n: outs.__setitem__(n, out.detach().cpu()))
            for n, m in leaf_modules(net.base_model).items()]
        before = launch_counts()
        losses.append(tr.train_step(xb, yb)["loss"].item())
        for h in hooks:
            h.remove()
        if dev is not None:
            torch.cuda.synchronize()
            after = launch_counts()
            launches.append({n: after[n] - before[n] for n in after})
        if k == 0:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in net.base_model.named_parameters()}
    params = {k: v.detach().cpu().clone()
              for k, v in net.base_model.state_dict().items()}
    return {"losses": losses, "grads": grads, "params": params,
            "launches": launches, "before": state, "outs": outs}


def train_errors(got, want):
    """Loss (each step, relative), the first gradient without forcing and
    the parameters after the steps (relative RMS) of one step run against
    another."""
    return {"loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(got["losses"], want["losses"])),
            "grad_rel_rms_unforced": state_rel_rms(got["grads"],
                                                   want["grads"]),
            "params_rel_rms": state_rel_rms(got["params"], want["params"])}


def mesh_pool_flips(net, got, want):
    """:func:`pool_decisions` at each max pool of ``net`` (on its input,
    the leaf module before it) between two step runs' first forwards:
    {pool: (argmax flips, windows, smallest top-two gap of ``want``)}."""
    leaves = list(leaf_modules(net.base_model).items())
    return {n: pool_decisions(got[prev], want[prev])
            for (prev, _), (n, m) in zip(leaves, leaves[1:])
            if type(m).__name__ == "MaxPool2D"}


def run_sharded_train(torch, dev):
    """Training the flagship with its activations sharded over meshes of
    the card (the slice's main path): per mesh of TRAIN_MESHES, 3 train
    steps from the unsharded card model's weights on the same batches,
    held against the unsharded card run and the CPU's lat=2 run (plain
    versions) at TOL_TRAIN, each step's launches equal to one forward's
    dispatch (the backward recomputes through the plain exchange and
    launches no lat-band kernel); then fit_device for an epoch on the
    lat=2 mesh, dryrun_multichip on 8 and 4 entries of the card, and the
    sharded steps timed in turns with the unsharded one, split by part."""
    from dlwp_torch import DeviceSeriesSampler, dryrun_multichip, flax_tree
    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    card, train, _ = train_stack(dev)
    weights = flax_tree(card.base_model)
    batches = [train[i] for i in range(TRAIN_CHECK_STEPS)]
    nets, need, out_plans = {}, {}, {}
    for shape in TRAIN_MESHES:
        net, _, _ = train_stack(dev, mesh=virtual_mesh(dev, *shape))
        net.load_flax_params(weights)
        nets[shape] = net
        cpu, _, _ = train_stack("cpu", mesh=virtual_mesh(
            torch.device("cpu"), *shape))
        cpu.load_flax_params(weights)
        need[shape] = dispatch_launches(torch, cpu, TRAIN_B)
        if shape == TRAIN_MESHES[0]:
            cpu_lat2 = cpu
        kernels = [n for n in ("halo_exchange", "overlap_conv",
                               "overlap_conv_db") if need[shape][n]]
        # Which overlap kernel (and batch pieces) each 3x3 conv takes at
        # this mesh's per-shard train batch; (batch, None): single-shot.
        plans = {} if len(shape) == 3 else {
            name: overlap_dispatch(torch, (TRAIN_B // shape[0],) + sh[1:], o)
            for name, sh, o in OVERLAP_CONVS}
        out_plans[mesh_name(shape)] = plans
        log(f"sharded train {mesh_name(shape)}: launches a train step from "
            f"the dispatch {need[shape]}; overlap dispatch (batch, chunk) "
            f"{plans}")
        lon = len(shape) == 3
        if not need[shape]["lstm_gates"] or (not lon and (
                "halo_exchange" not in kernels or len(kernels) < 2)) or (
                lon and kernels):
            raise AssertionError(f"{mesh_name(shape)}: dispatch {need[shape]}")
    t0 = time.perf_counter()
    cpu_run = step_run(torch, cpu_lat2, batches)
    cpu_s = time.perf_counter() - t0
    ref = {"unsharded card": step_run(torch, card, batches),
           "CPU data 1 x lat 2": cpu_run}
    # The main path: every count from 0, read after the last mesh's steps.
    reset_launch_counts()
    runs = {shape: step_run(torch, nets[shape], batches, dev)
            for shape in TRAIN_MESHES}
    torch.cuda.synchronize()
    out = {"launches": launch_counts(),
           "launches_per_step": {mesh_name(k): v for k, v in need.items()},
           "overlap_dispatch": out_plans, "reference_s": cpu_s}
    for shape, run in runs.items():
        name = mesh_name(shape)
        for k, got in enumerate(run["launches"]):
            if got != need[shape]:
                raise AssertionError(f"{name} step {k}: launches {got} != "
                                     f"{need[shape]}")
        # The first gradient is held to the CPU's backward at this run's
        # forward values: a max pool whose top two differ by less than
        # fp32 resolves may route it otherwise (the forced check of
        # train_vs_cpu).
        forced = forced_gradient(torch, 1, None, run["before"], batches[0],
                                 run["outs"], mesh=virtual_mesh(
                                     torch.device("cpu"), *TRAIN_MESHES[0]))
        row = out[name] = {
            "losses": run["losses"],
            "grad_rel_rms": state_rel_rms(run["grads"], forced),
            "pool_flips_vs_cpu": mesh_pool_flips(nets[shape], run["outs"],
                                                 cpu_run["outs"])}
        for tag, want in ref.items():
            row[f"vs {tag}"] = train_errors(run, want)
        log(f"sharded train {name} ({TRAIN_CHECK_STEPS} steps at B="
            f"{TRAIN_B}; limits {TOL_TRAIN}): first gradient against the "
            f"CPU's backward at this run's forward values relative RMS "
            f"{row['grad_rel_rms']:.3e}; max-pool argmax flips against the "
            f"CPU (flips, windows, the CPU's smallest top-two gap) "
            f"{row['pool_flips_vs_cpu']}; launches each step {need[shape]}")
        for tag in ref:
            errs = row[f"vs {tag}"]
            log(f"  vs {tag}: loss relative {errs['loss_rel']:.3e}, first "
                f"gradient relative RMS (unforced) "
                f"{errs['grad_rel_rms_unforced']:.3e}, parameters relative "
                f"RMS {errs['params_rel_rms']:.3e}")
            for key, lim in (("loss_rel", "loss"),
                             ("params_rel_rms", "params")):
                if not errs[key] <= TOL_TRAIN[lim]:
                    raise AssertionError(f"{name} vs {tag} {key}: "
                                         f"{errs[key]} > {TOL_TRAIN[lim]}")
        if not row["grad_rel_rms"] <= TOL_TRAIN["grad"]:
            raise AssertionError(
                f"{name} first gradient (forced): {row['grad_rel_rms']} > "
                f"{TOL_TRAIN['grad']}")

    # fit_device for one epoch on the lat=2 mesh, the series on the card.
    shape = TRAIN_MESHES[0]
    net, train_m, _ = train_stack(dev, mesh=virtual_mesh(dev, *shape))
    net.load_flax_params(weights)
    sampler = DeviceSeriesSampler(train_m, sharding=net._spatial.mesh)
    net.trainer.init(sampler[0][0])
    reset_launch_counts()
    hist = net.trainer.fit_device(sampler, epochs=1, verbose=False)
    torch.cuda.synchronize()
    got = launch_counts()
    fit_need = {n: len(sampler) * v for n, v in need[shape].items()}
    loss = hist.history["loss"][-1]
    out["fit_device"] = {"loss": loss, "steps": len(sampler),
                         "launches": got}
    log(f"sharded train: fit_device 1 epoch on {mesh_name(shape)}: "
        f"{len(sampler)} steps, loss {loss:.6g}, launches {got}")
    if got != fit_need or not np.isfinite(loss):
        raise AssertionError(f"fit_device on the mesh: {got} != {fit_need}, "
                             f"loss {loss}")

    for n in DRYRUN_ENTRIES:
        t0 = time.perf_counter()
        losses = dryrun_multichip(n, devices=[dev] * n)
        torch.cuda.synchronize()
        out[f"dryrun_multichip({n})"] = {
            "losses": losses, "seconds": time.perf_counter() - t0}
        log(f"sharded train: dryrun_multichip({n}) on {n} entries of the "
            f"card: last losses {losses} ({time.perf_counter() - t0:.1f} s)")

    # Timing in turns on device-resident batches: unsharded, each mesh,
    # each mesh again in reverse order, unsharded. One card: the sharded
    # steps measure the port's overhead (shard copies, the recompute), not
    # a speed-up.
    steps = {}
    for tag, n in (("unsharded", card),) + tuple(
            (mesh_name(sh), nets[sh]) for sh in TRAIN_MESHES):
        tr = n.trainer
        xd, yd = tr._to_device(batches[0][0]), tr._to_device(batches[0][1])
        steps[tag] = lambda tr=tr, xd=xd, yd=yd: tr.train_step(xd, yd)
    order = list(steps)
    times = {tag: [] for tag in order}
    for tag in order + order[::-1]:
        times[tag].append(timed_ms(steps[tag], reps=5, inner=5, warmup=3))
    for tag in order:
        ms = float(np.mean(times[tag]))
        split = train_step_split(torch, steps[tag])
        device = sum(v[0] for v in split.values())
        backward = sum(v[0] for k, v in split.items() if k in BACKWARD_PARTS)
        recompute = split.get(SHARDED_RECOMPUTE, [0.0])[0]
        fast_bwd = sum(v[0] for k, v in split.items()
                       if k.startswith("sharded conv backward"))
        row = out.setdefault(tag, {})
        row.update({
            "ms_per_step": ms, "ms_turns": times[tag],
            "samples_per_s": TRAIN_B * 1e3 / ms,
            "device_ms_per_step": device, "idle_share": 1 - device / ms,
            "backward_device_ms": backward,
            "recompute_share_of_backward": recompute / max(backward, 1e-9),
            "sharded_conv_backward_ms": fast_bwd,
            "split_ms": {k: v[0] for k, v in split.items()},
            "split_launches": {k: v[1] for k, v in split.items()}})
        log(f"sharded train timing {tag} B={TRAIN_B}: {ms:.3f} ms a step "
            f"(turns {', '.join(f'{t:.3f}' for t in times[tag])}) -> "
            f"{row['samples_per_s']:.1f} samples/s; device {device:.3f} ms "
            f"(idle {100 * row['idle_share']:.1f}%), backward {backward:.3f} "
            f"ms: the kernel paths' backward {fast_bwd:.3f} ms, of it the "
            f"plain-exchange forward recomputed {recompute:.3f} ms "
            f"({100 * row['recompute_share_of_backward']:.1f}% of the "
            f"backward)")
        for k, v in sorted(split.items(), key=lambda kv: -kv[1][0]):
            log(f"  {v[0]:8.4f} ms {100 * v[0] / max(device, 1e-9):5.1f}% "
                f"x{v[1]:<4d} {k}: {'; '.join(v[2])}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"sharded_train: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Across cards and processes. (a) The lat-band kernels with lat neighbours
# on two cards of one process (peer access), where the machine has two
# cards or more. (b) MC_NPROC ranks spawned over torch.multiprocessing:
# on cuda:0 with gloo (NCCL refuses two ranks on one GPU: the phase asks
# it, probe_nccl_shared_card), and with two cards or more also NCCL with
# a card a rank. Each rank trains the
# flagship with the data axis across the ranks and lat 2 on its own card,
# runs sharded_cyclic_conv2d with a lat axis across the ranks, and the
# lat-across-ranks checks: the kernels over CUDA IPC, training, the
# spectral core and the lon ring (lat_across_worker, lat_across_plain).
MC_NPROC = 2
MC_TIMEOUT = 420
MC_IPC_CALLS = 20
MC_SP_SHAPE, MC_SP_O = (B, 12, NLAT, NLON), 48  # the recurrent conv's
MC_TIME_STEPS, MC_REDUCE_REPS = 5, 10
MC_PROBE_TIMEOUT = 90


def multicard_worker(rank, nproc, port, backend, devices, out_dir):
    """One rank of phase (b) on ``devices[rank]`` (a device name): results
    to ``out_dir/rank<rank>.npz`` and ``.json``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dlwp_torch.kernels import launch_counts, reset_launch_counts
    from dlwp_torch.ops.conv import cyclic_conv2d
    from dlwp_torch.parallel import MeshConfig, SpatialSharding
    from dlwp_torch.parallel.distributed import (
        all_reduce_mean, initialize_distributed, multihost_mesh,
        process_index,
    )
    from dlwp_torch.parallel.halo import sharded_cyclic_conv2d

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_distributed(f"localhost:{port}", nproc, rank, backend=backend,
                           device=dev)
    info, arrays = {"rank": process_index(), "device": str(dev)}, {}
    mesh = multihost_mesh(MeshConfig(data=nproc, lat=2), devices=[dev] * 2)
    info["mesh"] = mesh.shape
    net, train, _ = train_stack(dev, mesh=mesh)
    batches = [train[i] for i in range(TRAIN_CHECK_STEPS)]
    reset_launch_counts()
    run = step_run(torch, net, batches, dev)
    torch.cuda.synchronize()
    info["launches"] = launch_counts()
    info["losses"] = run["losses"]
    for k, v in run["params"].items():
        arrays[f"param/{k}"] = v.numpy()
    for k, v in run["grads"].items():
        arrays[f"grad/{k}"] = v.numpy()
    # ms a train step (host clock, synchronised), and the gradient
    # all-reduce alone on a buffer of the gradients' size.
    tr = net.trainer
    xb, yb = batches[0]
    ms = []
    for _ in range(MC_TIME_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(xb, yb)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    info["step_ms"] = ms
    grads = [p.grad for p in net.base_model.parameters()
             if p.grad is not None]
    info["reduce_bytes"] = 4 * (sum(g.numel() for g in grads) + 1)
    ms = []
    for _ in range(MC_REDUCE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_mean(grads + [grads[0].new_zeros(1)])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    info["reduce_ms"] = ms
    # A lat axis across the ranks: 2 * nproc bands, the plain exchange.
    mesh_sp = multihost_mesh(MeshConfig(data=1, lat=-1), devices=[dev] * 2)
    g = torch.Generator().manual_seed(4)  # the same field on every rank
    x = torch.randn(MC_SP_SHAPE, generator=g).to(dev)
    k = (torch.randn(MC_SP_O, MC_SP_SHAPE[1], 3, 3, generator=g)
         / (9 * MC_SP_SHAPE[1]) ** 0.5).to(dev)
    got = sharded_cyclic_conv2d(x, k, mesh_sp, data_axis=None)
    info["sp_mesh"] = mesh_sp.shape
    want = cyclic_conv2d(x, k)
    info["sp_err"] = float((got - want).abs().max())
    try:
        got = SpatialSharding(mesh_sp, data_axis=None,
                              impl="overlap").conv(x, k)
        info["sp_kernel_err"] = float((got - want).abs().max())
        lat_across_worker(torch, dev, nproc, info, arrays)
    except RuntimeError as e:
        # A machine that refuses CUDA IPC: the mailbox raises with the
        # CUDA error (no fallback); the IPC items stay unverified.
        if "cudaIpc" not in str(e):
            raise
        info["ipc_refused"] = str(e)
    lat_across_plain(torch, dev, info)
    from dlwp_torch.kernels.halo_exchange import release_mailboxes

    release_mailboxes()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


def lat_whole(torch, dev, x, mesh, n):
    """``x`` split over ``mesh`` (this rank's bands, Remote elsewhere) and
    over ``n`` virtual lat shards of the card (every band here): the same
    inputs for the cross-process launch and the one-process one."""
    from dlwp_torch.parallel.mesh import split_shards

    return (split_shards(x, mesh, None, "lat"),
            split_shards(x, virtual_mesh(dev, 1, n), None, "lat"))


def mine_equal(torch, got, want):
    """Whether this rank's bands of ``got`` equal ``want``'s bit for bit
    (``Remote`` places skipped); and the largest |got - want| there."""
    pairs = [(a, b) for ra, rb in zip(got, want) for a, b in zip(ra, rb)
             if isinstance(a, torch.Tensor)]
    return (all(torch.equal(a, b) for a, b in pairs),
            max(float((a - b).abs().max()) for a, b in pairs))


def ipc_timing(torch, ipc, repeated, box):
    """The cross-process launch (``ipc``) against the repeated-card launch
    of the same shapes (``repeated``), MC_IPC_CALLS calls each after a
    warm-up: ms a call on the host clock (synchronised at the end) and on
    the device (CUDA events around the calls), the barrier's share of the
    host time, and the kernel's own device time (torch.profiler, one
    session of the same calls on every rank)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in (("ipc", ipc), ("repeated_card", repeated)):
        fn()
        torch.cuda.synchronize()
        b0 = box.barrier_seconds
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(MC_IPC_CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t0) / MC_IPC_CALLS
        out[name] = {"host_ms": host,
                     "device_ms": start.elapsed_time(end) / MC_IPC_CALLS}
        if name == "ipc":
            out[name]["barrier_ms"] = (1e3 * (box.barrier_seconds - b0)
                                       / MC_IPC_CALLS)
            out[name]["barrier_share"] = out[name]["barrier_ms"] / host
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(MC_IPC_CALLS):
                fn()
            torch.cuda.synchronize()
        rows = {e.key: e.device_time_total / 1e3 / MC_IPC_CALLS
                for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0
                and e.device_type.name == "CUDA"}
        out[name]["kernel_device_ms"] = sum(
            v for k, v in rows.items() if "kernel" in k) or None
        out[name]["copy_device_ms"] = sum(
            v for k, v in rows.items() if "emcpy" in k) or None
    out["open_ms"] = 1e3 * box.open_seconds
    return out


def lat_across_worker(torch, dev, nproc, info, arrays):
    """A lat axis across the ranks through the kernels (CUDA IPC): the
    halo kernel on lat 2 and lat 4 (one and two bands a rank) bit-equal to
    the one-process kernel on the same inputs, both overlap kernels at the
    lat=2 forecast's conv shapes against their plain versions and the
    one-process kernel, each rank's launch counts, the IPC launch's time
    beside the repeated-card launch; then TRAIN_CHECK_STEPS flagship train
    steps at B=TRAIN_B with lat across the ranks (overlap impl)."""
    from dlwp_torch.kernels import (
        halo_exchange, launch_counts, overlap_conv, overlap_conv_db,
        overlap_conv_plain, reset_launch_counts,
    )
    from dlwp_torch.kernels.halo_exchange import mailboxes
    from dlwp_torch.parallel import MeshConfig
    from dlwp_torch.parallel.distributed import multihost_mesh

    g = torch.Generator().manual_seed(11)  # the same inputs on every rank
    name, shape, _, kh, d = HALO_CONVS[0]
    halo = ((kh - 1) * d // 2, (kh - 1) * d - (kh - 1) * d // 2)
    x = torch.randn(shape, generator=g).to(dev)
    halo_out = {}
    for per in (1, 2):
        mesh = multihost_mesh(MeshConfig(data=1, lat=-1), devices=[dev] * per)
        shards, whole = lat_whole(torch, dev, x, mesh, nproc * per)
        reset_launch_counts()
        got = halo_exchange(shards, halo)
        torch.cuda.synchronize()
        launches = launch_counts()["halo_exchange"]
        same, _ = mine_equal(torch, got, halo_exchange(whole, halo))
        halo_out[f"lat{nproc * per}"] = {"bit_equal": same,
                                         "launches": launches}
    info["ipc_halo"] = {"conv": name, "shape": shape, "halo": halo,
                        **halo_out}
    mesh2 = multihost_mesh(MeshConfig(data=1, lat=-1), devices=[dev])
    shards, whole = lat_whole(torch, dev, x, mesh2, nproc)
    box = next(b for b in mailboxes() if b.H == shape[2] // nproc)
    info["ipc_halo"]["timing"] = ipc_timing(
        torch, lambda: halo_exchange(shards, halo),
        lambda: halo_exchange(whole, halo), box)
    conv = []
    for (cname, cshape, o), chunk in zip(OVERLAP_CONVS, (5, 11, 4)):
        xc = torch.randn(cshape, generator=g).to(dev)
        kc = (torch.randn(o, cshape[1], 3, 3, generator=g)
              / (9 * cshape[1]) ** 0.5).to(dev)
        shards, whole = lat_whole(torch, dev, xc, mesh2, nproc)
        want = overlap_conv_plain(whole, kc)
        row = {"conv": cname, "shape": cshape, "O": o, "chunk": chunk}
        for kname, fn in (("overlap_conv", overlap_conv),
                          ("overlap_conv_db",
                           lambda s, kk: overlap_conv_db(s, kk, chunk))):
            reset_launch_counts()
            got = fn(shards, kc)
            torch.cuda.synchronize()
            launches = launch_counts()[kname]
            _, err = mine_equal(torch, got, want)
            same, _ = mine_equal(torch, got, fn(whole, kc))
            row[kname] = {"max_abs_vs_plain": err, "launches": launches,
                          "bit_equal_one_process": same}
        if cname == "convlstm recurrent":
            box = next(b for b in mailboxes()
                       if b.rows == cshape[0] * cshape[1]
                       and b.H == cshape[2] // nproc)
            row["timing"] = ipc_timing(
                torch, lambda: overlap_conv(shards, kc),
                lambda: overlap_conv(whole, kc), box)
            row["timing_db"] = ipc_timing(
                torch, lambda: overlap_conv_db(shards, kc, chunk),
                lambda: overlap_conv_db(whole, kc, chunk), box)
        conv.append(row)
    info["ipc_overlap"] = conv
    # Training with lat across the ranks, through the overlap impl.
    net, train, _ = train_stack(dev, mesh=mesh2)
    batches = [train[i] for i in range(TRAIN_CHECK_STEPS)]
    reset_launch_counts()
    run = step_run(torch, net, batches, dev)
    torch.cuda.synchronize()
    info["lat_launches"] = launch_counts()
    info["lat_losses"] = run["losses"]
    info["lat_mesh"] = mesh2.shape
    for k, v in run["params"].items():
        arrays[f"lat_param/{k}"] = v.numpy()
    for k, v in run["grads"].items():
        arrays[f"lat_grad/{k}"] = v.numpy()
    xb, yb = batches[0]
    ms = []
    for _ in range(MC_TIME_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.trainer.train_step(xb, yb)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    info["lat_step_ms"] = ms


def lat_across_plain(torch, dev, info):
    """The moves that need no IPC, with the lat (or lon) axis across the
    ranks: the sharded spectral engine and SHARD_STEPS barotropic steps
    (lat 2 across the ranks, SHARD_GRID) against the unsharded ones, and a
    lon=2 conv whose ring spans the ranks against ``cyclic_conv2d``."""
    from dlwp_torch import BarotropicModel, LatLonGrid, SphericalHarmonics
    from dlwp_torch.ops.conv import cyclic_conv2d
    from dlwp_torch.parallel import (
        MeshConfig, ShardedBarotropicModel, ShardedSphericalHarmonics,
    )
    from dlwp_torch.parallel.distributed import multihost_mesh
    from dlwp_torch.parallel.halo import sharded_cyclic_conv2d

    nlat, nlon, T = SHARD_GRID
    grid = LatLonGrid.gaussian(nlat, nlon)
    mesh = multihost_mesh(MeshConfig(data=1, lat=-1), devices=[dev])
    sh = SphericalHarmonics.build(grid, T, device=dev)
    ssh = ShardedSphericalHarmonics(sh, mesh)
    spec = random_spec(torch, dev, (4,), T)
    field = sh.synthesize(spec)
    errs = {
        "analyze": scaled_err(ssh.analyze(field), sh.analyze(field)),
        "synthesize": scaled_err(ssh.synthesize(spec), sh.synthesize(spec)),
        "uv_from_vrtdiv": max(scaled_err(a, b) for a, b in zip(
            ssh.uv_from_vrtdiv(spec, spec), sh.uv_from_vrtdiv(spec, spec))),
    }
    kw = dict(dt=1800.0, damping_coefficient=5e-6, device=dev)
    ref = BarotropicModel(grid, T, **kw)
    shd = ShardedBarotropicModel(grid, T, mesh=mesh, **kw)
    state = ref.from_z(bench_height(grid))
    baro = rel_rms(shd.run_sharded(state, SHARD_STEPS).vrt_spec,
                   ref.run(state, SHARD_STEPS).vrt_spec)
    info["lat_spectral"] = {"mine": ssh.mine, "errors": errs,
                            "barotropic_rel_rms": baro}
    g = torch.Generator().manual_seed(5)
    x = torch.randn(MC_SP_SHAPE, generator=g).to(dev)
    k = (torch.randn(MC_SP_O, MC_SP_SHAPE[1], 3, 3, generator=g)
         / (9 * MC_SP_SHAPE[1]) ** 0.5).to(dev)
    lon = multihost_mesh(MeshConfig(data=1, lat=1, lon=-1), devices=[dev])
    got = sharded_cyclic_conv2d(x, k, lon, data_axis=None,
                                lon_axis_name="lon")
    info["lon_ring"] = {"mesh": lon.shape,
                        "max_abs_vs_cyclic_conv2d":
                        float((got - cyclic_conv2d(x, k)).abs().max())}


def spawn_ranks(torch, backend, devices):
    """Run :func:`multicard_worker` on ``devices`` (device names, one rank
    each) and return each rank's (info, arrays); every rank is stopped on
    the way out."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            multicard_worker, args=(len(devices), port, backend, devices,
                                    out_dir),
            nprocs=len(devices), join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > MC_TIMEOUT:
                    raise AssertionError(f"{backend} ranks still running "
                                         f"after {MC_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        ranks = []
        for r in range(len(devices)):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                info = json.load(f)
            with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
                ranks.append((info, dict(z)))
    log(f"multicard {backend} on {devices}: {len(devices)} ranks in "
        f"{time.perf_counter() - t0:.1f} s")
    return ranks


def nccl_shared_card_worker(rank, nproc, port, out_dir):
    """One of two NCCL ranks on cuda:0: join the group and all-reduce a
    small tensor through the port's calls; what happened to
    ``out_dir/rank<rank>.json``. Exits without tearing the group down,
    which may wait on the other rank."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dlwp_torch.parallel.distributed import (
        all_reduce_mean, initialize_distributed,
    )

    torch.cuda.set_device(0)
    try:
        initialize_distributed(f"localhost:{port}", nproc, rank,
                               backend="nccl", device="cuda:0")
        (t,) = all_reduce_mean([torch.full((4,), float(rank + 1),
                                           device="cuda:0")])
        torch.cuda.synchronize()
        res = {"ran": True, "mean": float(t[0])}
    except Exception as e:  # the outcome is what this probe reports
        res = {"ran": False, "error": f"{type(e).__name__}: {e}"}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    sys.stdout.flush()
    os._exit(0)


def probe_nccl_shared_card(torch):
    """What NCCL does with two ranks on one card (the reason two ranks on
    one card use gloo): each rank's outcome, or 'still running' after
    MC_PROBE_TIMEOUT s (then stopped)."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            nccl_shared_card_worker, args=(2, port, out_dir), nprocs=2,
            join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=2):
                if time.perf_counter() - t0 > MC_PROBE_TIMEOUT:
                    break
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        got = []
        for r in range(2):
            path = os.path.join(out_dir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    got.append(json.load(f))
            else:
                got.append({"ran": False, "error": "still running after "
                            f"{MC_PROBE_TIMEOUT} s; stopped"})
    for r, res in enumerate(got):
        what = (f"ran, mean {res['mean']}" if res["ran"]
                else "refused: " + " | ".join(
                    ln.strip() for ln in res["error"].splitlines()
                    if ln.strip())[:600])
        log(f"multicard NCCL, 2 ranks on cuda:0, rank {r}: {what}")
    return got


def run_torchrun(torch, n_cards):
    """``torchrun --nproc_per_node MC_NPROC -m dlwp_torch.entry
    --distributed`` from this checkout, as a user starts it: the backend
    each rank chose (gloo where the ranks outnumber the cards, else NCCL),
    equal losses and parameters across ranks, finite losses. Every process
    of its session is stopped on the way out."""
    import signal
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + ([os.environ["PYTHONPATH"]]
                  if os.environ.get("PYTHONPATH") else [])))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(MC_NPROC), "--master_addr", "localhost",
           "--master_port", str(port), "-m", "dlwp_torch.entry",
           "--distributed"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=MC_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"torchrun rc={proc.returncode}:\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    outs = sorted((json.loads(ln.split(": ", 1)[1])
                   for ln in stdout.splitlines()
                   if ln.startswith("train_distributed rank")),
                  key=lambda o: o["rank"])
    want = "gloo" if MC_NPROC > n_cards else "nccl"
    if not ([o["rank"] for o in outs] == list(range(MC_NPROC))
            and all(o["backend"] == want for o in outs)
            and all(o["losses"] == outs[0]["losses"]
                    and o["param_checksum"] == outs[0]["param_checksum"]
                    for o in outs)
            and np.isfinite(outs[0]["losses"]).all()):
        raise AssertionError(f"torchrun ranks: {outs}")
    seconds = time.perf_counter() - t0
    log(f"multicard torchrun --nproc_per_node {MC_NPROC} -m dlwp_torch.entry"
        f" --distributed: backend {want} on {[o['device'] for o in outs]}, "
        f"mesh {outs[0]['mesh']}, losses {outs[0]['losses']} equal across "
        f"ranks, parameters equal; {seconds:.1f} s")
    return {"backend": want, "ranks": outs, "seconds": seconds}


def check_ranks(torch, backend, ranks, ref, single_ms, need, need_lat):
    """Phase (b)'s checks of one backend's ranks: each rank's launches
    equal to ``need`` (one forward's dispatch a step), parameters (and the
    first gradient) bit-equal across ranks, losses and parameters against
    the single-process card run at TOL_TRAIN, the cross-rank lat conv at
    TOL_F32 (plain and overlap impl); ms a step and the all-reduce's; then
    :func:`check_lat_across` (``need_lat``: its train steps' launches)."""
    (i0, a0) = ranks[0]
    for info, _ in ranks:
        if info["launches"] != need:
            raise AssertionError(f"{backend} rank {info['rank']}: launches "
                                 f"{info['launches']} != {need}")
    for info, arrays in ranks[1:]:
        for key in a0:
            if not np.array_equal(a0[key], arrays[key]):
                raise AssertionError(f"{backend}: {key} differs across ranks")
        if info["losses"] != i0["losses"]:
            raise AssertionError(f"{backend}: losses differ across ranks")
    got = {"losses": i0["losses"],
           "grads": {k[5:]: torch.from_numpy(v) for k, v in a0.items()
                     if k.startswith("grad/")},
           "params": {k[6:]: torch.from_numpy(v) for k, v in a0.items()
                      if k.startswith("param/")}}
    errs = train_errors(got, ref)
    log(f"multicard {backend}: data across {MC_NPROC} ranks x lat 2 each, "
        f"{TRAIN_CHECK_STEPS} steps at B={TRAIN_B} against one process on "
        f"the card: {errs}; parameters and first gradient bit-equal across "
        "ranks")
    if not (errs["loss_rel"] <= TOL_TRAIN["loss"]
            and errs["grad_rel_rms_unforced"] <= TOL_TRAIN["grad"]
            and errs["params_rel_rms"] <= TOL_TRAIN["params"]):
        raise AssertionError(f"multicard {backend} training: {errs}")
    out = {"train_vs_one_process": errs, "mesh": i0["mesh"],
           "launches_by_rank": [i["launches"] for i, _ in ranks]}
    for info, _ in ranks:
        if info["sp_err"] > TOL_F32 or info.get("sp_kernel_err",
                                                0.0) > TOL_F32:
            raise AssertionError(f"multicard {backend} rank {info['rank']}: "
                                 f"lat across ranks {info['sp_err']}, "
                                 f"kernel impl {info.get('sp_kernel_err')}")
    out["lat_across_ranks"] = {
        "mesh": i0["sp_mesh"], "shape": MC_SP_SHAPE,
        "max_abs_vs_cyclic_conv2d": max(i["sp_err"] for i, _ in ranks),
        "overlap_impl_max_abs": max(i.get("sp_kernel_err", float("nan"))
                                    for i, _ in ranks)}
    step = float(np.median([m for i, _ in ranks for m in i["step_ms"][1:]]))
    red = float(np.median([m for i, _ in ranks for m in i["reduce_ms"][1:]]))
    out.update(step_ms=step, single_process_step_ms=single_ms,
               all_reduce_ms=red, all_reduce_bytes=i0["reduce_bytes"])
    lat = out["lat_across_ranks"]
    log(f"multicard {backend}: lat {i0['sp_mesh']} across ranks vs "
        f"cyclic_conv2d max abs {lat['max_abs_vs_cyclic_conv2d']:.3e} "
        f"(plain), {lat['overlap_impl_max_abs']:.3e} (overlap impl); a "
        f"train step {step:.2f} ms (host clock, median) against "
        f"{single_ms:.2f} one process unsharded; the gradient all-reduce "
        f"{red:.3f} ms for {i0['reduce_bytes']} bytes")
    out["lat_across"] = check_lat_across(torch, backend, ranks, ref, need_lat)
    return out


def check_lat_across(torch, backend, ranks, ref, need):
    """Phase (b)'s lat-across-ranks checks (:func:`lat_across_worker`,
    :func:`lat_across_plain`): the halo kernel bit-equal to the
    one-process kernel, one launch a call on every rank; both overlap
    kernels within TOL_F32 of their plain versions and bit-equal to the
    one-process kernel; the IPC times; the train steps against the
    one-process unsharded card run at TOL_TRAIN with ``need`` launches on
    each rank; the spectral core and the lon ring. Where the machine
    refused IPC, the error and the unverified items."""
    out = {}
    refused = [i.get("ipc_refused") for i, _ in ranks]
    if any(refused):
        out["ipc_refused"] = refused
        log(f"multicard {backend} lat across ranks: CUDA IPC refused: "
            f"{refused}; unverified: the halo and overlap kernels across "
            "processes, their launch counts and times, and the train steps "
            "through them")
    else:
        for info, _ in ranks:
            r = info["rank"]
            h = info["ipc_halo"]
            for key in ("lat2", "lat4"):
                ok = h[key]["bit_equal"] and h[key]["launches"] == 1
                log(f"multicard {backend} rank {r}: halo_exchange over IPC, "
                    f"{h['conv']} {h['shape']} halo {h['halo']}, {key}: "
                    f"bit-equal to the one-process kernel {h[key]['bit_equal']}"
                    f", launches {h[key]['launches']}")
                if not ok:
                    raise AssertionError(f"{backend} rank {r} halo {key}: "
                                         f"{h[key]}")
            for row in info["ipc_overlap"]:
                for kname in ("overlap_conv", "overlap_conv_db"):
                    v = row[kname]
                    log(f"multicard {backend} rank {r}: {kname} over IPC, "
                        f"{row['conv']} {row['shape']}->{row['O']}: max|"
                        f"kernel-plain| {v['max_abs_vs_plain']:.3e}, bit-"
                        f"equal to the one-process kernel "
                        f"{v['bit_equal_one_process']}, launches "
                        f"{v['launches']}")
                    if not (v["max_abs_vs_plain"] <= TOL_F32
                            and v["bit_equal_one_process"]
                            and v["launches"] == 1):
                        raise AssertionError(f"{backend} rank {r} {kname} "
                                             f"{row['conv']}: {v}")
            rec = info["ipc_overlap"][0]
            for label, t in (("halo_exchange " + h["conv"], h["timing"]),
                             ("overlap_conv " + rec["conv"], rec["timing"]),
                             (f"overlap_conv_db {rec['conv']} chunk "
                              f"{rec['chunk']}", rec["timing_db"])):
                i, c = t["ipc"], t["repeated_card"]
                log(f"multicard {backend} rank {r}: {label} a call over IPC "
                    f"{i['host_ms']:.4f} ms host clock, {i['device_ms']:.4f} "
                    f"ms device (events; kernel {i['kernel_device_ms']}, "
                    f"edge copies {i['copy_device_ms']}), barrier "
                    f"{i['barrier_ms']:.4f} ms ({100 * i['barrier_share']:.1f}"
                    f"% of the host time); the repeated-card launch "
                    f"{c['host_ms']:.4f} ms host, {c['device_ms']:.4f} ms "
                    f"device (kernel {c['kernel_device_ms']}); opening the "
                    f"handles once {t['open_ms']:.1f} ms")
            if info["lat_launches"] != need:
                raise AssertionError(f"{backend} rank {r} lat train launches "
                                     f"{info['lat_launches']} != {need}")
        i0, a0 = ranks[0]
        got = {"losses": i0["lat_losses"],
               "grads": {k[9:]: torch.from_numpy(v) for k, v in a0.items()
                         if k.startswith("lat_grad/")},
               "params": {k[10:]: torch.from_numpy(v) for k, v in a0.items()
                          if k.startswith("lat_param/")}}
        errs = train_errors(got, ref)
        step = float(np.median([m for i, _ in ranks
                                for m in i["lat_step_ms"][1:]]))
        log(f"multicard {backend}: lat {i0['lat_mesh']} across {MC_NPROC} "
            f"ranks (overlap impl, CUDA IPC), {TRAIN_CHECK_STEPS} steps at "
            f"B={TRAIN_B} against one process unsharded on the card: {errs};"
            f" parameters and first gradient bit-equal across ranks; "
            f"launches a rank {i0['lat_launches']}; a step {step:.2f} ms "
            "(host clock, median)")
        if not (errs["loss_rel"] <= TOL_TRAIN["loss"]
                and errs["grad_rel_rms_unforced"] <= TOL_TRAIN["grad"]
                and errs["params_rel_rms"] <= TOL_TRAIN["params"]):
            raise AssertionError(f"multicard {backend} lat training: {errs}")
        out.update(
            halo=[i["ipc_halo"] for i, _ in ranks],
            overlap=[i["ipc_overlap"] for i, _ in ranks],
            train_vs_one_process=errs, step_ms=step,
            launches_by_rank=[i["lat_launches"] for i, _ in ranks])
    for info, _ in ranks:
        sp, lon = info["lat_spectral"], info["lon_ring"]
        log(f"multicard {backend} rank {info['rank']}: spectral core with "
            f"lat across ranks (bands {sp['mine']}), Gaussian "
            f"{SHARD_GRID[0]}x{SHARD_GRID[1]} T{SHARD_GRID[2]}: max err / "
            "scale " + ", ".join(f"{k} {v:.2e}" for k, v in
                                 sp["errors"].items())
            + f" (limit {TOL_SHARD}); {SHARD_STEPS} barotropic steps "
            f"relative RMS {sp['barotropic_rel_rms']:.2e} (limit "
            f"{TOL_SHARD_BARO}); lon ring {lon['mesh']} across ranks vs "
            f"cyclic_conv2d max abs {lon['max_abs_vs_cyclic_conv2d']:.3e}")
        if not (max(sp["errors"].values()) <= TOL_SHARD
                and sp["barotropic_rel_rms"] <= TOL_SHARD_BARO
                and lon["max_abs_vs_cyclic_conv2d"] <= TOL_F32):
            raise AssertionError(f"{backend} rank {info['rank']}: {sp} {lon}")
    out["spectral"] = [i["lat_spectral"] for i, _ in ranks]
    out["lon_ring"] = [i["lon_ring"] for i, _ in ranks]
    return out


def cross_card(torch):
    """Phase (a) on cuda:0 and cuda:1: the lat-band kernels on shards of
    the two cards against their plain versions, the lat=2 sharded
    forecast (B=64, STEPS steps, overlap convs) against the one-card run,
    and a lat=2 train step against the one-card lat=2 step."""
    from dlwp_torch import TimeSeriesEstimator, flax_tree
    from dlwp_torch.kernels import (
        halo_exchange, halo_exchange_plain, launch_counts, overlap_conv,
        overlap_conv_db, overlap_conv_plain, reset_launch_counts,
    )
    from dlwp_torch.parallel import MeshConfig, build_mesh
    from dlwp_torch.parallel.mesh import split_shards

    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    out = {"peer_access": bool(torch.cuda.can_device_access_peer(0, 1))}
    two = build_mesh(MeshConfig(data=1, lat=2), devices=[c0, c1])
    g = torch.Generator(device=c0).manual_seed(6)
    for name, shape, o in OVERLAP_CONVS:
        x = torch.randn(shape, device=c0, generator=g)
        k = torch.randn(o, shape[1], 3, 3, device=c0,
                        generator=g) / (9 * shape[1]) ** 0.5
        shards = split_shards(x, two, "data", "lat")
        same = all_equal(halo_exchange(shards, (1, 1)),
                         halo_exchange_plain(shards, (1, 1)))
        want = overlap_conv_plain(shards, k)
        errs = [max_err(overlap_conv(shards, k), want),
                max_err(overlap_conv_db(shards, k, 4), want)]
        torch.cuda.synchronize()
        log(f"multicard cross-card {name} {shape}: halo bit-equal {same}, "
            f"overlap_conv / _db max|kernel-plain| {errs}")
        if not same or max(errs) > TOL_F32:
            raise AssertionError(f"cross-card {name}: {same}, {errs}")
        out[name] = {"halo_bit_equal": same, "overlap_max_abs": errs}
    card, sampler = flagship_stack(c0)
    card.init(sampler.generate(np.arange(1))[0], seed=0)
    sharded, sh_sampler = flagship_stack(c0, mesh=two)
    sharded.base_model.share_params_from(card.base_model)
    reset_launch_counts()
    fc = TimeSeriesEstimator(sharded, sh_sampler).predict(
        STEPS, samples=np.arange(B))
    torch.cuda.synchronize()
    out["forecast_launches"] = launch_counts()
    want = TimeSeriesEstimator(card, sampler).predict(
        STEPS, samples=np.arange(B)).values
    step1 = float(np.abs(fc.values[:TD] - want[:TD]).max())
    rrms = float(np.sqrt(np.mean((fc.values - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))
    log(f"multicard cross-card forecast predict({STEPS}) B={B} on "
        f"[cuda:0, cuda:1]: launches {out['forecast_launches']}; vs one "
        f"card step-1 {step1:.3e}, relative RMS {rrms:.3e}")
    if not (step1 <= TOL_STEP1["fp32"] and rrms <= TOL_TRAJ_RRMS["fp32"]):
        raise AssertionError(f"cross-card forecast: {step1}, {rrms}")
    out["forecast_vs_one_card"] = {"step1_max_abs": step1, "rel_rms": rrms}
    net1, train, _ = train_stack(c0, mesh=virtual_mesh(c0, 1, 2))
    net2, _, _ = train_stack(c0, mesh=two)
    net2.load_flax_params(flax_tree(net1.base_model))
    batches = [train[i] for i in range(TRAIN_CHECK_STEPS)]
    errs = train_errors(step_run(torch, net2, batches),
                        step_run(torch, net1, batches))
    log(f"multicard cross-card train lat=2 on [cuda:0, cuda:1] vs one card: "
        f"{errs}")
    if not (errs["loss_rel"] <= TOL_TRAIN["loss"]
            and errs["params_rel_rms"] <= TOL_TRAIN["params"]):
        raise AssertionError(f"cross-card train: {errs}")
    out["train_vs_one_card"] = errs
    return out


def run_multicard(torch, dev):
    """Phase 24 (``--only multicard``): (a) across two cards of one
    process where there are two, else a line that says it was not run;
    (b) ranks over processes, gloo on cuda:0 and, with two cards, NCCL."""
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    out = {"cards": n_cards}
    if n_cards >= 2:
        out["cross_card"] = cross_card(torch)
    else:
        out["cross_card"] = "not run: one CUDA device"
        log("multicard (a) not run: this machine has 1 CUDA device; the "
            "cross-card launch (peer access) needs 2 or more")
    card, train, _ = train_stack(dev)
    batches = [train[i] for i in range(TRAIN_CHECK_STEPS)]
    ref = step_run(torch, card, batches)
    # Each rank's launches over its steps: one forward's dispatch a step
    # of its block of the batch on its lat=2 mesh.
    cpu, _, _ = train_stack("cpu", mesh=virtual_mesh(torch.device("cpu"), 1,
                                                     2))
    need = {k: TRAIN_CHECK_STEPS * v for k, v in dispatch_launches(
        torch, cpu, TRAIN_B // MC_NPROC).items()}
    # With lat across the ranks, each rank's launches over its steps: one
    # forward's dispatch of the whole batch on a lat=2 mesh (a launch
    # covers the rank's one band where the mesh's covers both).
    need_lat = {k: TRAIN_CHECK_STEPS * v for k, v in dispatch_launches(
        torch, cpu, TRAIN_B).items()}
    xd, yd = (card.trainer._to_device(a) for a in batches[0])
    single_ms = timed_ms(lambda: card.trainer.train_step(xd, yd), reps=3,
                         inner=MC_TIME_STEPS, warmup=1)
    here = f"cuda:{torch.cuda.current_device()}"
    out["gloo"] = check_ranks(
        torch, "gloo", spawn_ranks(torch, "gloo", [here] * MC_NPROC),
        ref, single_ms, need, need_lat)
    if n_cards >= 2:
        out["nccl"] = check_ranks(
            torch, "nccl", spawn_ranks(
                torch, "nccl", [f"cuda:{i}" for i in range(MC_NPROC)]),
            ref, single_ms, need, need_lat)
    else:
        out["nccl"] = "not run: one CUDA device"
        log("multicard (b) NCCL not run: NCCL needs a card a rank and this "
            "machine has 1 CUDA device")
    out["nccl_two_ranks_one_card"] = probe_nccl_shared_card(torch)
    out["torchrun"] = run_torchrun(torch, n_cards)
    out["launches"] = {
        k: sum(r[k] for r in out["gloo"]["launches_by_rank"])
        for k in out["gloo"]["launches_by_rank"][0]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"multicard: {out['seconds']:.1f} s")
    return out



# ---------------------------------------------------------------------------
# The example workflows (dlwp_torch.examples), driven through main(argv) on
# the card as a user runs them. train_convlstm at the script's default
# widths (lstm_features 4*C) on its synthetic demo data (600 samples,
# 37x72 cropped to 36x72) at B=32, the last 25% held out, a
# latitude-weighted MSE; validate with its defaults (20% held out, 12
# forecast steps, the psi-form baseline at T34) on the card and on the
# CPU; run_barotropic and make_barotropic_archive through the fused step.
EX_N, EX_B, EX_FRACTION, EX_FORECAST = 600, 32, 0.25, 12
EX_TRAIN = ["--batch-size", str(EX_B), "--validation-fraction",
            str(EX_FRACTION), "--loss", "lat_mse"]
EX_ARCHIVE = ["--years", "0.01"]  # 14 rows, one segment: a single member
# validate's forecast row, card vs CPU (the same saved weights), relative.
TOL_EX_FORECAST = 1e-4


def example_call(torch, label, fn):
    """``fn()`` with its printed lines captured and logged: (result,
    printed text, seconds, launch counts set to 0 just before and read
    just after)."""
    import contextlib
    import io

    from dlwp_torch.kernels import launch_counts, reset_launch_counts

    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    for line in buf.getvalue().strip().splitlines():
        log(f"  {label} | {line}")
    log(f"examples: {label}: {seconds:.2f} s, launches {counts}")
    return result, buf.getvalue(), seconds, counts


def example_module(name):
    import importlib

    return importlib.import_module(f"dlwp_torch.examples.{name}")


def refuses_without_h5py(fn, what):
    """Where h5py is missing (the card's host has none), ``fn()`` must
    raise naming it; returns the message."""
    try:
        fn()
    except (ImportError, RuntimeError) as e:
        if "h5py" not in str(e):
            raise
        log(f"examples: {what} raises without h5py: {e}")
        return str(e)
    raise AssertionError(f"{what} wrote a file without h5py")


def example_batches(n=EX_N, fraction=EX_FRACTION, b=EX_B):
    """train_convlstm's train and validation batches an epoch: windows of
    TD in and TD out steps (N - 2 TD + 1 a series), B a batch."""
    n_val = int(n * fraction)
    windows = [n - n_val - 2 * TD + 1, n_val - 2 * TD + 1]
    return [-(-w // b) for w in windows]


def examples_train_convlstm(torch, run, tmp):
    """(a): 2 epochs with a checkpoint each, then --resume to 3. Each run
    builds its model afresh: one forward at init (a conv-pool stage, TD -
    1 gate launches), then the gates in every train step and both kernels
    in every validation batch."""
    model = os.path.join(tmp, "convlstm")
    common = EX_TRAIN + ["--checkpoint-dir", os.path.join(tmp, "ck"),
                         "--model-file", model, "--device", "cuda"]
    n_train, n_val = example_batches()
    out = {}
    for epochs, extra in ((2, []), (3, ["--resume"])):
        (net, hist), text, _, counts = run(
            f"train_convlstm --epochs {epochs} {' '.join(extra)}".strip(),
            "train_convlstm", ["--epochs", str(epochs)] + extra + common)
        ran = len(hist.epoch)
        need = fit_launches(ran, n_train, n_val, S=1, pools=1, convs=3)
        need["fused_conv_pool"] += 1
        need["cyclic_conv"] += 3
        need["lstm_gates"] += TD - 1
        losses = hist.history["loss"] + hist.history["val_loss"]
        out[f"epochs_{epochs}"] = {"epochs_run": hist.epoch,
                                   "history": hist.history,
                                   "launches": counts, "expected": need}
        if counts != need:
            raise AssertionError(f"train_convlstm launches {counts} != {need}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"train_convlstm losses {hist.history}")
    if "resumed from epoch 2" not in text or hist.epoch != [2]:
        raise AssertionError(f"train_convlstm did not resume: {text}")
    if not os.path.exists(model + ".params"):
        raise AssertionError("train_convlstm wrote no model file")
    log(f"examples: train_convlstm at B={EX_B}: {n_train} train and {n_val} "
        f"validation batches an epoch; resumed from epoch 2 to 3; losses "
        f"finite")
    return model, out


def examples_validate(torch, run, tmp, model):
    """(b): validate on the card and with --device cpu on the same file:
    the forecast row within TOL_EX_FORECAST, persistence and climatology
    equal, the barotropic row within TOL_BARO_RRMS."""
    argv = ["--model-file", model, "--forecast-steps", str(EX_FORECAST),
            "--plot-file", os.path.join(tmp, "v.png"),
            "--output-file", os.path.join(tmp, "v.pkl")]
    rows, text, _, counts = run("validate", "validate", argv + ["--device",
                                                                "cuda"])
    cpu, _, _, _ = run("validate --device cpu", "validate",
                       argv + ["--device", "cpu"], card=False)
    iters = EX_FORECAST // TD
    need = expected_counts(fused_conv_pool=iters, lstm_gates=iters * (TD - 1),
                           cyclic_conv=3 * iters)

    def rel(key):
        return float(np.max(np.abs(rows[key] - cpu[key]) / np.abs(cpu[key])))

    out = {"launches": counts, "f_hour": np.asarray(rows["f_hour"]).tolist(),
           "forecast_rel": rel("forecast_rmse"),
           "barotropic_rel": rel("barotropic_rmse"),
           "baselines_equal": all(np.array_equal(rows[k], cpu[k]) for k in
                                  ("persistence_rmse", "climatology_rmse")),
           "rows": {k: np.asarray(v).tolist() for k, v in rows.items()}}
    log(f"examples: validate card vs CPU: forecast row {out['forecast_rel']:.3e}"
        f" (limit {TOL_EX_FORECAST}), barotropic row "
        f"{out['barotropic_rel']:.3e} (limit {TOL_BARO_RRMS}), persistence "
        f"and climatology equal {out['baselines_equal']}")
    for line in ("auto: cropping the 90N row", "insolation channel",
                 "RMSE vs forecast hour"):
        if line not in text:
            raise AssertionError(f"validate did not print {line!r}")
    if counts != need:
        raise AssertionError(f"validate launches {counts} != {need}")
    if not (all(np.isfinite(v).all() for v in rows.values())
            and out["forecast_rel"] <= TOL_EX_FORECAST
            and out["barotropic_rel"] <= TOL_BARO_RRMS
            and out["baselines_equal"]):
        raise AssertionError(f"validate card vs CPU: {out}")
    return out


def examples_barotropic(torch, run, tmp, have_h5py):
    """(c): run_barotropic --n-init 1 --step-impl kernel against --device
    cpu --step-impl plain, and make_barotropic_archive through the fused
    step (one segment) against the CPU's plain engine; where h5py is
    missing, main raises naming it and the compute functions run."""
    rb = example_module("run_barotropic")
    card_argv = ["--n-init", "1", "--step-impl", "kernel", "--device", "cuda",
                 "--output-file", os.path.join(tmp, "b.h5")]
    cpu_argv = ["--n-init", "1", "--step-impl", "plain", "--device", "cpu"]
    out = {}
    if have_h5py:
        import h5py

        run("run_barotropic", "run_barotropic", card_argv)
        with h5py.File(os.path.join(tmp, "b.h5")) as f:
            z = f["z"][:]
    else:
        out["run_barotropic_refusal"] = refuses_without_h5py(
            lambda: rb.main(card_argv), "run_barotropic main")
    (_, z_card, *_), _, _, counts = run(
        "run_barotropic integrate (kernel)", "run_barotropic",
        lambda: rb.integrate(rb.parse_args(card_argv)))
    if have_h5py:
        z_card = z
    (_, z_cpu, *_), *_ = run("run_barotropic integrate --device cpu",
                             "run_barotropic",
                             lambda: rb.integrate(rb.parse_args(cpu_argv)),
                             card=False)
    snaps = z_card.shape[0]
    out["run_barotropic"] = {
        "shape": list(z_card.shape), "launches": counts,
        "final_rel_rms": rel_rms(torch.from_numpy(z_card[-1]),
                                 torch.from_numpy(z_cpu[-1]))}
    log(f"examples: run_barotropic --step-impl kernel, {snaps} snapshots: "
        f"final heights vs the CPU's plain engine relative RMS "
        f"{out['run_barotropic']['final_rel_rms']:.3e} (limit "
        f"{TOL_BARO_RRMS})")
    if counts != expected_counts(barotropic_step=snaps):
        raise AssertionError(f"run_barotropic launches {counts}")
    if not (np.isfinite(z_card).all()
            and out["run_barotropic"]["final_rel_rms"] <= TOL_BARO_RRMS):
        raise AssertionError(f"run_barotropic vs CPU: {out}")

    ma = example_module("make_barotropic_archive")
    card = ma.parse_args(EX_ARCHIVE + ["--step-impl", "kernel", "--device",
                                       "cuda", "--output-file",
                                       os.path.join(tmp, "a.h5")])
    cpu = ma.parse_args(EX_ARCHIVE + ["--device", "cpu"])
    if not have_h5py:
        out["archive_refusal"] = refuses_without_h5py(
            lambda: ma.main(EX_ARCHIVE + ["--device", "cuda",
                                          "--output-file",
                                          os.path.join(tmp, "a.h5")]),
            "make_barotropic_archive main")
    ds, _, _, counts = run(
        "make_barotropic_archive (kernel, one segment)",
        "make_barotropic_archive",
        lambda: ma.write_archive(card, ma.archive_source(card), None))
    ref, *_ = run("make_barotropic_archive --device cpu",
                  "make_barotropic_archive",
                  lambda: ma.write_archive(cpu, ma.archive_source(cpu), None),
                  card=False)
    got, want = np.asarray(ds.predictors), np.asarray(ref.predictors)
    nan = np.isnan(want)
    ok = want[~nan]
    out["archive"] = {
        "dims": ds.dims, "launches": counts,
        "same_nan": bool((np.isnan(got) == nan).all()),
        "rel_rms": float(np.sqrt(np.mean((got[~nan] - ok) ** 2))
                         / np.sqrt(np.mean((ok - ok.mean()) ** 2)))}
    log(f"examples: make_barotropic_archive {ds.dims} through the kernel vs "
        f"the CPU: relative RMS {out['archive']['rel_rms']:.3e} (limit "
        f"{TOL_ARCHIVE_RRMS})")
    if not (counts["barotropic_step"] > 0 and out["archive"]["same_nan"]
            and out["archive"]["rel_rms"] <= TOL_ARCHIVE_RRMS):
        raise AssertionError(f"make_barotropic_archive: {out['archive']}")
    return out


def examples_files(tmp, have_h5py):
    """write_predictors and add_thickness: the files where h5py imports,
    else main raises naming it and the compute functions run on the
    synthetic series."""
    wp, at = example_module("write_predictors"), example_module(
        "add_thickness")
    path = os.path.join(tmp, "p.h5")
    if have_h5py:
        wp.main(["--output-file", path])
        at.main([path, "--upper", "HGT/500", "--lower", "THICK/300-700"])
        return {"written": path}
    out = {"write_predictors_refusal": refuses_without_h5py(
        lambda: wp.main(["--output-file", path]), "write_predictors main"),
        "add_thickness_refusal": refuses_without_h5py(
            lambda: at.main([path]), "add_thickness main")}
    _, ds = wp.build(wp.parse_args([]))
    want = example_module("_synthetic").synthetic_predictor_file()
    name, mean, std = at.add_thickness(ds, "HGT/500", "THICK/300-700")
    out.update(series_equal=bool(np.array_equal(ds.predictors[:, :2],
                                                want.predictors)),
               thickness=[name, mean, std])
    if not (out["series_equal"] and ds.varlev[-1] == name
            and np.isfinite(ds.predictors).all()):
        raise AssertionError(f"write_predictors / add_thickness: {out}")
    return out


def examples_training(torch, run, tmp):
    """(d): train, train_functional and train_spherical for an epoch,
    each reloaded through load_model to predict bit-equal to the model in
    memory; train_distributed on a (data 2, lat 2) mesh of 4 entries of
    the card, its parameters saved and reloaded bit-equal and the
    reloaded (unsharded) model's prediction within TOL_STEP1 of the
    sharded one's."""
    from dlwp_torch import load_model, save_model

    out = {}
    for name in ("train", "train_functional", "train_spherical",
                 "train_distributed"):
        path = os.path.join(tmp, name)
        argv = ["--epochs", "1", "--device", "cuda"] + (
            ["--virtual", "4", "--data-shards", "2", "--lat-shards", "2"]
            if name == "train_distributed" else ["--model-file", path])
        (net, hist), text, _, counts = run(name, name, argv)
        if name == "train_distributed":
            save_model(net, path)
        back = load_model(path, device="cuda")
        x = np.random.RandomState(0).randn(
            8, *net.input_sample_shape).astype(np.float32)
        got, want = back.predict(x), net.predict(x)
        params_equal = state_equal(back.base_model.state_dict(),
                                   net.base_model.state_dict())
        row = {"loss": hist.history["loss"], "launches": counts,
               "params_equal": params_equal,
               "predict_max_abs": float(np.max(np.abs(got - want)))}
        out[name] = row
        log(f"examples: {name}: loss {row['loss']}, reloaded parameters "
            f"bit-equal {params_equal}, predict max abs vs in memory "
            f"{row['predict_max_abs']:.3e}")
        limit = TOL_STEP1["fp32"] if name == "train_distributed" else 0.0
        if not (np.isfinite(row["loss"]).all() and params_equal
                and row["predict_max_abs"] <= limit):
            raise AssertionError(f"{name}: {row}")
        if name == "train_distributed" and "mesh: {'data': 2, 'lat': 2}" \
                not in text:
            raise AssertionError(f"train_distributed: {text}")
    return out


def examples_plots(torch, run, tmp):
    """(e): the plot scripts where matplotlib imports."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        log(f"examples: plot_forecasts, plot_movie and plot_ensemble not run:"
            f" {e}")
        return {"skipped": str(e)}
    out = {}
    for name, argv, files in (
            ("plot_forecasts", ["--out-prefix", os.path.join(tmp, "f")],
             ("f_panels.png", "f_laplacian.png")),
            ("plot_movie", ["--output-file", os.path.join(tmp, "m.gif")],
             ("m.gif",)),
            ("plot_ensemble", ["--plot-file", os.path.join(tmp, "e.png")],
             ("e.png",))):
        _, _, _, counts = run(name, name, argv + ["--steps", "2",
                                                  "--device", "cuda"])
        out[name] = counts
        if not all(os.path.getsize(os.path.join(tmp, f)) for f in files):
            raise AssertionError(f"{name} wrote no figure")
    return out


def run_examples(torch, dev):
    """``--only examples``: dlwp_torch.examples through main(argv) on the
    card, (a)-(e); each script's seconds and the phase's launches (card
    runs only)."""
    import tempfile

    from dlwp_torch.kernels import WRAPPERS

    torch.set_num_threads(os.cpu_count() or 1)
    t_phase = time.perf_counter()
    launches = {name: 0 for name in WRAPPERS}
    seconds = {}

    def run(label, name, what, card=True):
        """``what``: argv for the module's main, or a callable."""
        fn = what if callable(what) else (
            lambda: example_module(name).main(what))
        result, text, sec, counts = example_call(torch, label, fn)
        seconds[label] = sec
        if card:
            for k in counts:
                launches[k] += counts[k]
        return result, text, sec, counts

    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
    out = {"h5py": have_h5py}
    with tempfile.TemporaryDirectory() as tmp:
        model, out["train_convlstm"] = examples_train_convlstm(torch, run,
                                                               tmp)
        out["validate"] = examples_validate(torch, run, tmp, model)
        out["barotropic"] = examples_barotropic(torch, run, tmp, have_h5py)
        out["files"] = examples_files(tmp, have_h5py)
        out["training"] = examples_training(torch, run, tmp)
        out["plots"] = examples_plots(torch, run, tmp)
    for name in ("lstm_gates", "fused_conv_pool", "barotropic_step"):
        if not launches[name]:
            raise AssertionError(f"examples: {name} never launched")
    out.update(launches=launches, script_seconds=seconds,
               seconds=time.perf_counter() - t_phase)
    log(f"examples: {out['seconds']:.1f} s; launches {launches}")
    return out



# Phases that run alone with --only, to iterate on one part on the card:
# name -> (function of (torch, dev)).
ONLY = {
    "kernels": check_kernels,
    "cube_pad": check_cube_pad,
    "cyclic_conv": check_cyclic_conv,
    "parallel_kernels": check_parallel_kernels,
    "sharded": run_sharded_path,
    "routing": check_routing,
    "train": run_train_phase,
    "barotropic_kernel": check_barotropic_kernel,
    "barotropic_timing": time_barotropic,
    "device_train": run_device_train,
    "layers": check_layers,
    "skip_tower": run_skip_tower,
    "verify": run_verify,
    "fold": run_fold,
    "spherical": run_spherical,
    "sharded_spectral": run_sharded_spectral,
    "paper_run": run_paper_run,
    "serve": run_serve,
    "host_data": run_host_data,
    "sharded_train": run_sharded_train,
    "multicard": run_multicard,
    "examples": run_examples,
}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--only", default="",
        help="comma-separated phases to run alone, without the result lines "
             f"({', '.join(ONLY)}); default: every phase")
    parser.add_argument(
        "--paper-years", type=float, default=PAPER["years"],
        help="the paper run's archive length (docs/DEPLOY.md: 4)")
    parser.add_argument(
        "--paper-epochs", type=int, default=PAPER["epochs"],
        help="the paper run's epochs (docs/DEPLOY.md: 50)")
    args = parser.parse_args(argv)
    PAPER.update(years=args.paper_years, epochs=args.paper_epochs)
    only = [p for p in args.only.split(",") if p]
    unknown = sorted(set(only) - set(ONLY))
    if unknown:
        parser.error(f"unknown phases {unknown}")
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
    log(f"kernel build: {_build.build():.1f} s for "
        f"{_build.sources() + _build.host_sources()}")
    for name in _build.sources():
        spills, entry = [], ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "registers" in line or "spill" in line:
                log(f"  {name} {entry[:48]}: {line.strip()}")
            if "spill" in line and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads"):
                spills.append(f"{entry}: {line.strip()}")
        log(f"  {name}: spills {spills or 'none'}")
    if only:
        for name in only:
            log(json.dumps({name: ONLY[name](torch, dev)}, default=str))
        return 0

    errs, timing = check_kernels(torch, dev)
    cube = check_cube_pad(torch, dev)
    cyclic = check_cyclic_conv(torch, dev)
    errs.update(check_parallel_kernels(torch, dev))
    check_golden(torch, dev, root)
    main_launches, rollout = run_main_path(torch, dev)
    routing = check_routing(torch, dev)
    train = run_train_phase(torch, dev)
    sharded_launches, per_step, sharded = run_sharded_path(torch, dev)
    par_timing = time_parallel_kernels(torch, dev)
    baro_err = check_barotropic_kernel(torch, dev)
    baro_launches, baro_path = run_barotropic_path(torch, dev)
    example = run_example_flow(torch, dev)
    baro_timing = time_barotropic(torch, dev)
    device_train = run_device_train(torch, dev)
    layers = check_layers(torch, dev)
    skip_tower = run_skip_tower(torch, dev)
    verify = run_verify(torch, dev)
    fold = run_fold(torch, dev)
    spherical = run_spherical(torch, dev)
    sharded_spectral = run_sharded_spectral(torch, dev)
    paper_run = run_paper_run(torch, dev)
    serve = run_serve(torch, dev)
    host_data = run_host_data(torch, dev)
    sharded_train = run_sharded_train(torch, dev)
    multicard = run_multicard(torch, dev)
    examples = run_examples(torch, dev)
    # Each later path's launches, counted from 0 around its run: fit_device
    # at S=1 (train steps and validation), the SkipTower forecast, the
    # verified forecast, the spherical stack's forward and train steps,
    # the fold and sharded spectral phases (no model: none), and the paper
    # run's fit_device and validation, one call of the forecast servable
    # exported on the CPU, one fit_generator epoch through the native
    # batch gather, the 3 train steps on each mesh of the sharded
    # training phase, and the multicard phase's 3 train steps in each
    # gloo rank (summed over the ranks).
    later = {"launches_device_train": device_train["S1"]["launches"],
             "launches_skip_tower": skip_tower["launches"],
             "launches_verify": verify["launches"],
             "launches_spherical": spherical["launches"],
             "launches_fold": fold["launches"],
             "launches_sharded_spectral": sharded_spectral["launches"],
             "launches_paper_run": paper_run["launches"],
             "launches_serve": serve["launches"],
             "launches_host_data": host_data["launches"],
             "launches_sharded_train": sharded_train["launches"],
             "launches_multicard": multicard["launches"],
             "launches_examples": examples["launches"]}

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
            extra = ""
            if name == "fused_conv_pool":
                # The kernel's own arithmetic: three TF32 tensor-core
                # products per multiply-add. bound_fp32_ms: fp32 FMA.
                r["bound_fp32_ms"] = r["bound_ms"]
                r["bound_ms"], r["bound_by"] = bound_ms(
                    r["bytes"], 3 * r["flops"], PEAK_TF32_FLOPS)
                p = r["plan"]
                extra = (
                    f"; device {r['device_ms']:.4f} ms: "
                    f"{100 * r['bound_ms'] / r['device_ms']:.1f}% of the "
                    f"3xTF32 bound, {100 * r['bound_fp32_ms'] / r['device_ms']:.1f}"
                    f"% of the fp32 bound {r['bound_fp32_ms']:.4f} ms; "
                    f"{r['library_note']} {r['library_ms']:.4f} ms (device "
                    f"{r['library_device_ms']:.4f}), kernel/cuDNN device "
                    f"{r['device_ms'] / r['library_device_ms']:.2f}x; warp "
                    f"{p['mo']}x1 x {p['ncg']} column tiles x {p['n_cb']} "
                    f"column blocks, tile {p['bb']}x{p['rb']}, "
                    f"{p['warps']} warps, {p['stages']} stages "
                    f"({p['smem']} B), {p['tiles']} tiles, grid {r['grid']}; "
                    f"the same plan with {r['other_ring']['stages']} stages "
                    f"({r['other_ring']['smem']} B): device "
                    f"{r['other_ring']['device_ms']:.4f} ms")
            log(f"timing {name} {r['shape']} gate_dtype="
                f"{r.get('gate_dtype')}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}){extra}")
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[name],
            # The training path's launches: fit_generator's first 2
            # epochs (train steps, then validation under no_grad).
            "launches_train": train["fit_launches"][name],
            "max_abs_err": errs[name],
            "ms": float(np.mean([r["ms"] for r in rows])),
            "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
            "bound_ms": float(np.mean([r["bound_ms"] for r in rows])),
            "bound_by": rows[0]["bound_by"],
            "library_ms": None,
            "per_shape": timing[name],
            **{k: v[name] for k, v in later.items()},
        }
        if name == "fused_conv_pool":
            # Mean per launch of the two stages, one launch each a step.
            for key in ("library_ms", "bound_fp32_ms", "device_ms",
                        "library_device_ms"):
                entry[key] = float(np.mean([r[key] for r in rows]))
            entry["library_note"] = rows[0]["library_note"]
            entry["device_ms_per_launch_on_path"] = (
                rollout["fp32"]["conv_pool_device_ms_per_launch"])
        kernels.append(entry)
    rows = list(baro_timing.values())
    kernels.append({
        "name": "barotropic_step", "route": "cuda",
        "source": "dlwp_torch/csrc/barotropic_step.cu",
        "replaces": "dlwp_tpu/barotropic/pallas_step.py:123",
        "launches": sum(baro_launches.values()),
        "launches_train": train["fit_launches"]["barotropic_step"],
        "max_abs_err": baro_err,
        # Per integration step at T72 on 73x144, mean of the two forms.
        "ms": float(np.mean([r["ms"] for r in rows])),
        "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
        "bound_ms": float(np.mean([r["bound_ms"] for r in rows])),
        "bound_by": rows[0]["bound_by"],
        "library_ms": None,
        "unit": "per step",
        "launches_by_form": baro_launches,
        "per_form": baro_timing,
        **{k: v["barotropic_step"] for k, v in later.items()},
    })
    for name, replaces, run in (
        ("halo_exchange", "dlwp_tpu/parallel/pallas_halo.py:33", "B64"),
        ("overlap_conv", "dlwp_tpu/parallel/pallas_overlap.py:77", "B8"),
        ("overlap_conv_db", "dlwp_tpu/parallel/pallas_overlap.py:163", "B64"),
    ):
        # Mean per launch over the launches of one step of the sharded
        # path's run that takes the kernel (B=64, or B=8 for overlap_conv).
        rows = par_timing[name]
        source = ("dlwp_torch/csrc/halo_exchange.cu" if name == "halo_exchange"
                  else "dlwp_torch/csrc/overlap_conv.cu")
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sharded_launches[run][name],
            "launches_train": train["fit_launches"][name],
            "max_abs_err": errs[name],
            "ms": float(np.mean([r["ms"] for r in rows])),
            "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
            "bound_ms": float(np.mean([r["bound_ms"] for r in rows])),
            "bound_by": rows[0]["bound_by"],
            "library_ms": None,
            "launches_run": f"sharded predict at B={run[1:]}",
            "per_launch": rows,
            **{k: v[name] for k, v in later.items()},
        }
        profiled = {"halo_exchange": "halo_kernel",
                    "overlap_conv_db": "overlap_db_kernel"}.get(name)
        if profiled:
            entry["device_ms_per_launch_on_path"] = (
                sharded["device_ms_per_launch"][profiled])
        if name == "halo_exchange":
            entry["library_note"] = ("no single PyTorch call builds the "
                                     "padded shards")
        else:
            # bound_ms: 3 TF32 tensor-core products per multiply-add, the
            # kernel's arithmetic; bound_fp32_ms: the fp32 FMA bound.
            # device_ms: profiler kernel time, without the wrapper's host
            # work that short calls' event times include.
            for key in ("library_ms", "bound_fp32_ms", "device_ms",
                        "library_device_ms"):
                entry[key] = float(np.mean([r[key] for r in rows]))
        kernels.append(entry)
    # Per U-Net step at B=64 (10 launches), bit-equal to the plain gather.
    kernels.append({
        "name": "cube_pad", "route": "cuda",
        "source": "dlwp_torch/csrc/cube_pad.cu", "replaces": None,
        "launches": cube["launches_forecast"],
        "launches_run": f"cube forecast of {cube['forecast_steps']} steps "
                        f"at B={B}",
        "launches_train": train["fit_launches"]["cube_pad"],
        "max_abs_err": 0.0,
        **{k: cube["step"][k] for k in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "library_ms",
                                        "library_device_ms")},
        "bound_by": "bytes", "unit": "per U-Net step",
        "library_note": "index_select of the pad table alone, on faces "
                        "flattened outside the timer",
        "device_ms_per_launch_on_path": cube["device_ms_per_launch_on_path"],
        "per_shape": cube["rows"],
        **{k: v["cube_pad"] for k, v in later.items()},
    })
    # Per tower step at B=64 (4 launches), against cuDNN and its passes.
    kernels.append({
        "name": "cyclic_conv", "route": "cuda",
        "source": "dlwp_torch/csrc/cyclic_conv.cu", "replaces": None,
        "launches": main_launches["cyclic_conv"],
        "launches_run": f"predict({STEPS}) at B={B}",
        "launches_train": train["fit_launches"]["cyclic_conv"],
        "max_abs_err": max(r["max_abs_err"] for r in cyclic["rows"]),
        **{k: cyclic["steps"][B][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
            "library_device_ms")},
        "bound_by": "operations", "unit": "per tower step (4 launches)",
        "library_note": "cuDNN's F.conv2d alone on inputs padded (and "
                        "kernels folded) outside the timer",
        "per_shape": cyclic["rows"],
        **{k: v["cyclic_conv"] for k, v in later.items()},
    })
    log(json.dumps({"rollout": rollout, "routing": routing, "train": train,
                    "sharded_path": sharded,
                    "sharded_launches": sharded_launches,
                    "launches_per_step": per_step,
                    "barotropic_path": baro_path,
                    "barotropic_example": example,
                    "device_train": device_train, "layers": layers,
                    "skip_tower": skip_tower, "verify": verify,
                    "fold": fold, "spherical": spherical,
                    "sharded_spectral": sharded_spectral,
                    "paper_run": paper_run, "serve": serve,
                    "host_data": host_data, "sharded_train": sharded_train,
                    "multicard": multicard, "examples": examples,
                    "card": card}, default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

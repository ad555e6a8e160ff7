"""Data-parallel training across cards: one process a card (a rank), NCCL
between them (gloo on the CPU), each running the training job of
:mod:`h100bench.drivers.train` (``fit_device`` epochs with their
validation pass) on a ``multihost_mesh`` whose ``data`` axis spans the
ranks. Every rank samples the same global batches from the same seeded
series on its own card, steps on its own block of each, and the trainer
averages the gradients with one ``all_reduce`` before the optimizer step.

Traffic keys: those of the train driver (``batch`` is the global batch,
split evenly over the ranks), ``ranks``, and ``timeout_s``: the process
group's timeout, so a rank that fails or is lost ends the run instead of
hanging it.

This process is rank 0, on ``run.device``; it starts the other ranks
(``cuda:<rank>``, or the CPU) as spawned processes and waits for them at
the end. Rank 0 decides when the window ends, after whole epochs, and
tells the others over a host-side group, so every rank runs the same
steps. What the run reports is rank 0's: the card's busy time a train
step over the ``--trace 0`` window (the collectives' device time
included), the per-layer metrics of its traced epochs, and the check of
its first three steps against the reference at the global batch.
"""

from __future__ import annotations

import dataclasses
import socket
import sys
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from h100bench import counts, harness, inputs, specs, tracing
from h100bench.drivers.train import Spy, gaps, reference_batches, splice
from h100bench.reference import load as load_reference


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def build(run: harness.Run, weights: dict, host_series: np.ndarray,
          sampler_seed: int, mesh):
    """The program's data-parallel training path: (net, train sampler,
    validation sampler), the samplers device-resident with the global
    batch, the model on ``mesh`` with the data axis over the batch."""
    from dlwp_torch.data import (DeviceSeriesSampler, PredictorDataset,
                                 SeriesSampler)
    from dlwp_torch.models import DLWPNeuralNet
    from dlwp_torch.ops.losses import latitude_weighted_loss, mse
    from dlwp_torch.train import chain, clip_by_global_norm, cosine_decay_schedule
    from dlwp_torch.train.optim import adam

    cfg, t = run.cfg, run.traffic
    g = specs.grid(cfg)
    T = cfg["input_time_steps"]
    n = host_series.shape[0]
    n_val = int(n * t["validation_fraction"])
    lat = np.asarray(g.lat())
    ds = PredictorDataset(predictors=host_series,
                          sample=inputs.series_times(n),
                          varlev=list(cfg["channels"]), lat=lat,
                          lon=np.asarray(g.lon()))
    net = DLWPNeuralNet(is_convolutional=True,
                        is_recurrent=cfg["is_recurrent"], time_dim=T,
                        scaler_type=None, device=run.device)

    def sampler(part, shuffle):
        return SeriesSampler(part, model=net, input_time_steps=T,
                             output_time_steps=cfg["output_time_steps"],
                             sequence=t["sequence_steps"],
                             add_insolation=cfg["insolation"],
                             batch_size=t["batch"], shuffle=shuffle,
                             seed=sampler_seed)

    train = DeviceSeriesSampler(
        sampler(ds.isel_sample(np.arange(n - n_val)), True), device=run.device)
    val = DeviceSeriesSampler(
        sampler(ds.isel_sample(np.arange(n - n_val, n)), False),
        device=run.device)
    optimizer = chain(
        clip_by_global_norm(t["clip_norm"]),
        adam(cosine_decay_schedule(t["learning_rate"],
                                   t["decay_epochs"] * len(train), t["alpha"])))
    rank_axes = 5 if cfg["is_recurrent"] else 4
    net.build_model(specs.layers(cfg),
                    loss=latitude_weighted_loss(mse, lat),
                    optimizer=optimizer, learning_rate=t["learning_rate"],
                    sequence_steps=t["sequence_steps"],
                    splice_fn=splice(len(cfg["channels"])),
                    eval_impl="forward", mesh=mesh,
                    batch_spec=("data",) + (None,) * (rank_axes - 1))
    inputs.load_into(net.base_model, weights)
    return net, train, val


def epochs_for(trainer, train, val, control, seconds=None, epochs=None):
    """Whole epochs back to back, as the train driver runs them, until
    rank 0 has run ``epochs`` or ``seconds`` have passed on its clock; it
    broadcasts its decision after each epoch over ``control`` (a host-side
    group). Each epoch's seconds."""
    import torch.distributed as dist

    t0 = harness.now()
    out = []
    while True:
        trainer.fit_device(train, epochs=1, verbose=False,
                           validation_data=val)
        out.append(harness.now() - t0 - sum(out))
        done = len(out) >= epochs if epochs else sum(out) >= seconds
        flag = torch.tensor([int(done)])
        dist.broadcast(flag, src=0, group=control)
        if flag.item():
            return out


def _rank(rank: int, world: int, port: int, run: harness.Run):
    """The training every rank runs: set-up, the warm epoch, the window and
    (with ``--trace 1``) the traced epochs. Rank 0 returns what the check
    and the result read; the others None."""
    import torch.distributed as dist

    from dlwp_torch import kernels
    from dlwp_torch.parallel import MeshConfig
    from dlwp_torch.parallel.distributed import (initialize_distributed,
                                                 multihost_mesh)

    cfg, t, dev = run.cfg, run.traffic, run.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    stamps = {"driver": harness.now()}
    initialize_distributed(f"localhost:{port}", world, rank, device=dev,
                           timeout=t["timeout_s"])
    control = (dist.new_group(backend="gloo") if dev.type == "cuda"
               else None)
    mesh = multihost_mesh(MeshConfig(data=-1, lat=1), devices=[dev])
    B, S = t["batch"], t["sequence_steps"]
    s_weights, s_series, s_sampler = run.seeds(3)
    ref = load_reference(cfg["reference"])
    weights = inputs.make_weights(cfg, inputs.generator(s_weights, dev), dev)
    series, sol, _ = inputs.make_series(
        cfg, t["series_samples"], inputs.generator(s_series, dev), dev)
    host_series = series.cpu().numpy()
    stamps["inputs"] = harness.now()
    net, train, val = build(run, weights, host_series, s_sampler, mesh)
    trainer = net.trainer
    stamps["program"] = harness.now()
    spy = Spy(trainer, net.base_model, t["check_steps"], ref.ADAM_B1) \
        if rank == 0 else None
    # The first epoch warms up every shape and runs the checked steps.
    epochs_for(trainer, train, val, control, epochs=1)
    run.sync()
    stamps["warmup"] = harness.now()
    nb = len(train)

    kernels.reset_launch_counts()
    profiled = rank == 0 and not run.trace and dev.type == "cuda"
    t0 = harness.now()
    host0 = harness.host_clocks()
    with tracing.window(profiled, dev.type) as prof:
        epoch_s = epochs_for(trainer, train, val, control,
                             seconds=run.seconds)
    host = harness.host_since(host0)
    launches = kernels.launch_counts()
    busy = tracing.device_busy_s(prof) if prof is not None else None
    summary, traced_steps = None, 0
    if run.trace:
        with tracing.window(rank == 0, dev.type) as tprof:
            traced_steps = len(epochs_for(trainer, train, val, control,
                                          epochs=t["trace_epochs"])) * nb
        summary = tracing.summarize(tprof) if tprof is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if rank:
        dist.destroy_process_group()
        return None
    got = {"losses": [float(v) for v in spy.losses[:t["check_steps"]]],
           "first_grad": spy.g1, "params0": spy.p0, "params": spy.pn}
    n_train = train.sampler._series.shape[0]
    dist.destroy_process_group()
    del net, trainer, train, val, spy
    return dict(stamps=stamps, t0=t0, host=host, launches=launches,
                busy=busy, epoch_s=epoch_s, nb=nb, summary=summary,
                traced_steps=traced_steps, peak=peak, got=got,
                n_train=n_train, series=series, sol=sol, weights=weights,
                s_sampler=s_sampler, profiled=profiled, B=B, S=S, ref=ref)


def _child(rank: int, world: int, port: int, run: harness.Run) -> None:
    """A rank other than 0, in its own process; exits non-zero on any
    failure."""
    try:
        torch.set_num_threads(1)
        _rank(rank, world, port, run)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        sys.exit(1)


def run(run: harness.Run) -> harness.Outcome:
    world = run.traffic["ranks"]
    port = _free_port()
    ctx = mp.get_context("spawn")
    children = []
    for rank in range(1, world):
        child_run = dataclasses.replace(
            run, device=(torch.device("cuda", rank)
                         if run.device.type == "cuda" else run.device))
        p = ctx.Process(target=_child, args=(rank, world, port, child_run),
                        daemon=True)
        p.start()
        children.append(p)
    r = _rank(0, world, port, run)
    for p in children:
        p.join(run.traffic["timeout_s"])
    failed = [i + 1 for i, p in enumerate(children) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"train_dp: ranks {failed} failed")

    cfg, t, dev = run.cfg, run.traffic, run.device
    B, S, nb, ref = r["B"], r["S"], r["nb"], r["ref"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg_train = {"learning_rate": t["learning_rate"], "alpha": t["alpha"],
                 "decay_steps": t["decay_epochs"] * nb,
                 "clip_norm": t["clip_norm"]}
    batches = reference_batches(run, r["series"], r["sol"], r["s_sampler"],
                                r["n_train"], nb, t["check_steps"])
    with ref.precision(False):
        exact = ref.train(r["weights"], cfg, batches, cfg_train)
    exact["params0"] = r["weights"]
    answers = [gaps(r["got"], exact)]
    control = None
    if run.control == "tf32":
        with ref.precision(True):
            low = ref.train(r["weights"], cfg, batches, cfg_train)
        low["params0"] = r["weights"]
        control = [gaps(low, exact)]

    epochs = len(r["epoch_s"])
    steps = epochs * nb
    rate = steps * B / sum(r["epoch_s"])
    e2e = {}
    if r["busy"]:
        e2e["train_device_ms_per_step"] = 1e3 * r["busy"] / steps
    summary, traced = r["summary"], r["traced_steps"]
    units = {"steps": traced, "samples": traced * B // world,
             "samples_per_s": rate,
             "flops_per_sample": 3 * counts.forward_flops(cfg) * S}
    notes = {"ranks": world, "epochs": epochs, "steps_an_epoch": nb,
             "window_s": sum(r["epoch_s"]), "epoch_s": r["epoch_s"],
             "window_samples_per_s": rate, "window_profiled": r["profiled"],
             "host": r["host"], "stamps": r["stamps"],
             "launch_counts": {k: v for k, v in r["launches"].items() if v},
             "losses": r["got"]["losses"],
             "reference_losses": exact["losses"]}
    if r["busy"]:
        notes["window_busy_s"] = r["busy"]
    if summary is not None:
        notes["trace"] = {"launch_calls": summary.launches,
                          "device_kernels": summary.device_kernels}
    return harness.Outcome(
        setup_end=r["t0"], attempted=steps + traced, end_to_end=e2e,
        units=units, answers=answers, memory_peak_bytes=r["peak"],
        summary=summary, control=control, notes=notes)

"""Training epochs: ``Trainer.fit_device`` over a ``DeviceSeriesSampler``,
one epoch a call, each with its validation pass, as the paper training job
runs them (``docs/DEPLOY.md``: ``--sequence 2 --cosine-decay
--learning-rate 2e-3 --loss lat_mse --validation-fraction 0.25
--device-resident``).

Traffic keys: ``batch``, ``sequence_steps``, ``series_samples`` (6-hourly
samples of the seeded series), ``validation_fraction`` (the series' tail
held out), ``learning_rate``, ``alpha`` and ``decay_epochs`` (the cosine
decay: to ``alpha`` of the rate over that many epochs), ``clip_norm``,
``trace_epochs`` (the profiled epochs of a ``--trace 1`` run) and
``check_steps`` (the first train steps the reference follows).

Set-up builds one trainer and runs its first epoch through the window's
own call (``fit_device``); that epoch's first steps are the ones checked,
and the same trainer then trains on in the window. The window's
end-to-end number is the card's busy time a train step, read from a
profile of the whole window; the cell is host-bound, so its wall-clock
rate follows the host's speed and is a per-layer number, taken from an
unprofiled window in ``--trace 1`` runs.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from h100bench import counts, harness, inputs, specs, tracing
from h100bench.reference import load as load_reference

# Leaves whose reference gradient is below this share of the median
# leaf's are left out of the parameters' change: Adam moves them by
# round-off alone.
NOUGHT_GRADIENT = 1e-3


def splice(n_fields: int):
    """The training rollout's next input: the prediction's fields, the
    input window's insolation persisted (``train_convlstm``'s splice)."""
    def fn(inp, pred, k):
        return torch.cat([pred, inp[:, :, n_fields:]], dim=2)

    return fn


def build(run: harness.Run, weights: dict, host_series: np.ndarray,
          sampler_seed: int):
    """The program's training path: (net, train sampler, validation
    sampler), both samplers device-resident."""
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
    net.build_model(specs.layers(cfg),
                    loss=latitude_weighted_loss(mse, lat),
                    optimizer=optimizer, learning_rate=t["learning_rate"],
                    sequence_steps=t["sequence_steps"],
                    splice_fn=splice(len(cfg["channels"])),
                    eval_impl="forward")
    inputs.load_into(net.base_model, weights)
    return net, train, val


class Spy:
    """Records, around the trainer's ``train_step``, what the check reads
    of the first ``n`` steps: the parameters before the first, each step's
    loss, the first gradient as Adam's state holds it after one step, and
    the parameters after the ``n``-th. Then it steps aside."""

    def __init__(self, trainer, model, n: int, b1: float):
        self.trainer, self.model, self.n, self.b1 = trainer, model, n, b1
        self.losses, self.p0, self.g1, self.pn = [], None, None, None
        self.orig = trainer.train_step
        trainer.train_step = self

    def params(self):
        return {k: p.detach().clone()
                for k, p in self.model.named_parameters()}

    def __call__(self, x, y):
        k = len(self.losses)
        if k == 0:
            self.p0 = self.params()
        out = self.orig(x, y)
        self.losses.append(out["loss"].detach().clone())
        if k == 0:
            # A leaf that Adam's state lacks reads NaN: the step failed.
            state = self.trainer.optimizer.state
            self.g1 = {
                name: (state[p]["mu"].detach().clone() / (1 - self.b1)
                       if "mu" in state[p]
                       else torch.full_like(p, float("nan")))
                for name, p in self.model.named_parameters()}
        if k + 1 == self.n:
            self.pn = self.params()
            del self.trainer.train_step  # the class's method again
        return out


def reference_batches(run, series, sol, sampler_seed, n_train, nb, steps):
    """The first ``steps`` batches of the first epoch, worked out again:
    the sampler's ``RandomState(seed)`` shuffles its windows once when it
    is made and once for the epoch; each batch gathers its windows' input
    times (with insolation) and its S x T target times."""
    cfg, t = run.cfg, run.traffic
    T, S, B = cfg["input_time_steps"], t["sequence_steps"], t["batch"]
    windows = n_train - (T + T * S) + 1
    rs = np.random.RandomState(sampler_seed)
    rs.shuffle(np.arange(windows))
    order = np.arange(windows)
    rs.shuffle(order)
    out = []
    for k in range(steps):
        w = torch.as_tensor(order[k * B:(k + 1) * B], device=series.device)
        x = inputs.window(series, sol, w[:, None] + torch.arange(
            T, device=series.device))
        y = series.index_select(0, (w[:, None] + T + torch.arange(
            T * S, device=series.device)).reshape(-1))
        out.append((x, y.reshape((len(w), S, T) + tuple(series.shape[1:]))))
    return out


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64)))
            for k, v in tree.items()}


def gaps(got: dict, ref: dict) -> dict:
    """The check's numbers for one run of the first steps against the
    reference's (dicts with ``losses``, ``first_grad``, ``params0`` and
    ``params``)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], ref["losses"]))
    g_got, g_ref = _norms(got["first_grad"]), _norms(ref["first_grad"])
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(g_got[k] - g_ref[k]) / max(g_ref[k], g_med)
                   for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= NOUGHT_GRADIENT * g_med]
    d_got = _norms({k: got["params"][k] - got["params0"][k] for k in moved})
    d_ref = _norms({k: ref["params"][k] - ref["params0"][k] for k in moved})
    d_med = statistics.median(d_ref.values())
    change_gap = max(abs(d_got[k] - d_ref[k]) / max(d_ref[k], d_med)
                     for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def epochs_for(trainer, train, val, seconds=None, epochs=None) -> list:
    """Whole epochs back to back, each one ``fit_device`` call with its
    validation pass, until ``epochs`` have run or ``seconds`` have passed;
    each epoch's seconds."""
    t0 = harness.now()
    out = []
    while True:
        trainer.fit_device(train, epochs=1, verbose=False,
                           validation_data=val)
        out.append(harness.now() - t0 - sum(out))
        if len(out) >= epochs if epochs else sum(out) >= seconds:
            return out


def run(run: harness.Run) -> harness.Outcome:
    from dlwp_torch import kernels

    cfg, t, dev = run.cfg, run.traffic, run.device
    stamps = {"driver": harness.now()}
    B, S = t["batch"], t["sequence_steps"]
    n_check = t["check_steps"]
    s_weights, s_series, s_sampler = run.seeds(3)
    ref = load_reference(cfg["reference"])
    weights = inputs.make_weights(cfg, inputs.generator(s_weights, dev), dev)
    series, sol, _ = inputs.make_series(
        cfg, t["series_samples"], inputs.generator(s_series, dev), dev)
    host_series = series.cpu().numpy()
    stamps["inputs"] = harness.now()
    net, train, val = build(run, weights, host_series, s_sampler)
    trainer = net.trainer
    stamps["program"] = harness.now()
    spy = Spy(trainer, net.base_model, n_check, ref.ADAM_B1)
    # The first epoch warms up every shape (train steps and validation)
    # and runs the steps the check follows.
    trainer.fit_device(train, epochs=1, verbose=False, validation_data=val)
    run.sync()
    stamps["warmup"] = harness.now()
    nb = len(train)

    kernels.reset_launch_counts()
    # The window: whole epochs for --seconds. Its end-to-end number is the
    # card's busy time a train step, so the profiler records the card
    # throughout it. With --trace 1 the window runs unprofiled instead,
    # for its wall-clock rate (a per-layer number), and the profiled
    # epochs of the per-layer metrics follow it.
    profiled = not run.trace and dev.type == "cuda"
    t0 = harness.now()
    host0 = harness.host_clocks()
    with tracing.window(profiled, dev.type) as prof:
        epoch_s = epochs_for(trainer, train, val, seconds=run.seconds)
    host = harness.host_since(host0)
    launches = kernels.launch_counts()
    busy = tracing.device_busy_s(prof) if prof is not None else None
    epochs = len(epoch_s)
    steps = epochs * nb
    rate = steps * B / sum(epoch_s)
    summary, traced_steps = None, 0
    if run.trace:
        with run.window() as tprof:
            traced_steps = len(epochs_for(trainer, train, val,
                                          epochs=t["trace_epochs"])) * nb
        summary = tracing.summarize(tprof) if tprof is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    got = {"losses": [float(v) for v in spy.losses[:n_check]],
           "first_grad": spy.g1, "params0": spy.p0, "params": spy.pn}
    n_train = train.sampler._series.shape[0]
    del net, trainer, train, val, spy
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    cfg_train = {"learning_rate": t["learning_rate"], "alpha": t["alpha"],
                 "decay_steps": t["decay_epochs"] * nb,
                 "clip_norm": t["clip_norm"]}
    batches = reference_batches(run, series, sol, s_sampler, n_train, nb,
                                n_check)
    with ref.precision(False):
        exact = ref.train(weights, cfg, batches, cfg_train)
    exact["params0"] = weights
    answers = [gaps(got, exact)]
    control = None
    if run.control == "tf32":
        with ref.precision(True):
            low = ref.train(weights, cfg, batches, cfg_train)
        low["params0"] = weights
        control = [gaps(low, exact)]

    e2e = {}
    if busy:
        e2e["train_device_ms_per_step"] = 1e3 * busy / steps
    units = {"steps": traced_steps, "samples": traced_steps * B,
             "samples_per_s": rate,
             "flops_per_sample": 3 * counts.forward_flops(cfg) * S}
    notes = {"epochs": epochs, "steps_an_epoch": nb,
             "window_s": sum(epoch_s), "epoch_s": epoch_s,
             "window_samples_per_s": rate, "window_profiled": profiled,
             "host": host, "stamps": stamps,
             "launch_counts": {k: v for k, v in launches.items() if v},
             "losses": got["losses"], "reference_losses": exact["losses"]}
    if busy:
        notes["window_busy_s"] = busy
    if summary is not None:
        notes["trace"] = {"launch_calls": summary.launches,
                          "device_kernels": summary.device_kernels}
    return harness.Outcome(
        setup_end=t0, attempted=steps + traced_steps, end_to_end=e2e,
        units=units, answers=answers, memory_peak_bytes=peak, summary=summary,
        control=control, notes=notes)

"""The port's device-resident training vs dlwp_tpu and optax, on the CPU.

- ``DeviceSeriesSampler``: its batches equal the JAX ``DeviceSeriesSampler``'s
  and the port's host ``SeriesSampler``'s bit for bit (both store float32),
  across time steps, insolation, ``sequence``, channel selections and a
  series with NaN markers; its refusals; the ragged tail; reshuffling;
- ``Trainer.fit_device`` against the JAX ``fit_device`` over 3 shuffled
  epochs (History and parameters, to 1e-10): S=1 and S=2 with the
  insolation splice, validation on a device sampler, early stopping, adam
  and the ``--cosine-decay`` chain; resume equal to the uninterrupted run;
  ``fit``'s dispatch; ``fit_device`` equal to per-batch ``fit``; no host
  read inside an epoch's step loop;
- ``cosine_decay_schedule``, ``clip_by_global_norm`` and the chain against
  optax (1e-12), and ``load_optax_state`` of a chained state.

Inputs come from numpy seeds. JAX runs in float64 (x64) and the port's
models in float64; the device samplers hold float32, as the JAX one does.
The model is two cyclic convs on an 8x16 grid, so the JAX epochs compile
quickly.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_tpu.data import DeviceSeriesSampler as JDeviceSampler
from dlwp_tpu.data import PredictorDataset as JDataset
from dlwp_tpu.data import SeriesSampler as JSeriesSampler
from dlwp_tpu.models import build_sequential as jax_build
from dlwp_tpu.train import TrainConfig as JConfig
from dlwp_tpu.train import Trainer as JTrainer
from dlwp_tpu.train.callbacks import LearningRateTracker as JTracker

from dlwp_torch import (
    DLWPNeuralNet,
    DeviceSeriesSampler,
    PredictorDataset,
    SeriesSampler,
    build_sequential,
    flax_tree,
    load_flax_params,
    load_optax_state,
)
from dlwp_torch.parallel import MeshConfig, build_mesh
from dlwp_torch.train import (
    BatchHistory,
    LearningRateTracker,
    TrainConfig,
    Trainer,
    chain,
    clip_by_global_norm,
    cosine_decay_schedule,
)
from dlwp_torch.train import optim

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)
TOL = 1e-10
TOL_OPT = 1e-12
H, W, C, TD = 8, 16, 2, 2
SPECS = [("CyclicConv2D", (4, 3), {"activation": "tanh"}),
         ("CyclicConv2D", (TD * C, 3), {"dilation": 2})]


def _series(n, seed=5, markers=()):
    rs = np.random.RandomState(seed)
    pred = rs.randn(n, C + 1, H, W)
    pred[list(markers)] = np.nan
    kw = dict(
        predictors=pred,
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700", "T2M/0"],
        lat=np.linspace(70.0, -70.0, H), lon=np.arange(W) * 22.5,
    )
    return JDataset(**kw), PredictorDataset(**kw)


SAMPLERS = {
    "plain": dict(batch_size=4),
    "insolation_seq": dict(input_time_steps=TD, output_time_steps=TD,
                           sequence=3, add_insolation=True, batch_size=3),
    "selections": dict(input_sel=["T2M/0", "HGT/500"],
                       output_sel=["THICK/300-700"], input_time_steps=3,
                       output_time_steps=2, interval=2, batch_size=5,
                       is_recurrent=True),
    "markers": dict(input_time_steps=TD, output_time_steps=TD,
                    add_insolation=True, batch_size=4),
}


@pytest.mark.parametrize("case", sorted(SAMPLERS))
def test_device_sampler_batches_equal(case):
    """Every batch of two shuffled epochs: the port's device sampler, the
    port's host sampler and the JAX device sampler agree bit for bit."""
    markers = (7, 19) if case == "markers" else ()
    jdata, tdata = _series(40, markers=markers)
    kw = dict(SAMPLERS[case], shuffle=True, seed=2)
    host = SeriesSampler(tdata, **kw)
    dev = DeviceSeriesSampler(SeriesSampler(tdata, **kw), device="cpu")
    jdev = JDeviceSampler(JSeriesSampler(jdata, **kw))
    if case == "markers":
        assert host._valid is not None and len(host._valid) < host._n_sample
    assert len(dev) == len(jdev) == len(dev._index_pool) // kw["batch_size"]
    assert dev.convolution_shape == tuple(jdev.convolution_shape)
    for _ in range(2):
        for i, (x, y) in enumerate(dev):
            xh, yh = host[i]
            xj, yj = jdev[i]
            assert x.dtype == torch.float32 and x.device.type == "cpu"
            for got, a, b in ((x, xh, xj), (y, yh, yj)):
                np.testing.assert_array_equal(got.numpy(), a)
                np.testing.assert_array_equal(got.numpy(), np.asarray(b))
        host.on_epoch_end()
        jdev.sampler.on_epoch_end()


def test_device_sampler_refusals_and_epochs():
    jdata, tdata = _series(30, markers=(3,))
    with pytest.raises(ValueError, match="NaN"):
        DeviceSeriesSampler(SeriesSampler(tdata, remove_nan=False),
                            device="cpu")
    _, clean = _series(30)
    net = DLWPNeuralNet(scaler_type=None, impute_missing=True, device="cpu")
    with pytest.raises(NotImplementedError, match="imputed"):
        DeviceSeriesSampler(SeriesSampler(clean, model=net), device="cpu")
    mesh = build_mesh(MeshConfig(data=1, lat=2),
                      devices=[torch.device("cpu")] * 2)
    on_mesh = DeviceSeriesSampler(SeriesSampler(clean), sharding=mesh)
    assert on_mesh.device.type == "cpu" and on_mesh.sharding is mesh
    with pytest.raises(TypeError, match="Mesh"):
        DeviceSeriesSampler(SeriesSampler(clean), sharding="lat")
    # 30 samples, 1 in / 1 out: 29 windows, 7 full batches of 4.
    dev = DeviceSeriesSampler(SeriesSampler(clean, batch_size=4,
                                            shuffle=True), device="cpu")
    assert len(dev) == 7 and len(dev.sampler) == 8
    with pytest.raises(IndexError):
        dev[7]
    first = [x.clone() for x, _ in dev]
    second = [x.clone() for x, _ in dev]
    assert not all(torch.equal(a, b) for a, b in zip(first, second))


# ------------------------------------------------------------------ fit
def _splice_torch(inp, pred, k):
    """Next input: the prediction's channels and the input's insolation,
    on the (B, TD*(C+1), H, W) layout."""
    B = inp.shape[0]
    i = inp.reshape(B, TD, C + 1, H, W)
    p = pred.reshape(B, TD, C, H, W)
    return torch.cat([p, i[:, :, C:]], dim=2).reshape(inp.shape)


def _splice_jax(inp, pred, k):
    B = inp.shape[0]
    i = inp.reshape(B, TD, C + 1, H, W)
    p = pred.reshape(B, TD, C, H, W)
    return jnp.concatenate([p, i[:, :, C:]], axis=2).reshape(inp.shape)


def _sampler_kw(S, batch=4):
    sel = ["HGT/500", "THICK/300-700"]
    return dict(input_sel=sel, output_sel=sel, input_time_steps=TD,
                output_time_steps=TD, sequence=S if S > 1 else None,
                add_insolation=True, batch_size=batch)


def _tree(seed=0):
    model = build_sequential(SPECS, device="cpu")
    model.init(torch.zeros(1, TD * (C + 1), H, W, dtype=torch.float64),
               seed=seed)
    return flax_tree(model)


def _optimizers(kind, steps):
    """(port factory, optax transformation) of one kind."""
    if kind == "adam":
        return optim.adam(1e-2), optax.adam(1e-2)
    max_norm = {"chain": 1.0, "chain_tight": 0.05}[kind]
    return (
        chain(clip_by_global_norm(max_norm),
              optim.adam(cosine_decay_schedule(1e-2, steps, 0.05))),
        optax.chain(optax.clip_by_global_norm(max_norm),
                    optax.adam(optax.cosine_decay_schedule(1e-2, steps,
                                                           0.05))))


def _jax_device_sampler(data, **kw):
    """The JAX device sampler with its float32 series held as float64
    (the same values), so that the JAX model, whose sequence scan carries
    the batch's dtype, runs in float64 as the port's does (the port's
    trainer casts batches to its parameters' dtype)."""
    dev = JDeviceSampler(JSeriesSampler(data, **kw))
    dev._series = dev._series.astype(jnp.float64)
    if dev._sol is not None:
        dev._sol = dev._sol.astype(jnp.float64)
    return dev


def _port_trainer(tree, cfg, S):
    model = build_sequential(SPECS, device="cpu")
    load_flax_params(model, tree, dtype=torch.float64)
    return Trainer(model, cfg, splice_fn=_splice_torch if S > 1 else None)


CASES = {
    "S1_adam_val_early": dict(S=1, opt="adam", val=True, early=True),
    "S1_chain_val": dict(S=1, opt="chain", val=True, early=False),
    "S2_chain_tight": dict(S=2, opt="chain_tight", val=False, early=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_device_matches_jax(case):
    """3 shuffled epochs of fit_device from one flax tree: History (loss,
    val_loss) and the final parameters equal the JAX run's."""
    c = CASES[case]
    S, tree = c["S"], _tree()
    jdata, tdata = _series(18 + 2 * S)
    kw = _sampler_kw(S)
    jtrain = _jax_device_sampler(jdata, shuffle=True, seed=1, **kw)
    train = DeviceSeriesSampler(SeriesSampler(tdata, shuffle=True, seed=1,
                                              **kw), device="cpu")
    steps = 3 * len(train)
    port_opt, jax_opt = _optimizers(c["opt"], steps)
    cfg = dict(sequence_steps=S, early_stopping=c["early"], patience=0)
    jt = JTrainer(jax_build(SPECS), JConfig(optimizer=jax_opt, **cfg),
                  splice_fn=_splice_jax if S > 1 else None)
    jt.params = jax.tree.map(jnp.asarray, tree)
    jt.opt_state = jt.tx.init(jt.params)
    jval = val = None
    if c["val"]:
        jval = _jax_device_sampler(jdata, **kw)
        val = DeviceSeriesSampler(SeriesSampler(tdata, **kw), device="cpu")
    want = jt.fit_device(jtrain, epochs=3, validation_data=jval,
                         verbose=False)
    pt = _port_trainer(tree, TrainConfig(optimizer=port_opt, **cfg), S)
    got = pt.fit(generator=train, epochs=3, validation_data=val,
                 verbose=False)
    assert got.epoch == want.epoch
    for k in ("loss", "val_loss") if c["val"] else ("loss",):
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=TOL, atol=0, err_msg=k)
    got_tree = flax_tree(pt.model)["params"]
    for slot, leaves in jax.tree.map(np.asarray, jt.params)["params"].items():
        for name, v in leaves.items():
            np.testing.assert_allclose(got_tree[slot][name], v, rtol=0,
                                       atol=TOL, err_msg=slot + name)


def test_fit_device_resume_equals_uninterrupted(tmp_path):
    """With the chain (its schedule count in the checkpoint) and shuffle:
    2 epochs with a checkpoint each, a fresh trainer resumed to 3, against
    3 straight: parameters, optimizer state and epoch 3's loss bit for
    bit."""
    tree = _tree(seed=1)
    _, tdata = _series(24)

    def run(epochs, **ckpt):
        train = DeviceSeriesSampler(SeriesSampler(
            tdata, shuffle=True, seed=4, **_sampler_kw(1)), device="cpu")
        opt, _ = _optimizers("chain", 12)
        pt = _port_trainer(tree, TrainConfig(optimizer=opt), 1)
        return pt, pt.fit_device(train, epochs=epochs, verbose=False, **ckpt)

    ckpt = str(tmp_path / "ck")
    straight, h3 = run(3)
    run(2, checkpoint_dir=ckpt)
    resumed, hr = run(3, checkpoint_dir=ckpt, resume=True)
    assert hr.epoch == [2] and hr.history["loss"] == h3.history["loss"][2:]
    a = straight.model.state_dict()
    b = resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = (t.optimizer.state_dict() for t in (straight, resumed))
    assert [g["schedule_count"] for g in sa["param_groups"]] == [
        g["schedule_count"] for g in sb["param_groups"]] == [3 * len(
            DeviceSeriesSampler(SeriesSampler(tdata, **_sampler_kw(1)),
                                device="cpu"))]
    for i in sa["state"]:
        assert torch.equal(sa["state"][i]["mu"], sb["state"][i]["mu"])


def test_fit_dispatch_and_per_batch_equality(monkeypatch):
    """fit(generator=DeviceSeriesSampler) takes fit_device; a callback with
    on_batch forces the per-batch path; without shuffle the two train the
    same parameters and History bit for bit (as the JAX test of the two
    paths, tests/test_data.py:553-606, with shuffle off)."""
    tree = _tree(seed=2)
    _, tdata = _series(30)
    calls = []
    real = Trainer.fit_device

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(Trainer, "fit_device", spy)
    runs = []
    for cbs in ([], [BatchHistory()]):
        dev = DeviceSeriesSampler(SeriesSampler(tdata, **_sampler_kw(1)),
                                  device="cpu")
        pt = _port_trainer(tree, TrainConfig(shuffle=True, seed=3), 1)
        runs.append((pt, pt.fit(generator=dev, epochs=3, verbose=False,
                                callbacks=cbs), cbs))
    assert calls == [1]
    (a, ha, _), (b, hb, (bh,)) = runs
    assert ha.history["loss"] == hb.history["loss"]
    assert len(bh.batch_losses) == 3 and len(bh.batch_losses[0]) == len(dev)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # DLWPNeuralNet.fit_generator passes a device sampler on to fit.
    net = DLWPNeuralNet(scaler_type=None, time_dim=TD, device="cpu")
    net.build_model(SPECS)
    net.load_flax_params(tree, dtype=torch.float64)
    net.fit_generator(dev, epochs=1, verbose=False)
    assert calls == [1, 1]
    assert net.input_sample_shape == dev.convolution_shape


def test_step_loop_reads_nothing_back(monkeypatch):
    """Inside _device_epoch no tensor goes back to the host: item,
    __float__, __bool__, cpu, numpy and tolist raise there, and the loop
    runs every step of every epoch (S=2, the chain's clip included)."""
    tree = _tree(seed=3)
    _, tdata = _series(24)
    opt, _ = _optimizers("chain_tight", 15)
    pt = _port_trainer(tree, TrainConfig(optimizer=opt, sequence_steps=2), 2)
    dev = DeviceSeriesSampler(SeriesSampler(tdata, shuffle=True,
                                            **_sampler_kw(2)), device="cpu")
    names = ("item", "__float__", "__bool__", "cpu", "numpy", "tolist")
    steps, real = [], Trainer._device_epoch

    def guarded(self, sampler, idx):
        def refuse(name):
            def fn(*a, **k):
                raise AssertionError(f"Tensor.{name} inside the step loop")
            return fn

        with monkeypatch.context() as m:
            for name in names:
                m.setattr(torch.Tensor, name, refuse(name))
            out = real(self, sampler, idx)
        steps.append(len(out))
        return out

    monkeypatch.setattr(Trainer, "_device_epoch", guarded)
    hist = pt.fit_device(dev, epochs=2, verbose=False)
    assert steps == [len(dev)] * 2 and np.isfinite(hist.history["loss"]).all()


# ----------------------------------------------------------- optimizers
def test_cosine_decay_schedule_matches_optax():
    for kw in (dict(alpha=0.0), dict(alpha=0.05), dict(alpha=0.1,
                                                       exponent=2.0)):
        ours = cosine_decay_schedule(3e-3, 17, **kw)
        theirs = optax.cosine_decay_schedule(3e-3, 17, **kw)
        for count in (0, 1, 5, 16, 17, 18, 40):
            assert isinstance(ours(count), float)
            np.testing.assert_allclose(ours(count), float(theirs(count)),
                                       rtol=TOL_OPT, atol=0)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="positive decay_steps"):
            cosine_decay_schedule(1e-3, bad)
        with pytest.raises(ValueError, match="positive decay_steps"):
            optax.cosine_decay_schedule(1e-3, bad)
    # LearningRateTracker takes the schedule as it is.
    for epoch in range(4):
        assert LearningRateTracker(1e-3, schedule=cosine_decay_schedule(
            1e-3, 10, 0.05), steps_per_epoch=3).effective_lr(epoch) == \
            pytest.approx(JTracker(1e-3, schedule=optax.cosine_decay_schedule(
                1e-3, 10, 0.05), steps_per_epoch=3).effective_lr(epoch),
                rel=TOL_OPT)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    """Above the threshold (scaled to the norm) and below (unchanged)."""
    rs = np.random.RandomState(8)
    grads = {"a": rs.randn(3, 4), "b": rs.randn(5), "c": rs.randn(2, 2, 2)}
    want, _ = optax.clip_by_global_norm(max_norm).update(
        jax.tree.map(jnp.asarray, grads), optax.EmptyState())
    got = clip_by_global_norm(max_norm)([torch.from_numpy(grads[k])
                                         for k in "abc"])
    norm = np.sqrt(sum((g ** 2).sum() for g in grads.values()))
    assert (norm > max_norm) == (max_norm == 0.5)
    for k, g in zip("abc", got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=TOL_OPT, atol=0)


def _chain_pair(steps=20):
    port = chain(clip_by_global_norm(0.3),
                 optim.adam(cosine_decay_schedule(5e-2, steps, 0.05)))
    jax_tx = optax.chain(
        optax.clip_by_global_norm(0.3),
        optax.adam(optax.cosine_decay_schedule(5e-2, steps, 0.05)))
    return port, jax_tx


def _step_both(params, tensors, opt, tx, state, rs, n):
    for _ in range(n):
        grads = {k: rs.randn(*v.shape) for k, v in params.items()}
        for k, t in tensors.items():
            t.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                               params)
        params = optax.apply_updates(params, upd)
    return params, state


def test_chain_matches_optax_and_carries_state():
    """clip + adam(cosine schedule) over 20 steps against optax to 1e-12;
    then the optax state carried into a fresh port optimizer with
    load_optax_state, and 5 more steps on both."""
    rs = np.random.RandomState(9)
    init = {"layers.0.kernel": rs.randn(4, 3, 3, 3),
            "layers.0.bias": rs.randn(4),
            "layers.1.dense.kernel": rs.randn(6, 2)}
    params = {k: jnp.asarray(v) for k, v in init.items()}
    tensors = {k: torch.tensor(v) for k, v in init.items()}
    make, tx = _chain_pair()
    opt = make(list(tensors.items()))
    state = tx.init(params)
    params, state = _step_both(params, tensors, opt, tx, state, rs, 20)
    for k in init:
        np.testing.assert_allclose(tensors[k].numpy(), np.asarray(params[k]),
                                   rtol=0, atol=TOL_OPT, err_msg=k)
    assert opt.param_groups[0]["schedule_count"] == 20
    # Carry over: flax-layout moment trees from the names.
    fresh = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    opt2 = make(list(fresh.items()))

    def tree(flat):
        out = {}
        for k, v in flat.items():
            parts = k.split(".")
            node = out.setdefault(f"layers_{parts[1]}", {})
            for p in parts[2:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return {"params": out}

    carried = jax.tree.map(np.asarray, state)
    carried = (carried[0], (carried[1][0]._replace(
        mu=tree(carried[1][0].mu), nu=tree(carried[1][0].nu)),
        carried[1][1]))
    load_optax_state(opt2, carried)
    assert opt2.param_groups[0]["schedule_count"] == 20
    assert all(s["count"] == 20 for s in opt2.state.values())
    params, state = _step_both(params, fresh, opt2, tx, state, rs, 5)
    for k in init:
        np.testing.assert_allclose(fresh[k].numpy(), np.asarray(params[k]),
                                   rtol=0, atol=TOL_OPT, err_msg=k)
    # A state without the schedule's count does not fit a scheduled chain.
    with pytest.raises(ValueError, match="schedule"):
        load_optax_state(opt2, carried[1][0])

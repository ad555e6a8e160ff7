"""The port's training slice: fit over a sampler vs dlwp_tpu, and what
crosses runs and packages.

- ``DLWPNeuralNet.fit_generator`` over shuffled ``SeriesSampler``s against
  the JAX package's, in float64 at S=1 and S=2 (to 1e-9);
- checkpoints: a resumed run equals an uninterrupted one bit for bit;
- an optax Adam state carried over with ``load_optax_adam_state``, then one
  step, equals the JAX run's next step (to 1e-12);
- ``save_model`` / ``load_model``; the conv-pool and gate routing inside a
  train step and in evaluation; ``fit`` on a lat-band mesh equal to the
  unsharded fit; the default device; ``device_prefetch`` on the CPU.

Inputs are made with numpy from a seed and weights are one flax-layout
tree for both packages. The model is the ConvLSTM flagship cut to an 8x16
grid with a narrow tower.
"""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_tpu.data import PredictorDataset as JDataset
from dlwp_tpu.data import SeriesSampler as JSeriesSampler
from dlwp_tpu.models import DLWPFunctional as JFunctional
from dlwp_tpu.models import DLWPNeuralNet as JNet
from dlwp_tpu.models import build_sequential as jax_build
from dlwp_tpu.models.api import shape_series as jax_shape_series
from dlwp_tpu.train import TrainConfig as JConfig
from dlwp_tpu.train import Trainer as JTrainer

import dlwp_torch.models.layers as TL
from dlwp_torch import (
    DLWPFunctional,
    DLWPNeuralNet,
    PredictorDataset,
    SeriesSampler,
    build_sequential,
    device_prefetch,
    flax_tree,
    load_flax_params,
    load_model,
    load_optax_adam_state,
    save_model,
)
from dlwp_torch.models import shape_series
from dlwp_torch.models.cnn import SequentialModel
from dlwp_torch.ops.losses import latitude_weighted_loss, mse
from dlwp_torch.parallel import MeshConfig, build_mesh
from dlwp_torch.train import TrainConfig, Trainer, restore_checkpoint

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)
TOL_RUN = 1e-9
TOL_STEP = 1e-12
H, W, C, TD, F = 8, 16, 2, 2, 4


def small_specs():
    """The flagship's layers at an 8x16 grid, narrow."""
    return [
        ("ConvLSTM2D", (F, 3),
         {"dilation": 2, "return_sequences": True, "activation": "tanh"}),
        ("Reshape", ((TD * F, H, W),), None),
        ("CyclicConv2D", (6, 3), {"dilation": 2, "activation": "tanh"}),
        ("MaxPooling2D", (2,), None),
        ("CyclicConv2D", (8, 3), {"activation": "tanh"}),
        ("UpSampling2D", (2,), None),
        ("CyclicConv2D", (6, 3), {"dilation": 2, "activation": "tanh"}),
        ("CyclicConv2D", (TD * C, 5), {"activation": "linear"}),
        ("Reshape", ((TD, C, H, W),), None),
    ]


def splice_torch(inp, pred, k):
    """Persist the insolation channel (``examples/train_convlstm.py``)."""
    return torch.cat([pred, inp[:, :, C:]], dim=2)


def splice_jax(inp, pred, k):
    return jnp.concatenate([pred, inp[:, :, C:]], axis=2)


@pytest.fixture(autouse=True)
def _plain_convlstm_joint(monkeypatch):
    monkeypatch.delenv("DLWP_CONVLSTM_JOINT", raising=False)


@pytest.fixture(scope="module")
def tree():
    model = build_sequential(small_specs(), device="cpu")
    model.init(torch.zeros(1, TD, C + 1, H, W, dtype=torch.float64), seed=0)
    return flax_tree(model)


def _series(n, seed=5):
    rs = np.random.RandomState(seed)
    kw = dict(
        predictors=rs.randn(n, C, H, W),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(70.0, -70.0, H), lon=np.arange(W) * 22.5,
    )
    return JDataset(**kw), PredictorDataset(**kw)


def _sampler_kw(S):
    return dict(input_time_steps=TD, output_time_steps=TD,
                sequence=S if S > 1 else None, add_insolation=True,
                batch_size=4, dtype=np.float64)


def _port_net(tree, S=1, **build):
    net = DLWPNeuralNet(is_recurrent=True, time_dim=TD, scaler_type=None,
                        device="cpu")
    net.build_model(small_specs(), sequence_steps=S,
                    splice_fn=splice_torch if S > 1 else None, **build)
    net.load_flax_params(tree, dtype=torch.float64)
    return net


def _assert_params_close(port_tree, jax_params, tol):
    want = jax.tree.map(np.asarray, jax_params)["params"]
    got = port_tree["params"]
    assert got.keys() == want.keys()
    for slot in got:
        for name in got[slot]:
            np.testing.assert_allclose(got[slot][name], want[slot][name],
                                       rtol=0, atol=tol, err_msg=slot + name)


# ------------------------------------------------------ fit over a sampler
@pytest.mark.parametrize("S", [1, 2])
def test_fit_generator_matches_jax(S, tree):
    """DLWPNeuralNet.build_model(...).fit_generator over a shuffled
    SeriesSampler with insolation and a validation sampler, the flow of
    examples/train_convlstm.py with a latitude-weighted MSE and early
    stopping armed (validation at S=1): History and final parameters equal
    the JAX run's. The series gives 12 windows, three full batches."""
    jdata, tdata = _series(12 + 1 + 2 * S)
    build = dict(optimizer="adam", learning_rate=1e-2, early_stopping=True,
                 patience=3)
    from dlwp_tpu.ops.losses import latitude_weighted_loss as jax_lat_loss
    from dlwp_tpu.ops.losses import mse as jax_mse

    jnet = JNet(is_recurrent=True, time_dim=TD, scaler_type=None)
    jnet.build_model(small_specs(), loss=jax_lat_loss(jax_mse, jdata.lat),
                     sequence_steps=S,
                     splice_fn=splice_jax if S > 1 else None, **build)
    jnet.trainer.params = jax.tree.map(jnp.asarray, tree)
    jnet.trainer.opt_state = jnet.trainer.tx.init(jnet.trainer.params)
    kw = _sampler_kw(S)
    jtrain = JSeriesSampler(jdata, model=jnet, shuffle=True, seed=0, **kw)
    # Validation at S=1 only: each evaluated form is one more JAX compile.
    jval = JSeriesSampler(jdata, model=jnet, **kw) if S == 1 else None
    want = jnet.fit_generator(jtrain, validation_data=jval, epochs=2,
                              verbose=False)

    net = _port_net(tree, S, loss=latitude_weighted_loss(mse, tdata.lat),
                    **build)
    train = SeriesSampler(tdata, model=net, shuffle=True, seed=0, **kw)
    assert len(train) == 3
    val = SeriesSampler(tdata, model=net, **kw) if S == 1 else None
    got = net.fit_generator(train, validation_data=val, epochs=2,
                            verbose=False)
    assert got.epoch == want.epoch == [0, 1]
    for k in ("loss", "val_loss")[:3 - S]:
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=TOL_RUN, atol=0, err_msg=k)
    _assert_params_close(flax_tree(net.base_model), jnet.trainer.params,
                         TOL_RUN)
    assert net.input_sample_shape == tuple(jnet.input_sample_shape)


# ------------------------------------------------------------ checkpoints
def _all_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


@pytest.mark.parametrize("source", ["arrays", "sampler"])
def test_resume_equals_uninterrupted_run(source, tree, tmp_path):
    """Three epochs straight, against two epochs with a checkpoint each
    epoch and a fresh model and trainer resumed to the third: parameters,
    optimizer state and the third epoch's loss bit for bit."""
    _, tdata = _series(16)
    rs = np.random.RandomState(3)
    x, y = rs.randn(10, TD, C + 1, H, W), rs.randn(10, TD, C, H, W)

    def run(epochs, **ckpt):
        net = _port_net(tree, learning_rate=1e-2, seed=2, batch_size=4)
        if source == "arrays":
            hist = net.fit(x, y, epochs=epochs, verbose=False, **ckpt)
        else:
            sampler = SeriesSampler(tdata, model=net, shuffle=True, seed=4,
                                    **_sampler_kw(1))
            hist = net.fit_generator(sampler, epochs=epochs, verbose=False,
                                     **ckpt)
        return net, hist

    ckpt = str(tmp_path / "ck")
    straight, h3 = run(3)
    _, h2 = run(2, checkpoint_dir=ckpt)
    resumed, hr = run(3, checkpoint_dir=ckpt, resume=True)
    assert hr.epoch == [2] and h2.epoch == [0, 1]
    assert hr.history["loss"] == h3.history["loss"][2:]
    assert _all_equal(resumed.base_model.state_dict(),
                      straight.base_model.state_dict())
    s_opt = straight.trainer.optimizer.state_dict()["state"]
    r_opt = resumed.trainer.optimizer.state_dict()["state"]
    assert s_opt.keys() == r_opt.keys()
    for i in s_opt:
        # 3 epochs of 3 batches (10 samples) or of 4 (13 windows)
        assert s_opt[i]["count"] == r_opt[i]["count"] == (
            9 if source == "arrays" else 12)
        assert torch.equal(s_opt[i]["mu"], r_opt[i]["mu"])
        assert torch.equal(s_opt[i]["nu"], r_opt[i]["nu"])
    # The layout: a step_{n} entry per save, metadata of the latest beside.
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "metadata.json", "step_0", "step_1", "step_2"]
    state, meta = restore_checkpoint(ckpt)
    assert meta["epoch"] == 2 and _all_equal(
        state["params"], resumed.base_model.state_dict())
    first, _ = restore_checkpoint(ckpt, step=0)
    assert not _all_equal(first["params"], state["params"])
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))


def test_optax_adam_state_carries_over():
    """Two JAX train steps (weight decay chained in front of adam), then
    the JAX state carried into the port with load_flax_params and
    load_optax_adam_state: the port's next step equals the JAX run's. Two
    conv layers keep the JAX compile short."""
    specs = [("CyclicConv2D", (4, 3), {"activation": "tanh"}),
             ("CyclicConv2D", (C, 3), {"dilation": 2})]
    rs = np.random.RandomState(6)
    xs = rs.randn(3, 4, C, H, W)
    ys = 0.5 * rs.randn(3, 4, C, H, W)
    model = build_sequential(specs, device="cpu")
    model.init(torch.from_numpy(xs[0]), seed=3)
    cfg = dict(learning_rate=1e-2, weight_decay=1e-3)
    jt = JTrainer(jax_build(specs), JConfig(**cfg))
    params = jax.tree.map(jnp.asarray, flax_tree(model))
    opt_state = jt.tx.init(params)
    for k in range(2):
        params, opt_state, _ = jt._jit_train_step(params, opt_state, xs[k],
                                                  ys[k])
    load_flax_params(model, jax.tree.map(np.asarray, params),
                     dtype=torch.float64)
    pt = Trainer(model, TrainConfig(**cfg))
    pt.init(xs[0])
    load_optax_adam_state(pt.optimizer, jax.tree.map(np.asarray, opt_state))
    assert all(s["count"] == 2 for s in pt.optimizer.state.values())
    got = pt.train_step(xs[2], ys[2])
    params, opt_state, want = jt._jit_train_step(params, opt_state, xs[2],
                                                 ys[2])
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=TOL_STEP)
    _assert_params_close(flax_tree(model), params, TOL_STEP)
    bad = {"count": 1, "mu": {"params": {}}, "nu": {"params": {}}}
    with pytest.raises(KeyError, match="no moment"):
        load_optax_adam_state(pt.optimizer, bad)
    with pytest.raises(ValueError, match="no Adam state"):
        load_optax_adam_state(pt.optimizer, ())


# ------------------------------------------------------------ persistence
def test_save_load_model_round_trip(tree, tmp_path, monkeypatch):
    rs = np.random.RandomState(7)
    x, y = rs.randn(8, TD, C + 1, H, W), rs.randn(8, TD, C, H, W)
    net = _port_net(tree, learning_rate=5e-3, batch_size=4)
    hist = net.fit(x, y, epochs=1, verbose=False)
    path = str(tmp_path / "model")
    save_model(net, path, history=hist)
    again, h = load_model(path, history=True, device="cpu")
    np.testing.assert_array_equal(again.predict(x[:3]), net.predict(x[:3]))
    assert h == {"epoch": hist.epoch, "history": hist.history}
    assert again._train_config == net._train_config
    assert again.base_model.layers[0].recurrent_activation == "hard_sigmoid"
    assert not any(p.requires_grad for p in again.base_model.parameters())
    assert again.trainer.fit(x=x, y=y, epochs=1, verbose=False).epoch == [0]

    odd = _port_net(tree, loss=lambda a, b: ((a - b) ** 4).mean())
    save_model(odd, str(tmp_path / "odd"))
    with pytest.warns(UserWarning, match="non-picklable"):
        back = load_model(str(tmp_path / "odd"), device="cpu")
    assert back._train_config.loss == "mse"
    np.testing.assert_array_equal(
        pickle.loads(pickle.dumps(net)).predict(x[:2]), net.predict(x[:2]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(path)


def test_functional_predict_sequence_matches_jax():
    """DLWPFunctional's rollout and shape_series, against the JAX
    package's, on a one-conv model."""
    specs = [("CyclicConv2D", (2 * TD, 3), {"activation": "tanh"})]
    x = np.random.RandomState(8).randn(3, 2 * TD, H, W)
    net = DLWPFunctional(time_dim=TD, device="cpu")
    net.build_model(specs, sequence_steps=3)
    net.init(x)
    tree = {"params": {slot: {k: v.astype(np.float64) for k, v in leaves.items()}
                       for slot, leaves in flax_tree(net.base_model)["params"].items()}}
    load_flax_params(net.base_model, tree, dtype=torch.float64)
    jnet = JFunctional(time_dim=TD)
    jnet.build_model(specs, sequence_steps=3)
    jnet.trainer.params = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(net.predict_sequence(x),
                               jnet.predict_sequence(x), rtol=0, atol=1e-12)
    for kw in ({"step_sequence": True}, {"keep_time_dim": True}):
        np.testing.assert_allclose(net.predict_timeseries(x, 4, **kw),
                                   jnet.predict_timeseries(x, 4, **kw),
                                   rtol=0, atol=1e-12)
    ts = np.arange(2 * 3 * 4 * 5 * 6.0).reshape(2, 3, 4, 5, 6)
    for kw in ({}, {"step_sequence": True}, {"keep_time_dim": True}):
        np.testing.assert_array_equal(shape_series(ts, 2, (4, 5, 6), **kw),
                                      jax_shape_series(ts, 2, (4, 5, 6), **kw))


# ---------------------------------------------------------------- routing
def test_conv_pool_uses_kernel_only_without_a_gradient(tree):
    model = build_sequential(small_specs(), device="cpu")
    load_flax_params(model, tree)
    pool = next(l for l in model.layers if isinstance(l, TL.FusedConvPool2D))
    x = torch.randn(2, TD * F, H, W)
    assert pool.uses_kernel(x)
    pool.kernel.requires_grad_(True)
    assert not pool.uses_kernel(x)
    with torch.no_grad():
        assert pool.uses_kernel(x)
    pool.kernel.requires_grad_(False)
    assert not pool.uses_kernel(x.clone().requires_grad_(True))
    with torch.inference_mode():
        assert pool.uses_kernel(x)


@pytest.mark.parametrize("S", [1, 2])
def test_train_step_routing_and_gate_count(S, tree, monkeypatch):
    """Inside a train step the conv-pool runs its composition (the
    fused_conv_pool wrapper is not called) and the gate wrapper is called
    once a model step, and again in checkpoint's recompute when S > 1;
    evaluation calls the conv-pool wrapper once a model step. These are
    the launch counts chip_smoke.py holds the card to."""
    calls = {"fused_conv_pool": 0, "lstm_gates": 0}

    def spy(name):
        real = getattr(TL, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(TL, name, spy(name))
    model = build_sequential(small_specs(), device="cpu")
    load_flax_params(model, tree, dtype=torch.float32)
    pt = Trainer(model, TrainConfig(sequence_steps=S),
                 splice_fn=splice_torch if S > 1 else None)
    rs = np.random.RandomState(9)
    x = rs.randn(4, TD, C + 1, H, W).astype(np.float32)
    y = rs.randn(*((4, S) if S > 1 else (4,)), TD, C, H, W).astype(np.float32)
    pt.init(x)
    calls.update(fused_conv_pool=0, lstm_gates=0)  # init's shape pass
    pt.train_step(x, y)
    assert calls == {"fused_conv_pool": 0,
                     "lstm_gates": (TD - 1) * S * (2 if S > 1 else 1)}
    calls.update(fused_conv_pool=0, lstm_gates=0)
    pt.evaluate((x, y), batch_size=4)
    assert calls == {"fused_conv_pool": S, "lstm_gates": (TD - 1) * S}
    assert all(p.requires_grad for p in model.parameters())


def test_fit_on_a_lat_band_mesh_matches_unsharded(tree):
    """A model built on a (data 2, lat 2) mesh, once refused by ``fit``,
    trains: its history and weights equal the unsharded model's from the
    same weights (float64, 1e-9)."""
    mesh = build_mesh(MeshConfig(data=2, lat=2),
                      devices=[torch.device("cpu")] * 4)
    sharded = _port_net(tree, mesh=mesh,
                        batch_spec=("data", None, None, "lat", None))
    assert sharded.base_model.layers[0].spatial is sharded._spatial
    single = _port_net(tree)
    rs = np.random.RandomState(8)
    x, y = rs.randn(8, TD, C + 1, H, W), 0.5 * rs.randn(8, TD, C, H, W)
    fit = dict(epochs=2, batch_size=4, verbose=False)
    got = sharded.fit(x, y, **fit).history["loss"]
    want = single.fit(x, y, **fit).history["loss"]
    np.testing.assert_allclose(got, want, rtol=TOL_RUN, atol=0)
    _assert_params_close(flax_tree(sharded.base_model),
                         flax_tree(single.base_model), TOL_RUN)


def test_sequential_model_defaults_to_cuda(monkeypatch):
    assert SequentialModel([TL.Identity()], device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SequentialModel([TL.Identity()])


def test_parameters_require_grad_only_once_trained(tree):
    net = _port_net(tree)
    assert not any(p.requires_grad for p in net.base_model.parameters())
    x = np.random.RandomState(10).randn(4, TD, C + 1, H, W)
    before = net.predict(x)
    net.trainer.init(x)
    assert all(p.requires_grad for p in net.base_model.parameters())
    np.testing.assert_array_equal(net.predict(x), before)


# --------------------------------------------------------------- prefetch
def test_device_prefetch_on_the_cpu():
    _, tdata = _series(16)
    kw = _sampler_kw(1)
    want = list(SeriesSampler(tdata, shuffle=True, seed=1,
                              is_recurrent=True, **kw))
    got = list(device_prefetch(SeriesSampler(tdata, shuffle=True, seed=1,
                                             is_recurrent=True, **kw),
                               device="cpu"))
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor)
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gy.numpy(), wy)

    def broken():
        yield want[0]
        raise OSError("disk gone")

    it = device_prefetch(broken(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)

    def endless():
        while True:
            yield want[0]

    before = threading.active_count()
    it = device_prefetch(endless(), device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before

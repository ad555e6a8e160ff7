"""The port's training slice vs dlwp_tpu: losses, optimizers, Trainer, samplers.

Inputs are made with numpy from a seed; weights are one flax-layout tree
loaded into both packages. Everything runs in float64 on the CPU (JAX in
x64, as ``tests/conftest.py`` sets it; the port's kernel wrappers take
their plain versions). Tolerances: 1e-12 for a loss or one optimizer's
five steps (float64 rounding of the same formula), 1e-9 for whole training
runs (rounding through many convs, gradients and Adam steps).

The model is the ConvLSTM flagship cut to an 8x16 grid: a ConvLSTM2D of 4
features and a narrow tower (6-8-6 channels) with the flagship's
conv-pool, upsample-conv and 5x5 stages.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dlwp_tpu.data import PredictorDataset as JDataset
from dlwp_tpu.data import SamplesSampler as JSamplesSampler
from dlwp_tpu.data import SeriesSampler as JSeriesSampler
from dlwp_tpu.models import build_sequential as jax_build
from dlwp_tpu.ops import losses as JLoss
from dlwp_tpu.train import TrainConfig as JConfig
from dlwp_tpu.train import Trainer as JTrainer
from dlwp_tpu.train import callbacks as JCallbacks
from dlwp_tpu.train.trainer import resolve_optimizer as jax_optimizer
from dlwp_tpu.utils import split as JSplit

from dlwp_torch import (
    DLWPNeuralNet,
    PredictorDataset,
    SamplesSampler,
    SeriesSampler,
    build_sequential,
    flax_tree,
    load_flax_params,
)
from dlwp_torch.ops import losses as TLoss
from dlwp_torch.train import (
    OPTIMIZERS,
    BatchHistory,
    LearningRateTracker,
    TrainConfig,
    Trainer,
    add_decayed_weights,
    resolve_optimizer,
)
from dlwp_torch.utils import split as TSplit

torch.set_num_threads(1)
TOL_STEP = 1e-12
TOL_RUN = 1e-9
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
    """Seeded flagship weights as a flax tree of float64 numpy arrays."""
    model = build_sequential(small_specs(), device="cpu")
    model.init(torch.zeros(1, TD, C + 1, H, W, dtype=torch.float64), seed=0)
    return flax_tree(model)


def _arrays(n=12, S=1, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, TD, C + 1, H, W)
    y = 0.5 * rs.randn(n, TD, C, H, W)
    if S > 1:
        y = np.stack([y, np.roll(y, 1, axis=-1)], axis=1)
    return x, y


def _port_model(tree):
    model = build_sequential(small_specs(), device="cpu")
    load_flax_params(model, tree, dtype=torch.float64)
    return model


def _jax_trainer(tree, cfg, splice=None):
    tr = JTrainer(jax_build(small_specs()), JConfig(**cfg), splice_fn=splice)
    tr.params = jax.tree.map(jnp.asarray, tree)
    tr.opt_state = tr.tx.init(tr.params)
    return tr


def _assert_params_close(port_tree, jax_params, tol):
    want = jax.tree.map(np.asarray, jax_params)["params"]
    got = port_tree["params"]
    assert got.keys() == want.keys()
    for slot in got:
        assert got[slot].keys() == want[slot].keys()
        for name in got[slot]:
            np.testing.assert_allclose(got[slot][name], want[slot][name],
                                       rtol=0, atol=tol, err_msg=slot + name)


def _assert_history_close(got, want, tol):
    assert got.epoch == want.epoch
    keys = set(want.history) - {"time"}
    assert keys == set(got.history) - {"time"}
    for k in keys:
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=tol, atol=0, err_msg=k)


# ------------------------------------------------------------------ losses
def _loss_cases():
    lats = np.linspace(80.0, -80.0, H)
    mean = np.random.RandomState(4).randn(1, C, H, W)
    cases = {
        "mse": (TLoss.mse, JLoss.mse),
        "mae": (TLoss.mae, JLoss.mae),
        "acc": (TLoss.anomaly_correlation, JLoss.anomaly_correlation),
    }
    for w in ("cosine", "midlatitude"):
        for base in ("mse", "mae"):
            cases[f"lat_{w}_{base}"] = (
                TLoss.latitude_weighted_loss(getattr(TLoss, base), lats, w),
                JLoss.latitude_weighted_loss(getattr(JLoss, base), lats, w))
    for reg in (None, "global", "spatial", "mse", "mae"):
        for reverse in (True, False):
            for m in (None, mean):
                name = f"acc_loss_{reg}_{reverse}_{'mean' if m is not None else 'zero'}"
                cases[name] = (TLoss.anomaly_correlation_loss(m, reg, reverse),
                               JLoss.anomaly_correlation_loss(m, reg, reverse))
    return cases


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    port, ref = LOSS_CASES[name]
    rs = np.random.RandomState(1)
    y_true = rs.randn(3, C, H, W) + 2.0
    y_pred = y_true + 0.3 * rs.randn(3, C, H, W)
    want = float(ref(jnp.asarray(y_true), jnp.asarray(y_pred)))
    got = port(torch.from_numpy(y_true), torch.from_numpy(y_pred))
    assert got.dim() == 0 and got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=TOL_STEP, atol=TOL_STEP)
    again = pickle.loads(pickle.dumps(port))
    assert again(torch.from_numpy(y_true), torch.from_numpy(y_pred)).item() \
        == got.item()


def test_latitude_weighted_loss_gradient_and_passthrough():
    lats = np.linspace(60.0, -60.0, H)
    assert TLoss.latitude_weighted_loss(TLoss.mse, None) is TLoss.mse
    loss = TLoss.latitude_weighted_loss(TLoss.mse, lats)
    rs = np.random.RandomState(2)
    y_true = torch.from_numpy(rs.randn(2, C, H, W))
    y_pred = torch.from_numpy(rs.randn(2, C, H, W)).requires_grad_(True)
    loss(y_true, y_pred).backward()
    w = torch.from_numpy(np.cos(np.radians(lats)))[:, None]
    want = 2 * (y_pred.detach() - y_true) * w ** 2 / y_true.numel()
    torch.testing.assert_close(y_pred.grad, want, rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="weighting"):
        TLoss.latitude_weights(lats, "polar")
    with pytest.raises(ValueError, match="regularize_mean"):
        TLoss.anomaly_correlation_loss(regularize_mean="median")


# -------------------------------------------------------------- optimizers
OPT_CASES = [(name, {}, wd) for name in sorted(OPTIMIZERS) for wd in (0.0, 0.05)]
OPT_CASES += [("sgd", {"momentum": 0.9}, 0.0),
              ("sgd", {"momentum": 0.9, "nesterov": True}, 0.05),
              ("rmsprop", {"decay": 0.95}, 0.0)]


@pytest.mark.parametrize(
    "name,kwargs,wd", OPT_CASES,
    ids=[f"{n}{'-' + '-'.join(k) if k else ''}-wd{wd}" for n, k, wd in OPT_CASES])
def test_optimizer_matches_optax(name, kwargs, wd):
    """Five steps of every optimizer name, with and without the trainer's
    weight decay chained in front, from the same parameters and
    gradients."""
    rs = np.random.RandomState(3)
    params = {"params": {"layers_0": {"kernel": rs.randn(4, 3, 3, 3),
                                      "bias": rs.randn(4)},
                         "layers_2": {"kernel": rs.randn(2, 4, 5, 5)}}}
    grads = [jax.tree.map(lambda p: rs.randn(*p.shape) * 10.0 ** rs.randint(-3, 2),
                          params) for _ in range(5)]
    lr = 3e-2
    tx = jax_optimizer(name, lr, **kwargs)
    if wd:
        tx = optax.chain(optax.add_decayed_weights(wd), tx)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)

    tensors = {f"layers.{slot[7:]}.{k}": torch.tensor(v, requires_grad=True)
               for slot, leaves in params["params"].items()
               for k, v in leaves.items()}
    opt = resolve_optimizer(name, lr, **kwargs)(list(tensors.items()))
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for key, t in tensors.items():
            _, i, leaf = key.split(".")
            t.grad = torch.from_numpy(g["params"][f"layers_{i}"][leaf])
        if wd:
            add_decayed_weights(tensors.values(), wd)
        opt.step()
        for key, t in tensors.items():
            _, i, leaf = key.split(".")
            np.testing.assert_allclose(
                t.detach().numpy(), np.asarray(jp["params"][f"layers_{i}"][leaf]),
                rtol=TOL_STEP, atol=TOL_STEP, err_msg=key)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_unused_parameter_matches_optax(name):
    """A parameter the loss does not reach has no torch gradient; optax
    sees a zero gradient for it, so weight decay still shrinks it and its
    state still advances. Three steps with the trainer's weight decay."""
    rs = np.random.RandomState(5)
    used, unused = rs.randn(3, 4), rs.randn(4)
    grads = [rs.randn(3, 4) for _ in range(3)]
    lr, wd = 3e-2, 0.05
    tx = optax.chain(optax.add_decayed_weights(wd), jax_optimizer(name, lr))
    jp = {"used": jnp.asarray(used), "unused": jnp.asarray(unused)}
    state = tx.init(jp)

    t_used = torch.tensor(used, requires_grad=True)
    t_unused = torch.tensor(unused, requires_grad=True)
    opt = resolve_optimizer(name, lr)([t_used, t_unused])
    for g in grads:
        updates, state = tx.update(
            {"used": jnp.asarray(g), "unused": jnp.zeros(4)}, state, jp)
        jp = optax.apply_updates(jp, updates)
        t_used.grad, t_unused.grad = torch.from_numpy(g), None
        add_decayed_weights([t_used, t_unused], wd)
        opt.step()
        opt.zero_grad(set_to_none=True)
    for t, key in ((t_used, "used"), (t_unused, "unused")):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[key]),
                                   rtol=TOL_STEP, atol=TOL_STEP, err_msg=key)
    assert not np.allclose(t_unused.detach().numpy(), unused)


def test_resolve_optimizer_and_loss():
    assert resolve_optimizer(torch.optim.SGD) is torch.optim.SGD
    with pytest.raises(ValueError, match="unknown optimizer"):
        resolve_optimizer("adamax")
    with pytest.raises(ValueError, match="eval_impl"):
        Trainer(build_sequential([("CyclicConv2D", (1, 1), {})], device="cpu"),
                TrainConfig(eval_impl="scan"))


# --------------------------------------------------------------- training
@pytest.mark.parametrize("S", [1, 2])
def test_fit_arrays_matches_jax(S, tree):
    """Trainer.fit over shuffled arrays: History and final parameters equal
    the JAX Trainer's (validation is in the generator and early-stopping
    cases)."""
    x, y = _arrays(S=S)
    cfg = dict(epochs=2, batch_size=4, sequence_steps=S, learning_rate=1e-2)
    jt = _jax_trainer(tree, cfg, splice_jax if S > 1 else None)
    want = jt.fit(x=x, y=y, verbose=False)
    model = _port_model(tree)
    pt = Trainer(model, TrainConfig(**cfg),
                 splice_fn=splice_torch if S > 1 else None)
    got = pt.fit(x=x, y=y, verbose=False)
    _assert_history_close(got, want, TOL_RUN)
    _assert_params_close(flax_tree(model), jt.params, TOL_RUN)
    assert all(p.requires_grad for p in model.parameters())


def _series(n=20, seed=5, nan_at=None):
    rs = np.random.RandomState(seed)
    pred = rs.randn(n, C, H, W)
    if nan_at is not None:
        pred[nan_at, 1, 2, 3] = np.nan
    kw = dict(
        predictors=pred,
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(70.0, -70.0, H), lon=np.arange(W) * 22.5,
    )
    return JDataset(**kw), PredictorDataset(**kw)


@pytest.fixture(scope="module")
def eval_reference(tree):
    """Inputs (S=2 targets) and the JAX evaluate's value of them, loss and
    an MAE metric, in its 'forward' form: the JAX package's own tests hold
    its three forms equal."""
    x, y = _arrays(n=6, S=2, seed=7)
    jt = JTrainer(jax_build(small_specs()), JConfig(sequence_steps=2),
                  splice_fn=splice_jax, metrics={"mae": JLoss.mae})
    jt.params = jax.tree.map(jnp.asarray, tree)
    return x, y, jt.evaluate((x, y), batch_size=4)


@pytest.mark.parametrize("impl", ["forward", "outer", "grad"])
def test_eval_impl_matches_jax(impl, tree, eval_reference):
    """Each eval form gives the JAX evaluate's value, and the kernels'
    path (no gradient) leaves the parameters' gradients untouched."""
    x, y, want = eval_reference
    model = _port_model(tree)
    pt = Trainer(model, TrainConfig(sequence_steps=2, eval_impl=impl),
                 splice_fn=splice_torch, metrics={"mae": TLoss.mae})
    got = pt.evaluate((x, y), batch_size=4)
    assert got.keys() == want.keys() == {"loss", "mae"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_STEP)
    assert all(p.grad is None for p in model.parameters())


def test_evaluate_scaled(tree):
    """DLWPNeuralNet.evaluate scales with the scaler init_fit fitted, then
    takes Trainer.evaluate."""
    x, y = _arrays(n=6, seed=8)
    x, y = 3.0 * x + 1.0, 2.0 * y - 0.5
    net = DLWPNeuralNet(is_recurrent=True, time_dim=TD,
                        scaler_type="standard", device="cpu")
    net.build_model(small_specs())
    net.load_flax_params(tree, dtype=torch.float64)
    net.init_fit(x, y)
    got = net.evaluate(x, y, batch_size=4)
    xs, ys = net.scaler.transform(x), net.scaler_y.transform(y)
    want = Trainer(_port_model(tree)).evaluate((xs, ys), batch_size=4)
    assert got == want


def test_early_stopping_matches_jax():
    """Validation targets of the opposite sign, so val_loss rises as the
    model fits: both stop at the same epoch and restore the same best
    weights. A one-conv model keeps the JAX compile short."""
    specs = [("CyclicConv2D", (2, 3), {"activation": "tanh"})]
    model = build_sequential(specs, device="cpu")
    rs = np.random.RandomState(9)
    x, y = rs.randn(8, 2, H, W), 0.5 * rs.randn(8, 2, H, W)
    model.init(torch.from_numpy(x), seed=1)
    tree = flax_tree(model)
    cfg = dict(epochs=8, batch_size=4, learning_rate=3e-2,
               early_stopping=True, min_epochs=2, patience=0)
    val = (x, -y)
    jt = JTrainer(jax_build(specs), JConfig(**cfg))
    jt.params = jax.tree.map(jnp.asarray, tree)
    jt.opt_state = jt.tx.init(jt.params)
    want = jt.fit(x=x, y=y, validation_data=val, verbose=False)
    got = Trainer(model, TrainConfig(**cfg)).fit(x=x, y=y, validation_data=val,
                                                 verbose=False)
    assert got.epoch == want.epoch and len(got.epoch) < cfg["epochs"]
    _assert_history_close(got, want, TOL_RUN)
    _assert_params_close(flax_tree(model), jt.params, TOL_RUN)
    best = int(np.argmin(got.history["val_loss"]))
    assert best < len(got.epoch) - 1  # the restored weights are not the last


def test_fit_stops_on_non_finite_loss():
    model = build_sequential([("CyclicConv2D", (1, 3), {})], device="cpu")
    x = np.ones((4, 1, 4, 8))
    y = np.full_like(x, np.inf)
    hist = Trainer(model, TrainConfig(epochs=5, batch_size=2)).fit(
        x=x, y=y, verbose=False)
    assert hist.epoch == [0] and not np.isfinite(hist.history["loss"][0])


def test_callbacks_match_jax(tree):
    x, y = _arrays(n=6, seed=10)
    batches = BatchHistory()
    seen = []
    Trainer(_port_model(tree), TrainConfig(epochs=2, batch_size=4)).fit(
        x=x, y=y, verbose=False,
        callbacks=[batches, lambda e, m, p: seen.append((e, sorted(p)))])
    assert [len(b) for b in batches.batch_losses] == [2, 2]
    assert seen[0][0] == 0 and "layers.0.input_kernel" in seen[0][1]
    for kw in ({}, {"decay": 1e-3, "kind": "sgd"}, {"steps_per_epoch": 7},
               {"schedule": lambda t: 1e-3 * 0.5 ** t}):
        port = LearningRateTracker(1e-3, **kw)
        ref = JCallbacks.LearningRateTracker(1e-3, **kw)
        for epoch in range(3):
            assert port.effective_lr(epoch) == pytest.approx(
                ref.effective_lr(epoch), rel=1e-14)


# ----------------------------------------------------------------- samplers
@pytest.mark.parametrize("shuffle,nan_at,seq", [
    (True, None, None), (True, 9, None), (False, 9, 2), (True, None, 2)])
def test_series_sampler_batches_match_jax(shuffle, nan_at, seq):
    """Batch order for a seed over two epochs, the NaN-window pre-drop and
    sequence targets (B, S, ...), as the JAX sampler gives them."""
    jdata, tdata = _series(nan_at=nan_at)
    kw = dict(input_time_steps=TD, output_time_steps=TD, sequence=seq,
              add_insolation=True, batch_size=3, shuffle=shuffle, seed=11,
              is_recurrent=True, dtype=np.float64)
    js, ts = JSeriesSampler(jdata, **kw), SeriesSampler(tdata, **kw)
    assert len(ts) == len(js)
    if nan_at is not None:
        np.testing.assert_array_equal(ts._valid, js._valid)
    for _ in range(2):
        got, want = list(ts), list(js)
        assert len(got) == len(want) == len(ts)
        for (gx, gy), (wx, wy) in zip(got, want):
            # The insolation channel is computed by each package's own
            # formula, equal to float64 rounding; the series is copied.
            np.testing.assert_allclose(gx, wx, rtol=0, atol=TOL_STEP)
            np.testing.assert_array_equal(gx[:, :, :C], wx[:, :, :C])
            np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(ts[-1][1], js[-1][1])
    with pytest.raises(IndexError):
        ts[len(ts)]


def test_samples_sampler_matches_jax():
    rs = np.random.RandomState(12)
    pred = rs.randn(10, TD, C, H, W)
    targ = rs.randn(10, TD, C, H, W)
    pred[4, 0, 0, 0, 0] = np.nan
    kw = dict(sample=np.arange(10), varlev=["a", "b"],
              lat=np.linspace(60, -60, H), lon=np.arange(W) * 22.5)
    js = JSamplesSampler(JDataset(predictors=pred, targets=targ, **kw),
                         batch_size=4, shuffle=True, seed=3)
    ts = SamplesSampler(PredictorDataset(predictors=pred, targets=targ, **kw),
                        batch_size=4, shuffle=True, seed=3)
    assert ts.convolution_shape == js.convolution_shape
    for _ in range(2):
        for (gx, gy), (wx, wy) in zip(ts, js, strict=True):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    with pytest.raises(ValueError, match="targets"):
        SamplesSampler(PredictorDataset(predictors=pred, **kw))


@pytest.mark.parametrize("method", ["first", "last", "random"])
def test_split_matches_jax(method):
    for got, want in zip(TSplit.train_test_split_ind(20, 5, method, seed=2),
                         JSplit.train_test_split_ind(20, 5, method, seed=2)):
        np.testing.assert_array_equal(got, want)
    rs = np.random.RandomState(13)
    p, t = rs.randn(8, 3, 4), rs.randn(8, 2)
    p[1, 0, 0], t[5, 1], p[6, 2, 3] = np.nan, np.nan, 1e31
    for kw in ({}, {"large_fill_value": True}, {"threshold": 0.1}):
        for got, want in zip(TSplit.delete_nan_samples(p, t, **kw),
                             JSplit.delete_nan_samples(p, t, **kw)):
            np.testing.assert_array_equal(got, want)

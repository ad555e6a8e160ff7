"""The port's example workflows as a user chains them, on the CPU.

Training scripts on a port-written predictor file of 150 synthetic samples
(37x72), each for one or two epochs with ``--device cpu``: checkpoint and
resume, train then validate (insolation and the pole crop found from the
saved model), the (data, lat) mesh of ``train_distributed --virtual``, the
plots. Each training script's model has the parameter names and shapes of
the model the JAX script builds (``flax_tree`` against the flax tree) and
reloads through ``load_model`` to predict bit for bit as in memory.
"""

import contextlib
import importlib
import importlib.util
import io
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax

from dlwp_tpu.train import History as JHistory
from dlwp_tpu.train import Trainer as JTrainer
from dlwp_tpu.utils import load_model as jax_load_model

from dlwp_torch import flax_tree, load_model
from dlwp_torch.examples import write_predictors

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
N_SAMPLES = 150


@contextlib.contextmanager
def examples_on_path():
    sys.path.append(str(EXAMPLES))
    try:
        yield
    finally:
        sys.path.remove(str(EXAMPLES))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with examples_on_path():
        spec.loader.exec_module(mod)
    return mod


def run_port(name, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = importlib.import_module(
            f"dlwp_torch.examples.{name}").main(argv)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def pfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("flows") / "p150.h5")
    write_predictors.main(["--n-samples", str(N_SAMPLES),
                           "--output-file", path])
    return path


@pytest.fixture(autouse=True)
def _plain_convlstm_joint(monkeypatch):
    monkeypatch.delenv("DLWP_CONVLSTM_JOINT", raising=False)


def test_train_convlstm_resume_then_validate(pfile, tmp_path):
    """A killed run continues from its checkpoint: 1 epoch with
    ``--checkpoint-dir``, then ``--resume`` to 2 epochs starts at epoch 2;
    the saved model validates with its insolation and pole crop found."""
    common = ["--predictor-file", pfile, "--batch-size", "16",
              "--device-resident", "--validation-fraction", "0.25",
              "--loss", "lat_mse", "--checkpoint-dir", str(tmp_path / "ck"),
              "--model-file", str(tmp_path / "m"), "--device", "cpu"]
    (_, first), out = run_port("train_convlstm", ["--epochs", "1"] + common)
    assert "epoch 1/1" in out and "saved" in out
    (net, hist), out = run_port("train_convlstm",
                                ["--epochs", "2", "--resume"] + common)
    assert "resumed from epoch 1" in out
    assert "epoch 2/2" in out and "epoch 1/2" not in out
    assert hist.epoch == [1] and np.isfinite(hist.history["val_loss"]).all()
    assert (tmp_path / "m.pkl").exists()
    rows, out = run_port("validate", [
        "--predictor-file", pfile, "--model-file", str(tmp_path / "m"),
        "--forecast-steps", "4", "--device", "cpu",
        "--plot-file", str(tmp_path / "v.png"),
        "--output-file", str(tmp_path / "v.pkl")])
    assert "auto: cropping the 90N row" in out
    assert "trained with an insolation channel" in out
    assert "RMSE vs forecast hour" in out
    assert len(rows["f_hour"]) == 4
    assert all(np.isfinite(v).all() for k, v in rows.items())


def test_train_then_validate(pfile, tmp_path):
    """``train``'s default adds the insolation channel; ``validate`` finds
    it from the saved model's input shape."""
    run_port("train", ["--predictor-file", pfile, "--epochs", "1",
                       "--model-file", str(tmp_path / "m"),
                       "--device", "cpu"])
    _, out = run_port("validate", [
        "--predictor-file", pfile, "--model-file", str(tmp_path / "m"),
        "--forecast-steps", "2", "--device", "cpu",
        "--plot-file", str(tmp_path / "v.png"),
        "--output-file", str(tmp_path / "v.pkl")])
    assert "trained with an insolation channel" in out
    assert "RMSE vs forecast hour" in out


def test_validate_trains_inline(pfile, tmp_path):
    """No ``--model-file``: a demo model is trained in-line; the vrt core."""
    rows, out = run_port("validate", [
        "--predictor-file", pfile, "--forecast-steps", "2",
        "--barotropic-form", "vrt", "--device", "cpu",
        "--plot-file", str(tmp_path / "v.png"),
        "--output-file", str(tmp_path / "v.pkl")])
    assert "training a quick demo model in-line" in out
    assert "monthly climatology baseline skipped" in out
    assert np.isfinite(rows["barotropic_rmse"]).all()


@pytest.mark.parametrize("data,lat", [(2, 2), (4, 1)])
def test_train_distributed_virtual(pfile, data, lat):
    """``--virtual 4``: four mesh entries that repeat the CPU."""
    (net, hist), out = run_port("train_distributed", [
        "--virtual", "4", "--data-shards", str(data), "--lat-shards",
        str(lat), "--epochs", "1", "--predictor-file", pfile,
        "--device", "cpu"])
    assert "devices: 4" in out
    assert f"mesh: {{'data': {data}, 'lat': {lat}}}" in out
    assert ("spatial sharding: 2 lat bands (ppermute)" in out) == (lat > 1)
    assert np.isfinite(hist.history["loss"]).all()
    assert net.trainer.mesh.shape == {"data": data, "lat": lat}


def _init_without_training(self, generator=None, **kwargs):
    """``dlwp_tpu.train.Trainer.fit``'s parameter init from the first
    batch, without its epochs. It mirrors the init of ``Trainer.fit`` in
    ``dlwp_tpu/train/trainer.py`` (its ``if self.params is None`` branch;
    ``fit_device``'s init is the same, ``self.init(generator[0][0][:1])``),
    so the tree is the one that fit would train."""
    x0, _ = generator[0]
    self.init(jax.numpy.asarray(np.asarray(x0))[:1])
    return JHistory()


def _shapes(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_tree(specs, x):
    """The flax tree the JAX package builds for ``specs`` (shapes only)."""
    from dlwp_tpu.models import build_sequential as jax_build

    model = jax_build(specs)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))


def _jax_convlstm(x):
    mod = jax_script("train_convlstm")
    T, C, H, W = x.shape[1:]
    specs = mod.convlstm_tower(T, C, T * (C - 1), 4 * C)
    specs[1] = ("Reshape", ((T * 4 * C, H, W),), None)
    specs.append(("Reshape", ((T, C - 1, H, W),), None))
    return _jax_tree(specs, x)


TRAINING = {
    # name: (extra flags, input item shape, the JAX model's tree)
    "train_convlstm": (["--validation-fraction", "0.25"], (2, 3, 36, 72),
                       _jax_convlstm),
    "train": ([], (6, 36, 72), lambda x: _jax_tree(
        jax_script("train").build_layer_specs(6, 4), x)),
    "train_spherical": (["--truncation", "6", "--features", "4",
                         "--batch-size", "16"], (4, 37, 72),
                        lambda x: _jax_tree(
                            jax_script("train_spherical").build_layer_specs(
                                4, 4, 37, 72, 37, 6, 4), x)),
    "train_functional": (["--sequence", "2"], (2, 37, 72), None),
}


@pytest.mark.parametrize("name", sorted(TRAINING))
def test_training_scripts_build_the_jax_models(name, pfile, tmp_path):
    flags, item, jax_tree = TRAINING[name]
    argv = ["--predictor-file", pfile, "--epochs", "1",
            "--model-file", str(tmp_path / "m")] + flags
    (net, hist), out = run_port(name, argv + ["--device", "cpu"])
    assert "saved" in out and np.isfinite(hist.history["loss"]).all()
    x = np.random.RandomState(0).randn(3, *item).astype(np.float32)
    if jax_tree is None:
        # The script's specs are inline: the JAX script's own saved model,
        # its parameters initialised as its fit would and not trained (only
        # their names and shapes are compared).
        mod = jax_script(name)
        with examples_on_path(), contextlib.redirect_stdout(io.StringIO()), \
                pytest.MonkeyPatch.context() as mp:
            mp.setattr(JTrainer, "fit", _init_without_training)
            mod.main(argv[:-2] + ["--model-file", str(tmp_path / "j")])
        want = jax_load_model(str(tmp_path / "j")).trainer.params
    else:
        want = jax_tree(x)
    assert _shapes(flax_tree(net.base_model)) == _shapes(want)
    back = load_model(str(tmp_path / "m"), device="cpu")
    assert back.input_sample_shape == net.input_sample_shape == item
    np.testing.assert_array_equal(back.predict(x), net.predict(x))


@pytest.mark.parametrize("name,argv,outputs", [
    ("plot_forecasts", ["--out-prefix", "f"],
     ("f_panels.png", "f_laplacian.png")),
    ("plot_movie", ["--output-file", "m.gif"], ("m.gif",)),
    ("plot_ensemble", ["--plot-file", "e.png"], ("e.png",))])
def test_plot_scripts(pfile, tmp_path, monkeypatch, name, argv, outputs):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    _, out = run_port(name, ["--predictor-file", pfile, "--steps", "2",
                             "--device", "cpu"] + argv)
    for f in outputs:
        assert f"saved {f}" in out
        assert (tmp_path / f).stat().st_size > 0

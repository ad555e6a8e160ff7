"""The port's example workflows (``dlwp_torch.examples``) against the JAX
package's ``examples/`` scripts, and the repairs they needed.

Everything runs in-process on the CPU with ``--device cpu``; the input is
a port-written predictor file of 150 synthetic samples (37x72). A JAX
script's ``main`` runs only where its numbers are compared. Limits: the
data and acquisition scripts bit-equal to JAX (files, printed requests);
the barotropic integration 1e-5 relative (float32 on both sides, the
summation order differs); the archive 5e-5 of the anomaly (as
``tests/test_torch_port_archive.py``: float32 dynamics over days);
validation's baseline rows 1e-12, its forecast row 1e-5 and its
barotropic row 1e-4 relative (float32 models and cores); the repaired
``Trainer.predict`` 1e-10 in float64.
"""

import contextlib
import importlib
import importlib.util
import io
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

import jax

from dlwp_tpu.data import PredictorDataset as JDataset
from dlwp_tpu.data import SeriesSampler as JSeriesSampler
from dlwp_tpu.models import DLWPNeuralNet as JNet
from dlwp_tpu.models import build_sequential as jax_build
from dlwp_tpu.train import Trainer as JTrainer
from dlwp_tpu.utils import load_model as jax_load_model
from dlwp_tpu.utils import save_model as jax_save_model

from dlwp_torch import (
    DLWPNeuralNet,
    PredictorDataset,
    SeriesSampler,
    build_sequential,
    device_prefetch,
    flax_tree,
    load_flax_params,
    load_model,
    save_model,
)
from dlwp_torch.examples import _synthetic, write_predictors
from dlwp_torch.parallel import MeshConfig, build_mesh
from dlwp_torch.train import Trainer

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
MODULES = ("train_convlstm", "validate", "run_barotropic", "train",
           "train_functional", "train_spherical", "train_distributed",
           "make_barotropic_archive", "write_predictors", "add_thickness",
           "write_cfs", "write_cfs_reforecast", "retrieve_era5",
           "plot_forecasts", "plot_movie", "plot_ensemble")
# The modules that put work on a device (the others are host only).
DEVICE_MODULES = ("train_convlstm", "validate", "run_barotropic", "train",
                  "train_functional", "train_spherical", "train_distributed",
                  "make_barotropic_archive", "plot_forecasts", "plot_movie",
                  "plot_ensemble")
N_SAMPLES = 150
TOL_PREDICT = 1e-10
TOL_BARO = 1e-5
TOL_ARCHIVE = 5e-5
TOL_BASE_ROWS = 1e-12
TOL_FORECAST_ROW = 1e-5
TOL_BARO_ROW = 1e-4


def port(name):
    return importlib.import_module(f"dlwp_torch.examples.{name}")


@contextlib.contextmanager
def examples_on_path():
    """The JAX scripts import ``_path`` and ``_synthetic`` from their
    folder, also inside ``main``."""
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


def run_jax(name, argv):
    """The JAX script's ``main(argv)``; returns (result, stdout)."""
    mod = jax_script(name)
    out = io.StringIO()
    with examples_on_path(), contextlib.redirect_stdout(out):
        result = mod.main(argv)
    return result, out.getvalue()


def run_port(name, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = port(name).main(argv)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def pfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("examples") / "p150.h5")
    write_predictors.main(["--n-samples", str(N_SAMPLES),
                           "--output-file", path])
    return path


@pytest.fixture(autouse=True)
def _plain_convlstm_joint(monkeypatch):
    monkeypatch.delenv("DLWP_CONVLSTM_JOINT", raising=False)


# ----------------------------------------------------------------- repairs
SPECS = [("ConvLSTM2D", (4, 3),
          {"dilation": 2, "return_sequences": True, "activation": "tanh"}),
         ("Reshape", ((8, 8, 16),), None),
         ("CyclicConv2D", (6, 3), {"dilation": 2, "activation": "tanh"}),
         ("MaxPooling2D", (2,), None),
         ("UpSampling2D", (2,), None),
         ("CyclicConv2D", (4, 5), {"activation": "linear"}),
         ("Reshape", ((2, 2, 8, 16),), None)]


def test_trainer_predict_matches_jax():
    """``Trainer.predict`` (numpy in and out, in batches, on the model's
    device under inference mode) against the JAX trainer's on one tree."""
    model = build_sequential(SPECS, device="cpu")
    model.init(torch.zeros(1, 2, 3, 8, 16, dtype=torch.float64), seed=0)
    tree = flax_tree(model)
    load_flax_params(model, tree, dtype=torch.float64)
    x = np.random.RandomState(1).randn(11, 2, 3, 8, 16)
    got = Trainer(model).predict(x, batch_size=4)
    jt = JTrainer(jax_build(SPECS))
    jt.params = jax.tree.map(jax.numpy.asarray, tree)
    want = jt.predict(x, batch_size=4)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == want.shape == (11, 2, 2, 8, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PREDICT)
    assert all(not p.requires_grad or p.grad is None
               for p in model.parameters())


@pytest.mark.parametrize("insolation", [False, True])
@pytest.mark.parametrize("recurrent", [False, True])
@pytest.mark.parametrize("sequence", [None, 3])
def test_sampler_shape_properties_match_jax(insolation, recurrent, sequence):
    ds = _synthetic.synthetic_predictor_file(n_samples=40, nlat=9, nlon=16)
    jds = JDataset(predictors=ds.predictors, sample=ds.sample,
                   varlev=ds.varlev, lat=ds.lat, lon=ds.lon, mean=ds.mean,
                   std=ds.std)
    kw = dict(input_time_steps=2, output_time_steps=2, sequence=sequence,
              add_insolation=insolation, is_recurrent=recurrent)
    got, want = SeriesSampler(ds, **kw), JSeriesSampler(jds, **kw)
    for name in ("n_features", "dense_shape", "sequence",
                 "convolution_shape", "output_convolution_shape", "shape"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.n_features == 2 * (2 + insolation) * 9 * 16


def test_device_prefetch_takes_a_mesh():
    """``sharding=``: batches arrive whole on the mesh's first device,
    bit-equal to the sampler's; a Mesh or a (Mesh, names) pair; another
    device beside it, or a sharding that is no mesh, raises."""
    ds = _synthetic.synthetic_predictor_file(n_samples=30, nlat=9, nlon=16)
    sampler = SeriesSampler(ds, batch_size=8, add_insolation=True)
    want = list(sampler)
    mesh = build_mesh(MeshConfig(data=2, lat=1),
                      devices=[torch.device("cpu")] * 2)
    for sharding, device in ((mesh, None), ((mesh, ("data",)), None),
                             (mesh, "cpu")):
        got = list(device_prefetch(sampler, sharding=sharding, depth=3,
                                   device=device))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert all(t.device == torch.device("cpu") for t in g)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="first device"):
        next(device_prefetch(sampler, sharding=mesh, device="cuda"))
    with pytest.raises(TypeError, match="Mesh"):
        next(device_prefetch(sampler, sharding=("data",)))


def test_save_model_keeps_nested_parameter_trees(tmp_path):
    """A layer whose parameters sit a level deeper (``Linear``'s
    ``layers_3/dense/kernel``) saves and loads: the spherical workflow's
    model used to fail in ``save_model``."""
    specs = port("train_spherical").build_layer_specs(2, 2, 9, 16, 5, 3, 2)
    net = DLWPNeuralNet(time_dim=1, scaler_type=None, device="cpu")
    net.build_model(specs)
    x = np.random.RandomState(2).randn(3, 2, 9, 16).astype(np.float32)
    net.init(x)
    assert "dense" in flax_tree(net.base_model)["params"]["layers_3"]
    save_model(net, str(tmp_path / "s"))
    back = load_model(str(tmp_path / "s"), device="cpu")
    a, b = flax_tree(net.base_model), flax_tree(back.base_model)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(back.predict(x), net.predict(x))


# ------------------------------------------------------------ the modules
@pytest.mark.parametrize("name", MODULES)
def test_module_runs_as_main_with_help(name, monkeypatch, capsys):
    """``python -m dlwp_torch.examples.<name> --help``, in-process."""
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    monkeypatch.delitem(sys.modules, f"dlwp_torch.examples.{name}",
                        raising=False)
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f"dlwp_torch.examples.{name}", run_name="__main__",
                         alter_sys=True)
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("usage:")
    assert ("--device" in out) == (name in DEVICE_MODULES)


@pytest.mark.parametrize("name", DEVICE_MODULES)
def test_device_module_raises_without_a_card(name, monkeypatch):
    """The default device is cuda, with no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port(name).main([])


def test_synthetic_matches_jax():
    jsyn = jax_script("_synthetic")
    got = _synthetic.SyntheticGlobalSource(n_samples=N_SAMPLES)
    want = jsyn.SyntheticGlobalSource(n_samples=N_SAMPLES)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.lat, want.lat)
    np.testing.assert_array_equal(got.lon, want.lon)
    for var, lev in (("HGT", 500), ("THICK", "300-700"), ("TMP", 850)):
        np.testing.assert_array_equal(got.field(var, lev),
                                      want.field(var, lev))
    with examples_on_path():
        jds = jsyn.synthetic_predictor_file(n_samples=N_SAMPLES)
    ds = _synthetic.synthetic_predictor_file(n_samples=N_SAMPLES)
    for key in ("predictors", "mean", "std", "lat", "lon", "sample"):
        np.testing.assert_array_equal(getattr(ds, key), getattr(jds, key))
    assert ds.varlev == jds.varlev


def _files_equal(a, b):
    import h5py

    with h5py.File(a) as fa, h5py.File(b) as fb:
        assert sorted(fa) == sorted(fb)
        assert dict(fa.attrs) == dict(fb.attrs)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k][:], fb[k][:])


def test_write_predictors_and_thickness_match_jax(tmp_path):
    files = {pkg: str(tmp_path / f"{pkg}.h5") for pkg in ("port", "jax")}
    thick = {pkg: str(tmp_path / f"{pkg}_t.h5") for pkg in ("port", "jax")}
    outs = {}
    for pkg, run in (("port", run_port), ("jax", run_jax)):
        _, out = run("write_predictors", ["--n-samples", str(N_SAMPLES),
                                          "--output-file", files[pkg]])
        _, out2 = run("add_thickness", [files[pkg], "--upper", "HGT/500",
                                        "--lower", "THICK/300-700",
                                        "--output-file", thick[pkg]])
        outs[pkg] = (out.replace(files[pkg], "F"),
                     out2.replace(files[pkg], "F").replace(thick[pkg], "T"))
    assert outs["port"] == outs["jax"]
    assert "added THICK/500-300-700" in outs["port"][1]
    _files_equal(files["port"], files["jax"])
    _files_equal(thick["port"], thick["jax"])
    data = PredictorDataset.from_file(files["port"])
    name, mean, std = port("add_thickness").add_thickness(
        data, "HGT/500", "THICK/300-700")
    np.testing.assert_array_equal(
        data.predictors, PredictorDataset.from_file(thick["port"]).predictors)


@pytest.mark.parametrize("name,needle", [
    ("write_cfs", "nomads.ncdc.noaa.gov"),
    ("write_cfs_reforecast", "cfsr-rfl-ts45"),
    ("retrieve_era5", "reanalysis")])
def test_acquisition_dry_runs_match_jax(name, needle):
    """``--dry-run`` prints the requests and contacts nothing."""
    _, got = run_port(name, ["--dry-run"])
    _, want = run_jax(name, ["--dry-run"])
    assert got == want
    assert needle in got


def test_make_barotropic_archive_matches_jax(tmp_path):
    args = ["--years", "0.05", "--nlat", "19", "--nlon", "36",
            "--truncation", "12", "--segment-days", "5", "--seed", "1"]
    got, out = run_port("make_barotropic_archive", args + [
        "--device", "cpu", "--output-file", str(tmp_path / "a.h5")])
    _, jout = run_jax("make_barotropic_archive", args + [
        "--output-file", str(tmp_path / "j.h5")])

    def head(text, path):  # the printed line without its seconds
        return text.replace(path, "F").rsplit(",", 1)[0]

    assert head(out, str(tmp_path / "a.h5")) == head(jout,
                                                     str(tmp_path / "j.h5"))
    want = PredictorDataset.from_file(str(tmp_path / "j.h5"))
    assert got.varlev == want.varlev == ["HGT/500", "VRT/500"]
    np.testing.assert_array_equal(got.sample, want.sample)
    for key in ("mean", "std"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=TOL_ARCHIVE)
    g, w = np.asarray(got.predictors), np.asarray(want.predictors)
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan)
    assert nan.all(axis=(1, 2, 3)).sum() == 3  # the restarts' markers
    np.testing.assert_allclose(g[~nan], w[~nan], rtol=0,
                               atol=TOL_ARCHIVE * np.abs(w[~nan]).max())
    # The compute path alone, in memory, is the file's series.
    mod = port("make_barotropic_archive")
    a = mod.parse_args(args + ["--device", "cpu"])
    mem = mod.write_archive(a, mod.archive_source(a), None)
    np.testing.assert_array_equal(mem.predictors, g)
    got.close()
    want.close()


def test_one_segment_archive_runs_the_fused_step(monkeypatch):
    """``--step-impl kernel`` with one segment integrates a single member,
    so the fused step runs it (its plain version here), within the
    archive limit of the plain engine's archive."""
    from dlwp_torch.barotropic import fused_step

    calls = []
    real = fused_step.run_fused
    monkeypatch.setattr(fused_step, "run_fused",
                        lambda *a: calls.append(a[2]) or real(*a))
    mod = port("make_barotropic_archive")
    args = ["--years", "0.01", "--nlat", "19", "--nlon", "36",
            "--truncation", "12", "--device", "cpu"]
    series = {}
    for impl in ("plain", "kernel"):
        a = mod.parse_args(args + ["--step-impl", impl])
        src = mod.archive_source(a)
        series[impl] = mod.write_archive(a, src, None).predictors
        assert src.n_segments == 1
    assert calls[0] == 96 and set(calls[1:]) == {12}  # 2 d spin-up, 6 h
    want = series["plain"]
    np.testing.assert_allclose(series["kernel"], want, rtol=0,
                               atol=TOL_ARCHIVE * np.abs(want).max())


RUN_BAROTROPIC = ["--hours", "12", "--n-init", "1"]


@pytest.fixture(scope="module")
def jax_barotropic_run(tmp_path_factory):
    """The JAX ``run_barotropic``'s file for :data:`RUN_BAROTROPIC`, run
    once for both of the port's step implementations."""
    path = tmp_path_factory.mktemp("run_barotropic") / "j.h5"
    run_jax("run_barotropic", RUN_BAROTROPIC + ["--output-file", str(path)])
    return path


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_run_barotropic_matches_jax(impl, jax_barotropic_run, tmp_path):
    """One init time, 12 hours at T42 on 73x144; 'kernel' is the fused
    step's plain version here, one member."""
    import h5py

    _, out = run_port("run_barotropic", RUN_BAROTROPIC + [
        "--device", "cpu", "--step-impl", impl,
        "--output-file", str(tmp_path / "p.h5")])
    assert "integrated 1 x 24 steps" in out and "saved" in out
    with h5py.File(tmp_path / "p.h5") as fp, h5py.File(
            jax_barotropic_run) as fj:
        assert sorted(fp) == sorted(fj)
        for k in ("f_hour", "lat", "lon", "init_time"):
            np.testing.assert_array_equal(fp[k][:], fj[k][:])
        z, zj = fp["z"][:], fj["z"][:]
    assert z.shape == zj.shape == (2, 1, 73, 144) and z.dtype == np.float32
    np.testing.assert_allclose(z, zj, rtol=TOL_BARO)


@pytest.fixture(scope="module")
def jax_model(pfile, tmp_path_factory):
    """A small model trained (1 epoch) and saved by the JAX package on the
    pole-cropped grid with insolation, and its copy in the port
    (``load_flax_params``), saved by the port."""
    d = tmp_path_factory.mktemp("jax_model")
    data = JDataset.from_file(pfile)
    data.predictors = np.asarray(data.predictors)[..., 1:, :]
    data.lat = data.lat[1:]
    specs = [("CyclicConv2D", (8, 3), {"activation": "tanh"}),
             ("CyclicConv2D", (4, 3), {})]
    jnet = JNet(is_convolutional=True, time_dim=2, scaler_type=None)
    sampler = JSeriesSampler(data, model=jnet, input_time_steps=2,
                             output_time_steps=2, add_insolation=True,
                             batch_size=64)
    jnet.build_model(specs, seed=0)
    jnet.fit_generator(sampler, epochs=1, verbose=False)
    jax_save_model(jnet, str(d / "jax"))
    jm = jax_load_model(str(d / "jax"))
    net = DLWPNeuralNet(is_convolutional=True, time_dim=2, scaler_type=None,
                        device="cpu")
    net.build_model(specs)
    net.load_flax_params(jax.tree.map(np.asarray, jm.trainer.params))
    net._sample_shape = tuple(jm.input_sample_shape)
    save_model(net, str(d / "port"))
    return str(d / "jax"), str(d / "port")


@pytest.mark.parametrize("form", ["psi", "vrt"])
def test_validate_matches_jax(pfile, jax_model, form, tmp_path):
    """The JAX model carried across, validated by both scripts: auto pole
    crop and insolation, the forecast, persistence, climatology and
    barotropic rows, the JSON artifact."""
    import json

    common = ["--predictor-file", pfile, "--forecast-steps", "2",
              "--barotropic-form", form]
    got, out = run_port("validate", common + [
        "--model-file", jax_model[1], "--device", "cpu",
        "--plot-file", str(tmp_path / "p.png"),
        "--output-file", str(tmp_path / "p.pkl"),
        "--emit-json", str(tmp_path / "p.json")])
    want, jout = run_jax("validate", common + [
        "--model-file", jax_model[0],
        "--plot-file", str(tmp_path / "j.png"),
        "--output-file", str(tmp_path / "j.pkl"),
        "--emit-json", str(tmp_path / "j.json")])
    for line in ("auto: cropping the 90N row",
                 "auto: model was trained with an insolation channel",
                 "monthly climatology baseline skipped",
                 "RMSE vs forecast hour"):
        assert line in out and line in jout
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["f_hour"], want["f_hour"])
    for key in ("persistence_rmse", "climatology_rmse"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL_BASE_ROWS)
    np.testing.assert_allclose(got["forecast_rmse"], want["forecast_rmse"],
                               rtol=TOL_FORECAST_ROW)
    np.testing.assert_allclose(got["barotropic_rmse"],
                               want["barotropic_rmse"], rtol=TOL_BARO_ROW)
    pj = json.loads((tmp_path / "p.json").read_text())
    jj = json.loads((tmp_path / "j.json").read_text())
    assert pj["config_hash"] != "" and pj["n_init_times"] == jj["n_init_times"]
    assert pj["rmse"].keys() == jj["rmse"].keys()
    assert (tmp_path / "p.png").exists() and (tmp_path / "p.pkl").exists()

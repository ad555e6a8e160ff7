"""Rules of the port: no JAX inside it, CUDA by default, and a bf16-gate
serving estimator that leaves the caller's model as it was."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import dlwp_torch
from dlwp_torch import (
    BarotropicModelPsi,
    DLWPNeuralNet,
    LatLonGrid,
    PredictorDataset,
    SeriesSampler,
    TimeSeriesEstimator,
    build_sequential,
)
from dlwp_torch.device import resolve_device
from dlwp_torch.entry import entry as port_entry
from dlwp_torch.flagship import convlstm_specs
from dlwp_torch.parallel import MeshConfig, SpatialSharding, build_mesh
from dlwp_torch.serve import Servable, export_program

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
# The JAX package and its scripts: ``examples/``'s modules, its
# ``_synthetic`` and ``_path`` (the port keeps its own copies).
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dlwp_tpu", "__graft_entry__",
             "examples", "_synthetic", "_path"}


def _port_files():
    return sorted((ROOT / "dlwp_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_package_found_its_files():
    assert len(_port_files()) > 15
    assert pathlib.Path(dlwp_torch.__file__).parent == ROOT / "dlwp_torch"


def _cpu_test_files():
    return [p for p in sorted((ROOT / "tests").glob("test_torch_port_*.py"))
            if not p.stem.endswith("_cuda")]


@pytest.mark.parametrize("path", _cpu_test_files(), ids=lambda p: p.stem)
def test_port_test_file_holds_blas_to_one_thread(path):
    """Every port test file but the card-only ones imports the fixture of
    ``tests/torch_port_threads.py``: one that leaves it out runs its BLAS
    on every core of every worker, and the suite slows down unseen."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assert any(isinstance(node, ast.ImportFrom)
               and node.module == "tests.torch_port_threads"
               and [a.name for a in node.names] == ["one_blas_thread"]
               for node in tree.body), path


@pytest.mark.parametrize("entry", ["resolve_device", "build_sequential",
                                   "DLWPNeuralNet", "BarotropicModelPsi",
                                   "build_mesh", "Servable.load", "entry"])
def test_default_device_is_cuda_and_raises_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "resolve_device":
            resolve_device()
        elif entry == "Servable.load":
            Servable.load(export_program(lambda a: a + 1.0, (torch.ones(2),),
                                         batch=None).serialize())
        elif entry == "entry":
            port_entry()
        elif entry == "build_mesh":
            build_mesh(MeshConfig(data=1, lat=2))
        elif entry == "build_sequential":
            build_sequential(convlstm_specs(8, 16))
        elif entry == "BarotropicModelPsi":
            BarotropicModelPsi(LatLonGrid.regular(19, 36), 12, dt=1800.0)
        else:
            DLWPNeuralNet(is_recurrent=True)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_device_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device() == torch.device("cuda")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _recurrent_stack(fuse, mesh=None):
    rng = np.random.RandomState(0)
    n = 12
    data = PredictorDataset(
        predictors=rng.randn(n, 2, 8, 16).astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, 8), lon=np.arange(16) * 22.5,
    )
    net = DLWPNeuralNet(time_dim=2, is_recurrent=True, scaler_type=None,
                        device="cpu")
    net.build_model(convlstm_specs(8, 16), fuse=fuse, mesh=mesh,
                    batch_spec=("data", None, None, "lat", None),
                    spatial_impl="overlap")
    sampler = SeriesSampler(data, model=net, input_time_steps=2,
                            output_time_steps=2, add_insolation=True)
    net.init(sampler.generate(np.arange(1))[0], seed=0)
    return net, sampler


@pytest.mark.parametrize("fuse,sharded", [(True, False), (False, False),
                                          (True, True)],
                         ids=["True", "False", "sharded"])
def test_gate_dtype_rebuild_keeps_caller_model_and_build_config(fuse,
                                                                sharded):
    mesh = (build_mesh(MeshConfig(data=1, lat=2),
                       devices=[torch.device("cpu")] * 2) if sharded
            else None)
    net, sampler = _recurrent_stack(fuse, mesh)
    specs_before = [tuple(s) for s in net.layer_specs]
    base_before = net.base_model
    params_before = dict(net.base_model.named_parameters())
    fc32 = TimeSeriesEstimator(net, sampler).predict(3, samples=[0, 1])

    est16 = TimeSeriesEstimator(net, sampler, gate_dtype="bfloat16")
    served = est16.model
    assert served is not net and served.base_model is not base_before
    assert served.base_model.layers[0].gate_dtype == torch.bfloat16
    config = {"fuse": fuse}
    if sharded:
        config.update(mesh=mesh, batch_spec=("data", None, None, "lat", None),
                      spatial_impl="overlap")
        spatial = served._spatial
        assert isinstance(spatial, SpatialSharding) and spatial.mesh is mesh
        assert spatial.impl == "overlap" and spatial.lat_axis == "lat"
        assert served.base_model.layers[0].spatial is spatial
    assert served._build_config == net._build_config == config
    assert ([type(l) for l in served.base_model.layers]
            == [type(l) for l in base_before.layers])
    assert served.device == net.device
    served_params = dict(served.base_model.named_parameters())
    assert all(served_params[k] is p for k, p in params_before.items())
    # the caller's model is untouched
    assert net.base_model is base_before
    assert [tuple(s) for s in net.layer_specs] == specs_before
    assert net.base_model.layers[0].gate_dtype is None
    assert all("gate_dtype" not in (s[2] or {}) for s in net.layer_specs)

    fc16 = est16.predict(3, samples=[0, 1])
    scale = np.sqrt(np.mean(fc32.values ** 2))
    dev = np.sqrt(np.mean((fc16.values - fc32.values) ** 2))
    assert 0 < dev < 0.05 * scale, (dev, scale)
    again = TimeSeriesEstimator(net, sampler).predict(3, samples=[0, 1])
    np.testing.assert_array_equal(again.values, fc32.values)

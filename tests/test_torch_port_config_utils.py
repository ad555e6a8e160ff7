"""The port's experiment config and host utilities against the JAX package's.

- ``ExperimentConfig.to_json()`` is the same string in both packages for
  the same config, and each package reads the other's JSON; unknown
  fields raise.
- ``TensorBoardWriter`` writes the same bytes as the JAX package's for the
  same events at the same wall time.
- ``ThroughputMeter``'s arithmetic is the JAX package's; the reflection
  helpers return the same objects.
- ``profiling.trace`` writes a Chrome trace; ``StepTimer`` on the CPU times
  with the host clock (on the card with CUDA events: see
  ``tests/test_torch_port_cuda.py``).
"""

import json
import os

import pytest
import torch

import dlwp_tpu.config as jcfg
import dlwp_tpu.utils.reflection as jrefl
import dlwp_tpu.utils.tensorboard as jtb
from dlwp_tpu.parallel.mesh import MeshConfig as JaxMesh
from dlwp_tpu.train import TrainConfig as JaxTrain
from dlwp_tpu.utils.profiling import ThroughputMeter as JaxMeter

import dlwp_torch.config as tcfg
import dlwp_torch.utils.reflection as trefl
import dlwp_torch.utils.tensorboard as ttb
from dlwp_torch.parallel.mesh import MeshConfig
from dlwp_torch.train import TrainConfig
from dlwp_torch.utils import profiling

torch.set_num_threads(2)


def _configs(pkg, mesh_cls, train_cls):
    return {
        "default": pkg.ExperimentConfig(),
        "custom": pkg.ExperimentConfig(
            name="test",
            data=pkg.DataConfig(input_time_steps=3, batch_size=32,
                                input_sel=("HGT/500", "THICK/300-700")),
            model=pkg.ModelConfig(
                layers=(("CyclicConv2D", (8, 3), {"activation": "tanh"}),
                        ("MaxPooling2D", (2,), None)),
                is_recurrent=True, scaler_type="standard"),
            train=train_cls(loss="mse", learning_rate=2e-3, epochs=5,
                            early_stopping=True, patience=2),
            mesh=mesh_cls(data=2, lat=4),
            checkpoint_dir="ck", seed=3,
        ),
    }


@pytest.mark.parametrize("name", ["default", "custom"])
def test_config_json_equals_jax_and_reads_both_ways(name, tmp_path):
    port = _configs(tcfg, MeshConfig, TrainConfig)[name]
    jax_cfg = _configs(jcfg, JaxMesh, JaxTrain)[name]
    assert port.to_json() == jax_cfg.to_json()
    path = str(tmp_path / "cfg.json")
    jax_cfg.to_json(path)
    back = tcfg.ExperimentConfig.from_json(path)
    assert back.to_json() == port.to_json()
    assert isinstance(back.train, TrainConfig)
    assert isinstance(back.mesh, MeshConfig)
    assert jcfg.ExperimentConfig.from_json(port.to_json()).to_json() == (
        jax_cfg.to_json())


def test_config_unknown_field_and_defaults():
    with pytest.raises(ValueError, match="unknown"):
        tcfg.ExperimentConfig.from_dict({"data": {"bogus_field": 1}})
    cfg = tcfg.ExperimentConfig()
    assert cfg.data.add_insolation is True
    assert cfg.train.optimizer == "adam"
    assert json.loads(cfg.to_json())["mesh"] == {"data": -1, "lat": 1,
                                                  "lon": 1}


def _events(module, logdir, monkeypatch):
    monkeypatch.setattr(module.time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(module.socket, "gethostname", lambda: "host")
    with module.TensorBoardWriter(str(logdir), filename_suffix=".x") as tb:
        tb.scalar("loss", 0.5, step=3)
        tb.scalar("loss", float("nan"), step=4, wall_time=12.5)
        tb(1, {"val_loss": 0.25, "lr": 1e-3})
        tb.log("rmse", 2.0)
        tb.log("rmse", 1.5)
    with open(tb.path, "rb") as f:
        return os.path.basename(tb.path), f.read()


def test_tensorboard_bytes_equal_jax(tmp_path, monkeypatch):
    port = _events(ttb, tmp_path / "port", monkeypatch)
    want = _events(jtb, tmp_path / "jax", monkeypatch)
    assert port == want
    for data in (b"", b"123456789", bytes(range(256))):
        assert ttb.crc32c(data) == jtb.crc32c(data)


@pytest.mark.parametrize("nlat,nlon,chips,batch,steps,seconds", [
    (36, 144, 1, 64, 32, 0.125), (73, 144, 4, 7, 3, 2.5),
    (180, 720, 2, 1, 1, 1e-3)])
def test_throughput_meter_equals_jax(nlat, nlon, chips, batch, steps,
                                     seconds):
    port = profiling.ThroughputMeter(nlat, nlon, chips)
    want = JaxMeter(nlat, nlon, chips)
    assert port.rate(batch, steps, seconds) == want.rate(batch, steps,
                                                         seconds)
    assert port.rate_per_chip(batch, steps, seconds) == (
        want.rate_per_chip(batch, steps, seconds))
    assert port.scaling_efficiency(1e8, 3e8, chips) == (
        want.scaling_efficiency(1e8, 3e8, chips))


def test_reflection_equals_jax():
    for mod in ("json", "dlwp_torch.utils.scaler"):
        assert trefl.get_classes(mod) == jrefl.get_classes(mod)
    assert trefl.get_from_module("os.path", "join") is os.path.join
    assert trefl.get_methods(MeshConfig) == jrefl.get_methods(MeshConfig)
    with pytest.raises(AttributeError, match="no attribute"):
        trefl.get_from_module("os", "no_such_name")


def test_trace_writes_chrome_trace_and_timer_on_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        (x @ x).sum()
    assert prof is not None
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    timer = profiling.StepTimer(device="cpu")
    for _ in range(3):
        timer.start()
        timer.stop(x @ x)
    assert len(timer.times) == 3 and 0 <= timer.best <= timer.mean

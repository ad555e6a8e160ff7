"""Typed experiment configuration (own copy of the JAX package's
``config`` module).

Nested frozen dataclasses for a training run -- data selection, model
architecture, training, mesh layout -- that serialize to and from JSON.
The JSON is the JAX package's, field for field, so each package reads the
other's files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from dlwp_torch.parallel.mesh import MeshConfig
from dlwp_torch.train.trainer import TrainConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Predictor-file and sampler selection."""

    predictor_file: str = ""
    input_sel: tuple[str, ...] | None = None
    output_sel: tuple[str, ...] | None = None
    input_time_steps: int = 2
    output_time_steps: int = 2
    sequence: int | None = None
    interval: int = 1
    add_insolation: bool = True
    batch_size: int = 64
    shuffle: bool = True
    validation_fraction: float = 0.2
    crop_north_pole: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Declarative architecture: layer specs as data."""

    layers: tuple = ()
    is_convolutional: bool = True
    is_recurrent: bool = False
    scaler_type: str | None = None
    impute_missing: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Everything needed to reproduce a training run."""

    name: str = "dlwp"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    model_file: str = "dlwp_model"
    checkpoint_dir: str | None = None
    seed: int = 0

    # ------------------------------------------------------------------ I/O
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str | None = None) -> str:
        def default(o):
            if callable(o):
                return getattr(o, "__name__", str(o))
            return str(o)

        s = json.dumps(self.to_dict(), indent=2, default=default)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        def build(klass, sub):
            fields = {f.name for f in dataclasses.fields(klass)}
            kw = {}
            for k, v in sub.items():
                if k not in fields:
                    raise ValueError(
                        f"unknown {klass.__name__} field {k!r}"
                    )
                kw[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v) \
                    if isinstance(v, list) and k == "layers" else v
            return klass(**kw)

        d = dict(d)
        kw: dict[str, Any] = {}
        if "data" in d:
            kw["data"] = build(DataConfig, d.pop("data"))
        if "model" in d:
            kw["model"] = build(ModelConfig, d.pop("model"))
        if "train" in d:
            kw["train"] = build(TrainConfig, d.pop("train"))
        if "mesh" in d:
            kw["mesh"] = build(MeshConfig, d.pop("mesh"))
        kw.update(d)
        return cls(**kw)

    @classmethod
    def from_json(cls, path_or_str: str) -> "ExperimentConfig":
        try:
            with open(path_or_str) as f:
                d = json.load(f)
        except (FileNotFoundError, OSError):
            d = json.loads(path_or_str)
        return cls.from_dict(d)

"""``DLWPNeuralNet`` and ``DLWPFunctional`` (port of ``dlwp_tpu.models.api``).

Declarative model construction from layer specs, optional feature
scaling/imputation on the host, training through
:class:`~dlwp_torch.train.trainer.Trainer` (``fit``, ``fit_generator``,
``evaluate``), ``predict`` and the autoregressive ``predict_timeseries``,
and pickling without the model (:mod:`dlwp_torch.utils.serialization`).
Forecasts with insolation run through
:class:`dlwp_torch.forecast.TimeSeriesEstimator`.
"""

from __future__ import annotations

import dataclasses
import inspect
import pickle
import warnings
from typing import Any, Callable, Sequence

import numpy as np
import torch

from dlwp_torch.device import resolve_device
from dlwp_torch.models.cnn import build_sequential
from dlwp_torch.models.layers import ConvLSTM2D
from dlwp_torch.parallel.spatial import SpatialSharding
from dlwp_torch.train.trainer import TrainConfig, Trainer
from dlwp_torch.utils.scaler import SCALERS, MeanImputer
from dlwp_torch.weights import flax_tree, load_flax_params


def shape_series(ts, time_dim, feature_shape, step_sequence=False,
                 keep_time_dim=False):
    """The reference's rollout output shaping of a raw prediction series
    ``(n_iter, batch) + ...``: split out the ``time_dim`` steps of each
    iteration and, unless ``keep_time_dim``, lay them along the first axis
    (or keep each iteration's first step, with ``step_sequence``)."""
    ts = np.asarray(ts)
    n_iter, b = ts.shape[:2]
    td = time_dim
    ts = ts.reshape((n_iter, b, td, -1) + tuple(feature_shape[1:]))
    if not keep_time_dim:
        if step_sequence:
            ts = ts[:, :, 0]
        else:
            ts = ts.transpose(
                (0, 2, 1) + tuple(range(3, 3 + len(feature_shape))))
            ts = ts.reshape((n_iter * td, b, -1) + tuple(feature_shape[1:]))
    return ts


_RECURRENT_ACTIVATION = inspect.signature(ConvLSTM2D).parameters[
    "recurrent_activation"].default


class DLWPNeuralNet:
    """Recurrent models take (B, time_dim, C, H, W), convolutional ones
    (B, time_dim*C, H, W). Runs on ``device`` (default ``cuda``; raises
    without a card unless ``device='cpu'``)."""

    _UNPICKLABLE = "<<unpicklable>>"

    def __init__(
        self,
        is_convolutional: bool = True,
        is_recurrent: bool = False,
        time_dim: int = 1,
        scaler_type: str | None = "standard",
        scale_targets: bool = True,
        impute_missing: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.is_convolutional = is_convolutional
        self.is_recurrent = is_recurrent
        self.time_dim = time_dim
        self.scaler_type = scaler_type
        self.scale_targets = scale_targets
        self.impute = impute_missing
        self.scaler = None
        self.scaler_y = None
        self.imputer = None
        self.layer_specs: Sequence | None = None
        self.base_model = None
        self.trainer: Trainer | None = None
        self._train_config: TrainConfig | None = None
        self._sample_shape: tuple | None = None
        self._build_config: dict = {}
        self._spatial = None

    # ------------------------------------------------------------- building
    def build_model(
        self,
        layers: Sequence,
        loss: Any = "mse",
        optimizer: Any = "adam",
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        metrics: dict[str, Callable] | None = None,
        sequence_steps: int = 1,
        splice_fn: Callable | None = None,
        mesh=None,
        batch_spec=None,
        target_spec=None,
        spatial_impl: str = "ppermute",
        fuse: bool = True,
        **train_kwargs,
    ) -> None:
        """Build the model from layer specs and its trainer; parameters
        come from :meth:`init`, :meth:`load_flax_params` or the first
        ``fit``.

        ``loss``, ``optimizer`` (a name of
        :data:`~dlwp_torch.train.optim.OPTIMIZERS` or a callable ``params ->
        torch.optim.Optimizer``), ``learning_rate``, ``weight_decay``,
        ``sequence_steps`` and ``train_kwargs`` fill the
        :class:`~dlwp_torch.train.trainer.TrainConfig`; ``splice_fn``
        feeds predictions back in sequence training.

        ``mesh`` (a :class:`~dlwp_torch.parallel.mesh.Mesh`) with a
        ``batch_spec`` such as ``("data", None, None, "lat", None)``
        shards latitude bands: the first axis named after the batch that
        has more than one shard on the mesh is the lat axis, a second one
        the lon axis (lat x lon tiles), and every spherical conv takes the
        sharded path of ``spatial_impl`` ('ppermute', 'pallas' or
        'overlap'). Activations stay global tensors on this model's device
        between layers. Such a model predicts and trains; ``target_spec``
        names the target's axes for the trainer (default: ``batch_spec``,
        shifted for sequence training), and :meth:`fit` drops a batch
        that does not divide over the data shards."""
        self.layer_specs = layers
        self._build_config = {"fuse": fuse}
        if mesh is not None:
            self._build_config.update(mesh=mesh, batch_spec=batch_spec,
                                      spatial_impl=spatial_impl)
            if target_spec is not None:
                self._build_config["target_spec"] = target_spec
        spatial = None
        if mesh is not None and batch_spec is not None:
            lat_axes = [a for a in tuple(batch_spec)[1:]
                        if a is not None and mesh.shape.get(a, 1) > 1]
            if lat_axes:
                spatial = SpatialSharding(
                    mesh=mesh,
                    data_axis=tuple(batch_spec)[0],
                    lat_axis=lat_axes[0],
                    lon_axis=lat_axes[1] if len(lat_axes) > 1 else None,
                    impl=spatial_impl,
                )
        self._spatial = spatial
        self.base_model = build_sequential(layers, spatial=spatial,
                                           fuse=fuse, device=self.device)
        self._train_config = TrainConfig(
            loss=loss, optimizer=optimizer, learning_rate=learning_rate,
            weight_decay=weight_decay, sequence_steps=sequence_steps,
            **train_kwargs,
        )
        self.trainer = Trainer(
            self.base_model, self._train_config, splice_fn=splice_fn,
            mesh=mesh, batch_spec=batch_spec, target_spec=target_spec,
            metrics=metrics,
        )

    @property
    def model(self):
        return self.base_model

    def init(self, sample, seed: int = 0) -> "DLWPNeuralNet":
        """Random parameters for inputs shaped like ``sample`` (a batch;
        only its first item is run)."""
        x = torch.as_tensor(np.asarray(sample)[:1], dtype=torch.float32)
        self.base_model.init(x, seed=seed)
        return self

    def load_flax_params(self, params, dtype=torch.float32) -> None:
        """Load a flax-layout tree; a trainer starts a fresh optimizer over
        the new parameters at its next ``fit``."""
        load_flax_params(self.base_model, params, dtype=dtype)
        if self.trainer is not None:
            self.trainer.optimizer = None

    # ------------------------------------------------------------- scaling
    def scaler_fit(self, X, y=None, **kwargs):
        scaler_cls = SCALERS[self.scaler_type]
        if scaler_cls is None:
            return self
        self.scaler = scaler_cls(**kwargs).fit(X)
        self.scaler_y = (scaler_cls(**kwargs).fit(y) if y is not None
                         else self.scaler)
        return self

    def scaler_transform(self, X, y=None):
        if self.scaler is None:
            return X if y is None else (X, y)
        Xs = self.scaler.transform(X)
        return Xs if y is None else (Xs, self.scaler_y.transform(y))

    def imputer_fit(self, X):
        self.imputer = MeanImputer().fit(X)
        return self

    def imputer_transform(self, X, y=None):
        if self.imputer is None:
            return X if y is None else (X, y)
        Xi = self.imputer.transform(X)
        return Xi if y is None else (Xi, self.imputer.transform(y))

    # ------------------------------------------------------------- training
    def init_fit(self, predictors, targets):
        """Fit the scaler (and imputer) before training."""
        if self.impute:
            self.imputer_fit(predictors)
            predictors = self.imputer_transform(predictors)
        self.scaler_fit(predictors, targets)
        return self

    def fit(self, predictors, targets, validation_data=None, **kwargs):
        """Train on arrays, scaled (and imputed) as the model says;
        ``kwargs`` go to :meth:`Trainer.fit`."""
        if self.impute:
            predictors, targets = self.imputer_transform(predictors, targets)
        x, y = self.scaler_transform(predictors, targets)
        self._sample_shape = tuple(np.shape(x)[1:])
        val = None
        if validation_data is not None:
            val = validation_data
            if self.impute:
                val = self.imputer_transform(*val)
            val = self.scaler_transform(*val)
        return self.trainer.fit(x=x, y=y, validation_data=val, **kwargs)

    def fit_generator(self, generator, validation_data=None, **kwargs):
        """Train from a batch generator that yields scaled batches (as
        :class:`~dlwp_torch.data.sampler.SeriesSampler` does)."""
        shape = getattr(generator, "convolution_shape", None)
        if shape is not None:
            self._sample_shape = tuple(shape)
        return self.trainer.fit(generator=generator,
                                validation_data=validation_data, **kwargs)

    @property
    def input_sample_shape(self) -> tuple | None:
        """Per-sample input shape seen at fit time (None before training),
        kept when the model is saved."""
        return self._sample_shape

    def evaluate(self, predictors, targets, **kwargs):
        """Scaled evaluation: :meth:`Trainer.evaluate` on arrays."""
        if self.impute:
            predictors, targets = self.imputer_transform(predictors, targets)
        x, y = self.scaler_transform(predictors, targets)
        return self.trainer.evaluate((x, y), **kwargs)

    # ------------------------------------------------------------ inference
    def _param_dtype(self):
        return next(self.base_model.parameters()).dtype

    def predict(self, predictors, batch_size: int | None = None) -> np.ndarray:
        """Predict with scaling and inverse target scaling (host numpy in
        and out), ``batch_size`` samples per model call."""
        if self.impute:
            predictors = self.imputer_transform(predictors)
        x = np.asarray(self.scaler_transform(predictors))
        dtype = self._param_dtype()
        bs = batch_size or len(x)
        outs = []
        with torch.inference_mode():
            for i in range(0, len(x), bs):
                xb = torch.as_tensor(x[i:i + bs], dtype=dtype,
                                     device=self.device)
                outs.append(self.base_model(xb).cpu().numpy())
        pred = np.concatenate(outs)
        if (self.scale_targets and self.scaler_type is not None
                and self.scaler_y is not None):
            return self.scaler_y.inverse_transform(pred)
        return pred

    def rollout_fn(self, time_steps: int, step_sequence: bool = False):
        """``(fn, n_iter)``: ``fn`` maps a scaled predictor batch (a tensor
        on the device) to the raw prediction series ``(n_iter, batch,
        ...)``. Each iteration predicts and either replaces the whole state
        by the prediction (default) or advances a sliding window one time
        step (``step_sequence``)."""
        time_steps = int(time_steps)
        if time_steps < 1:
            raise ValueError("time_steps must be an int > 0")
        n_iter = (time_steps if step_sequence
                  else int(np.ceil(time_steps / self.time_dim)))
        if self.trainer is None or self.trainer.params is None:
            raise ValueError(
                "model has no parameters yet; call fit(), init() or "
                "load_flax_params() before building a rollout")
        td, is_recurrent, net = self.time_dim, self.is_recurrent, self.base_model

        @torch.inference_mode()
        def fn(x):
            out = []
            for _ in range(n_iter):
                pred = net(x)
                out.append(pred)
                if not step_sequence:
                    x = pred
                elif is_recurrent:
                    x = torch.cat([x[:, 1:], pred[:, :1]], dim=1)
                else:
                    b = x.shape[0]
                    pr = pred.reshape((b, td, pred.shape[1] // td)
                                      + tuple(pred.shape[2:]))
                    pt = x.reshape((b, td, x.shape[1] // td)
                                   + tuple(x.shape[2:]))
                    x = torch.cat([pt[:, 1:], pr[:, :1]], dim=1).reshape(
                        x.shape)
            return torch.stack(out)

        return fn, n_iter

    def predict_timeseries(self, predictors, time_steps: int,
                           step_sequence: bool = False,
                           keep_time_dim: bool = False):
        """Autoregressive rollout, shaped (time_steps[, time_dim], sample,
        ...) by :func:`shape_series`."""
        if self.impute:
            predictors = self.imputer_transform(predictors)
        x0 = torch.as_tensor(np.asarray(self.scaler_transform(
            np.asarray(predictors))), dtype=self._param_dtype(),
            device=self.device)
        feature_shape = x0.shape[2:] if self.is_recurrent else x0.shape[1:]
        fn, _ = self.rollout_fn(time_steps, step_sequence)
        ts = fn(x0).cpu().numpy()
        if (self.scale_targets and self.scaler_type is not None
                and self.scaler_y is not None):
            ts = self.scaler_y.inverse_transform(ts)
        return shape_series(ts, self.time_dim, feature_shape, step_sequence,
                            keep_time_dim)

    # -------------------------------------------------------- persistence
    def __getstate__(self):
        """The wrapper without its model, trainer and mesh: weights as a
        flax-style tree of numpy arrays (``_params``), the device by name,
        ConvLSTM2D's ``recurrent_activation`` default written into the
        specs, and a loss or optimizer that does not pickle replaced by a
        marker (reloading warns and takes the defaults)."""
        state = dict(self.__dict__)
        specs = state.get("layer_specs")
        if specs is not None:
            baked = []
            for spec in specs:
                if (not isinstance(spec, (list, tuple)) or len(spec) != 3
                        or spec[0] != "ConvLSTM2D"):
                    baked.append(spec)
                    continue
                name, args, kwargs = spec
                kwargs = dict(kwargs or {})
                kwargs.setdefault("recurrent_activation", _RECURRENT_ACTIVATION)
                baked.append((name, args, kwargs))
            state["layer_specs"] = (type(specs)(baked)
                                    if isinstance(specs, (list, tuple))
                                    else baked)
        state["_params"] = (flax_tree(self.base_model)
                            if self.trainer is not None
                            and self.trainer.params is not None else None)
        for key in ("base_model", "trainer", "_spatial"):
            state.pop(key, None)
        state["device"] = str(self.device)
        state["_build_config"] = {"fuse": self._build_config.get("fuse", True)}
        cfg = state.get("_train_config")
        if cfg is not None:
            repl = {}
            for field in ("loss", "optimizer"):
                try:
                    pickle.dumps(getattr(cfg, field))
                except Exception:
                    repl[field] = self._UNPICKLABLE
            if repl:
                state["_train_config"] = dataclasses.replace(cfg, **repl)
        return state

    def __setstate__(self, state):
        state = dict(state)
        params = state.pop("_params", None)
        self._sample_shape = state.pop("_sample_shape", None)
        device = state.pop("device", None)
        self.__dict__.update(state)
        self.device = resolve_device(device)
        self.base_model = None
        self.trainer = None
        self._spatial = None
        if self.layer_specs is None:
            return
        self.base_model = build_sequential(
            self.layer_specs, fuse=self._build_config.get("fuse", True),
            device=self.device)
        cfg = self._train_config or TrainConfig()
        repl = {field: default
                for field, default in (("loss", "mse"), ("optimizer", "adam"))
                if getattr(cfg, field, None) == self._UNPICKLABLE}
        if repl:
            warnings.warn(
                f"saved model used non-picklable {sorted(repl)}; restored "
                f"with defaults {repl}: inference is exact, but to resume "
                "training with the original loss or optimizer pass them to "
                "build_model again", stacklevel=2)
            cfg = dataclasses.replace(cfg, **repl)
        self._train_config = cfg
        self.trainer = Trainer(self.base_model, cfg)
        if params is not None:
            leaf = next(iter(next(iter(params["params"].values())).values()))
            load_flax_params(self.base_model, params,
                             dtype=torch.from_numpy(np.asarray(leaf)).dtype)


class DLWPFunctional(DLWPNeuralNet):
    """Multi-step ("functional") model API: the reference trains a
    multi-output graph whose outputs are successive rollout steps; here it
    is the one model trained with a ``sequence_steps`` rollout loss. No
    scaling or imputing, and sequence training on by default."""

    def __init__(self, is_convolutional=True, is_recurrent=False, time_dim=1,
                 device=None):
        super().__init__(
            is_convolutional=is_convolutional, is_recurrent=is_recurrent,
            time_dim=time_dim, scaler_type=None, impute_missing=False,
            device=device,
        )
        self._n_steps = 1

    def build_model(self, layers, sequence_steps: int = 2, **kwargs):
        super().build_model(layers, sequence_steps=sequence_steps, **kwargs)
        self._n_steps = sequence_steps

    def predict_sequence(self, predictors, **kwargs):
        """(n_steps * time_dim, sample, ...) by rolling the model."""
        return self.predict_timeseries(
            predictors, self._n_steps * self.time_dim, **kwargs)


__all__ = ["DLWPFunctional", "DLWPNeuralNet", "shape_series"]

"""``DLWPNeuralNet``, inference surface (port of ``dlwp_tpu.models.api``).

Declarative model construction from layer specs, optional feature
scaling/imputation on the host, and ``predict``. Training, persistence and
the bare rollout come with the training slice; forecasts run through
:class:`dlwp_torch.forecast.TimeSeriesEstimator`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dlwp_torch.device import resolve_device
from dlwp_torch.models.cnn import build_sequential
from dlwp_torch.parallel.spatial import SpatialSharding
from dlwp_torch.utils.scaler import SCALERS, MeanImputer
from dlwp_torch.weights import load_flax_params


class DLWPNeuralNet:
    """Recurrent models take (B, time_dim, C, H, W), convolutional ones
    (B, time_dim*C, H, W). Runs on ``device`` (default ``cuda``; raises
    without a card unless ``device='cpu'``)."""

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
        self._build_config: dict = {}
        self._spatial = None

    def build_model(self, layers: Sequence, fuse: bool = True, mesh=None,
                    batch_spec=None, spatial_impl: str = "ppermute") -> None:
        """Build the model from layer specs; parameters come from
        :meth:`init` or :meth:`load_flax_params`.

        ``mesh`` (a :class:`~dlwp_torch.parallel.mesh.Mesh`) with a
        ``batch_spec`` such as ``("data", None, None, "lat", None)``
        shards latitude bands: the first axis named after the batch that
        has more than one shard on the mesh is the lat axis, and every
        spherical conv takes the sharded path of ``spatial_impl``
        ('ppermute', 'pallas' or 'overlap'). Activations stay global
        tensors on this model's device between layers."""
        self.layer_specs = layers
        self._build_config = {"fuse": fuse}
        if mesh is not None:
            self._build_config.update(mesh=mesh, batch_spec=batch_spec,
                                      spatial_impl=spatial_impl)
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
        load_flax_params(self.base_model, params, dtype=dtype)

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

    # ------------------------------------------------------------ inference
    def predict(self, predictors, batch_size: int | None = None) -> np.ndarray:
        """Predict with scaling and inverse target scaling (host numpy in
        and out), ``batch_size`` samples per model call."""
        if self.impute:
            predictors = self.imputer_transform(predictors)
        x = np.asarray(self.scaler_transform(predictors))
        dtype = next(self.base_model.parameters()).dtype
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

"""Series sampler: predictor series -> (input, target) batches, on the host.

Port of ``dlwp_tpu.data.sampler.SeriesSampler`` (the reference's
``SeriesDataGenerator`` semantics) for the forecast path: input/output
varlev selections, independent input/output time-step counts, ``sequence``
targets, ``interval``, the precomputed insolation channel, NaN-sample
removal and the model's scaler/imputer. Index arithmetic:

    n_sample = N - in_ts - out_ts * seq + 2 - interval
    inputs[i]  = series[i .. i+in_ts-1]
    targets[i, s, n] = series[i + in_ts + interval - 1 + out_ts*s + n]

Epoch iteration and device prefetch belong to the training slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from dlwp_torch.data.dataset import PredictorDataset
from dlwp_torch.grid.insolation import day_of_year, insolation


class SeriesSampler:
    def __init__(
        self,
        data: PredictorDataset,
        model=None,
        input_sel: Sequence[str] | None = None,
        output_sel: Sequence[str] | None = None,
        input_time_steps: int = 1,
        output_time_steps: int = 1,
        sequence: int | None = None,
        interval: int = 1,
        add_insolation: bool = False,
        batch_size: int = 32,
        remove_nan: bool = True,
        is_convolutional: bool | None = None,
        is_recurrent: bool | None = None,
        dtype=np.float32,
    ):
        if input_time_steps < 1 or output_time_steps < 1:
            raise ValueError("time step counts must be >= 1")
        if batch_size < 1 or interval < 1 or (sequence is not None
                                              and sequence < 1):
            raise ValueError("batch_size, interval and sequence must be >= 1")
        self.data = data
        self.model = model
        self._is_convolutional = (
            is_convolutional if is_convolutional is not None
            else getattr(model, "is_convolutional", True)
        )
        self._keep_time_axis = (
            is_recurrent if is_recurrent is not None
            else getattr(model, "is_recurrent", False)
        )
        self._impute = getattr(model, "impute", False)
        self._in_ts = int(input_time_steps)
        self._out_ts = int(output_time_steps)
        self._sequence = sequence
        self._interval = int(interval)
        self._batch_size = int(batch_size)
        self._remove_nan = remove_nan
        self._dtype = dtype

        arr = np.asarray(data.predictors)
        if data.has_time_step:  # samples-format: last input time step
            arr = arr[:, -1]
        self._series = arr  # (N, V, H, W)
        seq = sequence if sequence is not None else 1
        self._n_sample = (arr.shape[0] - self._in_ts - self._out_ts * seq
                          + 2 - interval)
        if self._n_sample <= 0:
            raise ValueError("series too short for requested configuration")
        self._input_names = list(input_sel) if input_sel else list(data.varlev)
        self._output_names = (list(output_sel) if output_sel
                              else list(data.varlev))
        self._input_idx = data.varlev_index(self._input_names)
        self._output_idx = data.varlev_index(self._output_names)
        self._add_insolation = bool(add_insolation)
        self._insolation = (
            np.asarray(insolation(day_of_year(data.sample), data.lat,
                                  data.lon), dtype=dtype)
            if self._add_insolation else None
        )

    @property
    def shape(self) -> tuple[int, ...]:
        """(time_step, varlev, lat, lon) of inputs without insolation."""
        H, W = self._series.shape[-2:]
        return (self._in_ts, len(self._input_names), H, W)

    @property
    def convolution_shape(self) -> tuple[int, ...]:
        t, c, h, w = self.shape
        c_eff = c + (1 if self._add_insolation else 0)
        if self._keep_time_axis:
            return (t, c_eff, h, w)
        return (t * c_eff, h, w)

    @property
    def output_shape(self) -> tuple[int, ...]:
        H, W = self._series.shape[-2:]
        return (self._out_ts, len(self._output_names), H, W)

    @property
    def output_convolution_shape(self) -> tuple[int, ...]:
        t, c, h, w = self.output_shape
        if self._keep_time_axis:
            return (t, c, h, w)
        return (t * c, h, w)

    def _gather(self, samples, offsets, chan_idx):
        """(B, T, C_sel, H, W) of time-shifted slices."""
        return np.stack(
            [self._series[samples + n][:, chan_idx] for n in offsets], axis=1
        )

    def generate(self, samples=(), scale_and_impute: bool = True,
                 return_indices: bool = False):
        """``(inputs, targets)`` for explicit sample indices (all if empty);
        with ``return_indices`` also the indices that survived NaN
        removal."""
        samples = (np.arange(self._n_sample) if len(samples) == 0
                   else np.asarray(samples, dtype=np.int64))
        B = len(samples)
        p = self._gather(samples, range(self._in_ts),
                         self._input_idx).astype(self._dtype)
        if self._add_insolation:
            sol = np.stack([self._insolation[samples + n]
                            for n in range(self._in_ts)], axis=1)[:, :, None]
            p = np.concatenate([p, sol], axis=2)
        t_start = self._in_ts + self._interval - 1
        seq = self._sequence if self._sequence is not None else 1
        targets = [
            self._gather(
                samples,
                range(t_start + self._out_ts * s,
                      t_start + self._out_ts * (s + 1)),
                self._output_idx,
            ).astype(self._dtype)
            for s in range(seq)
        ]
        if self._remove_nan:
            bad = np.isnan(p.reshape(B, -1)).any(axis=1)
            for t in targets:
                bad |= np.isnan(t.reshape(B, -1)).any(axis=1)
            if bad.any():
                keep = ~bad
                samples, p = samples[keep], p[keep]
                targets = [t[keep] for t in targets]
                B = len(samples)
        if scale_and_impute and self.model is not None:
            if self._impute and getattr(self.model, "imputer", None) is not None:
                p = self.model.imputer_transform(p)
                targets = [self.model.imputer_transform(t) for t in targets]
            if getattr(self.model, "scaler", None) is not None:
                p = self.model.scaler_transform(p)
                targets = [self.model.scaler_y.transform(t) for t in targets]
        if self._is_convolutional:
            p = p.reshape((B,) + self.convolution_shape)
            targets = [t.reshape((B,) + self.output_convolution_shape)
                       for t in targets]
        elif self._keep_time_axis:
            p = p.reshape(B, self._in_ts, -1)
            targets = [t.reshape(B, self._out_ts, -1) for t in targets]
        else:
            p = p.reshape(B, -1)
            targets = [t.reshape(B, -1) for t in targets]
        y = np.stack(targets, axis=1) if self._sequence is not None else targets[0]
        if return_indices:
            return p, y, samples
        return p, y

    def sample_times(self, samples=None) -> np.ndarray:
        """Initialization times of the samples: the last input step's time."""
        samples = (np.arange(self._n_sample) if samples is None
                   else np.asarray(samples))
        return self.data.sample[samples + self._in_ts - 1]

"""Device-resident series sampling (port of
``dlwp_tpu.data.device_sampler``).

The whole predictor series, and the precomputed insolation, go to the card
once as float32; every batch is then gathered there with index tensors,
so a training epoch has no per-batch host work and no per-batch copy.
:class:`DeviceSeriesSampler` wraps a configured
:class:`~dlwp_torch.data.sampler.SeriesSampler`, whose index arithmetic,
shapes, shuffle and RNG it uses, and serves the same batches (bit for bit:
a gather is a copy). Batches are fixed-size: the ragged last batch is
dropped. ``Trainer.fit`` hands such a sampler to ``Trainer.fit_device``,
which also trains a model built on a mesh from it: the port is one program
over the mesh, so the series stays one global tensor and each sharded conv
cuts its batches into the mesh's blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from dlwp_torch.data.sampler import SeriesSampler
from dlwp_torch.device import resolve_device
from dlwp_torch.parallel.mesh import sharding_device


class DeviceSeriesSampler:
    """On-device batch assembly over a series resident on ``device``
    (default ``cuda``; raises without a card unless ``device='cpu'``).

    The data are used as they are, without the model's scaler, so the
    series must be scaled beforehand; an imputing model is refused, and so
    is a series with NaN unless ``remove_nan`` pre-filtered every window
    that holds one.

    ``sharding``: the mesh a sharded model trains on, as a
    :class:`~dlwp_torch.parallel.mesh.Mesh` or a ``(mesh, axis names)``
    pair (the JAX sampler's ``NamedSharding``). The series then lives on
    ``device``, by default the mesh's first device of this process (the
    model's device when it was built on that mesh's card)."""

    def __init__(self, sampler: SeriesSampler, device=None, sharding=None):
        if sampler._impute and sampler.model is not None:
            raise NotImplementedError(
                "device-resident sampling assumes pre-imputed/scaled data")
        if sharding is not None:
            first = sharding_device(sharding)
            device = first if device is None else device
        self.sharding = sharding
        self.sampler = sampler
        series = np.ascontiguousarray(np.asarray(sampler._series),
                                      dtype=np.float32)
        if np.isnan(series).any() and (not sampler._remove_nan
                                       or sampler._valid is None):
            # NaN rows may only mark window boundaries that the sampler's
            # pre-filter keeps out of every batch.
            raise ValueError(
                "device-resident sampling requires a NaN-free series or a "
                "remove_nan sampler whose window pre-filter excludes every "
                "contaminated window")
        self.device = dev = resolve_device(device)
        self._series = torch.from_numpy(series).to(dev)
        self._sol = (
            torch.from_numpy(np.ascontiguousarray(
                sampler._insolation, dtype=np.float32)).to(dev)
            if sampler._insolation is not None else None)
        s = sampler
        seq = s._sequence if s._sequence is not None else 1
        t_start = s._in_ts + s._interval - 1
        self._in_offsets = torch.arange(s._in_ts, device=dev)
        self._out_offsets = torch.tensor(
            [[t_start + s._out_ts * k + n for n in range(s._out_ts)]
             for k in range(seq)], device=dev)  # (seq, out_ts)
        self._input_idx = torch.as_tensor(s._input_idx, device=dev)
        self._output_idx = torch.as_tensor(s._output_idx, device=dev)
        self._batch = s._batch_size

    # ------------------------------------------------------------- assembly
    def gather(self, samples: torch.Tensor):
        """Window starts ``samples`` (B,), an integer tensor on the device,
        -> ``(x, y)`` as ``SeriesSampler.generate`` builds them: input and
        output channel selections, insolation as the last input channel,
        the (sequence, output step) offsets, and no sequence axis when
        ``sequence`` is None."""
        s = self.sampler
        samples = samples.long()
        B = samples.shape[0]
        H, W = self._series.shape[-2:]

        def take(rows, chans):
            return self._series.index_select(0, rows.reshape(-1)) \
                .index_select(1, chans)

        in_t = samples[:, None] + self._in_offsets  # (B, T)
        p = take(in_t, self._input_idx).reshape(B, s._in_ts, -1, H, W)
        if self._sol is not None:
            sol = self._sol.index_select(0, in_t.reshape(-1))
            p = torch.cat([p, sol.reshape(B, s._in_ts, 1, H, W)], dim=2)
        out_t = samples[:, None, None] + self._out_offsets  # (B, S, O)
        t = take(out_t, self._output_idx)
        p = p.reshape((B,) + s.convolution_shape)
        t = t.reshape((B, out_t.shape[1]) + s.output_convolution_shape)
        if s._sequence is None:
            t = t[:, 0]
        return p, t

    # --------------------------------------------------------------- batches
    @property
    def _index_pool(self) -> np.ndarray:
        """Window starts this sampler may serve: the NaN-window
        pre-filtered set when the series holds markers, else all."""
        s = self.sampler
        return s._valid if s._valid is not None else np.arange(s._n_sample)

    def __len__(self) -> int:
        return len(self._index_pool) // self._batch  # the ragged tail drops

    def __getitem__(self, index: int):
        if index < 0:
            index = len(self) + index
        if not 0 <= index < len(self):
            raise IndexError(index)
        sel = self.sampler._indices[index * self._batch:
                                    (index + 1) * self._batch]
        return self.gather(torch.from_numpy(np.asarray(sel, np.int64))
                           .to(self.device))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
        self.sampler.on_epoch_end()

    @property
    def convolution_shape(self):
        return self.sampler.convolution_shape

    @property
    def output_convolution_shape(self):
        return self.sampler.output_convolution_shape


__all__ = ["DeviceSeriesSampler"]

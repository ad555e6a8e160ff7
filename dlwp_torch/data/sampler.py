"""Series sampler: predictor series -> (input, target) batches, on the host.

Port of ``dlwp_tpu.data.sampler`` (the reference's
``SeriesDataGenerator`` semantics): input/output varlev selections,
independent input/output time-step counts, ``sequence`` targets (B, S,
...), ``interval``, the precomputed insolation channel, per-epoch
shuffling from ``np.random.RandomState(seed)``, NaN-window removal and the
model's scaler/imputer. Index arithmetic:

    n_sample = N - in_ts - out_ts * seq + 2 - interval
    inputs[i]  = series[i .. i+in_ts-1]
    targets[i, s, n] = series[i + in_ts + interval - 1 + out_ts*s + n]

A series read lazily from a predictor file (``from_file(load='lazy')``)
stays on disk: the NaN scan reads it in chunks and each batch reads its
rows. An in-memory float32 series is gathered by the native batch gather
(:mod:`dlwp_torch.data.native`). :class:`SamplesSampler` batches a
samples-format dataset with explicit targets; :func:`device_prefetch`
copies batches onto the card ahead of the step that uses them.
"""

from __future__ import annotations

import queue
import threading
from typing import Sequence

import numpy as np
import torch

from dlwp_torch.data import native
from dlwp_torch.data.dataset import PredictorDataset
from dlwp_torch.device import resolve_device
from dlwp_torch.grid.insolation import day_of_year, insolation
from dlwp_torch.parallel.mesh import sharding_device

# Rows of the series that the NaN scan reads at a time.
NAN_SCAN_ROWS = 4096


class _EpochBatches:
    """The epoch protocol the samplers share, as the JAX samplers keep it:
    batches are slices of ``_indices`` (the subclass's
    ``_base_indices()``, shuffled by the sampler's own ``_rng`` when
    ``_shuffle`` is on), ``generate`` assembles each, and the end of an
    iteration reshuffles."""

    def _base_indices(self) -> np.ndarray:
        raise NotImplementedError

    def on_epoch_end(self):
        self._indices = self._base_indices()
        if self._shuffle:
            self._rng.shuffle(self._indices)

    def __len__(self) -> int:
        return int(np.ceil(len(self._indices) / self._batch_size))

    def __getitem__(self, index: int):
        if index < 0:
            index = len(self) + index
        if not 0 <= index < len(self):
            raise IndexError(index)
        sel = self._indices[index * self._batch_size:
                            (index + 1) * self._batch_size]
        return self.generate(sel)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
        self.on_epoch_end()


class SeriesSampler(_EpochBatches):
    """Batched (input, target) sampler over a continuous series.

    Iterating it yields the batches of one epoch in the order of
    ``_indices`` and then calls :meth:`on_epoch_end`, which reshuffles
    with the sampler's own ``RandomState(seed)`` when ``shuffle`` is on.
    With ``remove_nan``, windows whose selected inputs or targets hold a
    NaN are dropped once at construction, so every batch is full-size."""

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
        shuffle: bool = False,
        remove_nan: bool = True,
        is_convolutional: bool | None = None,
        is_recurrent: bool | None = None,
        seed: int = 0,
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
        self._shuffle = shuffle
        self._remove_nan = remove_nan
        self._rng = np.random.RandomState(seed)
        self._dtype = dtype

        # A lazy (h5py) series stays on disk: batches read their rows.
        arr = data.predictors
        if data.has_time_step:  # samples-format: last input time step
            arr = np.asarray(arr)[:, -1]
        self._series = arr  # (N, V, H, W), numpy or h5py
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
        self._valid = self._valid_windows() if remove_nan else None
        self.on_epoch_end()

    def _valid_windows(self):
        """Window starts whose selected input channels and target channels
        hold no NaN (the joint criterion of :meth:`generate`), or None when
        every window is valid. The series is scanned in chunks of
        ``NAN_SCAN_ROWS`` rows, so a lazy one is read a chunk at a time."""
        N = self._series.shape[0]
        row_in = np.zeros(N, dtype=np.int64)
        row_out = np.zeros(N, dtype=np.int64)
        for i in range(0, N, NAN_SCAN_ROWS):
            nan = np.isnan(np.asarray(self._series[i:i + NAN_SCAN_ROWS]))
            n = len(nan)
            row_in[i:i + n] = nan[:, self._input_idx].reshape(n, -1).any(1)
            row_out[i:i + n] = nan[:, self._output_idx].reshape(n, -1).any(1)
        if not (row_in.any() or row_out.any()):
            return None
        cs_in = np.concatenate([[0], np.cumsum(row_in)])
        cs_out = np.concatenate([[0], np.cumsum(row_out)])
        idx = np.arange(self._n_sample)
        in_ok = (cs_in[idx + self._in_ts] - cs_in[idx]) == 0
        t0 = self._in_ts + self._interval - 1
        seq = self._sequence if self._sequence is not None else 1
        t1 = t0 + self._out_ts * seq
        out_ok = (cs_out[idx + t1] - cs_out[idx + t0]) == 0
        return idx[in_ok & out_ok]

    @property
    def shape(self) -> tuple[int, ...]:
        """(time_step, varlev, lat, lon) of inputs without insolation."""
        H, W = self._series.shape[-2:]
        return (self._in_ts, len(self._input_names), H, W)

    @property
    def n_features(self) -> int:
        """Values in one input item, insolation included."""
        t, c, h, w = self.shape
        return t * c * h * w + (t * h * w if self._add_insolation else 0)

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

    @property
    def dense_shape(self) -> tuple[int, ...]:
        """Flattened item shape for dense models, the time axis kept for
        recurrent ones."""
        if self._keep_time_axis:
            return (self._in_ts, self.n_features // self._in_ts)
        return (self.n_features,)

    @property
    def sequence(self):
        return self._sequence

    def _base_indices(self) -> np.ndarray:
        return (self._valid.copy() if self._valid is not None
                else np.arange(self._n_sample))

    # ------------------------------------------------------------- assembly
    def _gather(self, samples, offsets, chan_idx):
        """(B, T, C_sel, H, W) of time-shifted slices. An in-memory series
        goes to :func:`dlwp_torch.data.native.assemble`: the native gather
        for a C-contiguous float32 series, else its numpy version. A lazy
        (h5py) series reads each time step's rows sorted and unique, as
        h5py requires, then restores the batch's order and duplicates."""
        arr = self._series
        if isinstance(arr, np.ndarray):
            return native.assemble(arr, samples,
                                   np.arange(offsets.start, offsets.stop),
                                   chan_idx)
        return np.stack([_read_rows(arr, samples + n)[:, chan_idx]
                         for n in offsets], axis=1)

    def generate(self, samples=(), scale_and_impute: bool = True,
                 return_indices: bool = False):
        """``(inputs, targets)`` for explicit sample indices (all if empty);
        with ``return_indices`` also the indices that survived NaN
        removal."""
        samples = (np.arange(self._n_sample) if len(samples) == 0
                   else np.asarray(samples, dtype=np.int64))
        B = len(samples)
        p = self._gather(samples, range(self._in_ts),
                         self._input_idx).astype(self._dtype, copy=False)
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
            ).astype(self._dtype, copy=False)
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


def _read_rows(arr, idx):
    """``arr[idx]`` along axis 0 of a lazy (h5py) array: read at the sorted
    unique indices, then permuted back (duplicates through the inverse
    map)."""
    order = np.argsort(idx, kind="stable")
    uniq, inverse = np.unique(idx[order], return_inverse=True)
    return arr[uniq][inverse][np.argsort(order, kind="stable")]


class SamplesSampler(_EpochBatches):
    """Batches straight from a samples-format dataset with explicit
    ``predictors`` and ``targets``: NaN-sample removal, the model's
    scaler/imputer, conv/recurrent shaping, per-epoch shuffling."""

    def __init__(
        self,
        data: PredictorDataset,
        model=None,
        batch_size: int = 32,
        shuffle: bool = False,
        remove_nan: bool = True,
        is_convolutional: bool | None = None,
        is_recurrent: bool | None = None,
        seed: int = 0,
    ):
        if data.targets is None:
            raise ValueError(
                "SamplesSampler requires a samples-format dataset with targets")
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
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._remove_nan = remove_nan
        self._rng = np.random.RandomState(seed)
        self._n_sample = data.predictors.shape[0]
        self.on_epoch_end()

    @property
    def convolution_shape(self):
        s = self.data.predictors.shape[1:]
        if len(s) == 4 and not self._keep_time_axis:
            return (s[0] * s[1],) + s[2:]
        return s

    def _base_indices(self) -> np.ndarray:
        return np.arange(self._n_sample)

    def generate(self, samples=(), scale_and_impute: bool = True):
        samples = (np.arange(self._n_sample) if len(samples) == 0
                   else np.asarray(samples))
        p = np.asarray(self.data.predictors)[samples]
        t = np.asarray(self.data.targets)[samples]
        if self._remove_nan:
            keep = ~(np.isnan(p.reshape(len(p), -1)).any(axis=1)
                     | np.isnan(t.reshape(len(t), -1)).any(axis=1))
            p, t = p[keep], t[keep]
        if scale_and_impute and self.model is not None:
            if getattr(self.model, "impute", False) and self.model.imputer:
                p, t = self.model.imputer_transform(p, t)
            if getattr(self.model, "scaler", None) is not None:
                p, t = self.model.scaler_transform(p, t)
        if not self._keep_time_axis and p.ndim == 5:
            p = p.reshape((len(p), -1) + p.shape[3:])
            t = t.reshape((len(t), -1) + t.shape[3:])
        return p, t


def device_prefetch(sampler, sharding=None, depth: int = 2, device=None):
    """Iterate ``sampler``'s batches as tensors on ``device`` (default
    ``cuda``; raises without a card unless ``device='cpu'``), assembled
    ``depth`` batches ahead by a producer thread.

    ``sharding``: the mesh a sharded model trains on, as a
    :class:`~dlwp_torch.parallel.mesh.Mesh` or a ``(mesh, axis names)``
    pair, as :class:`~dlwp_torch.data.device_sampler.DeviceSeriesSampler`
    takes it. Batches then arrive where the ``Trainer`` on that mesh takes
    them: whole, on the mesh's first device of this process; a ``device``
    other than that one raises.

    On a card each batch is copied from pinned memory on a side stream;
    the consumer's stream waits for that copy before it uses the batch. An
    error in the producer is raised in the consumer. Stopping early (or
    closing the generator) stops the producer."""
    if sharding is not None:
        device = sharding_device(sharding, device)
    dev = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def produce():
        try:
            for batch in sampler:
                if stop.is_set():
                    return
                if stream is None:
                    put((tuple(torch.as_tensor(np.asarray(a))
                               for a in batch), None))
                    continue
                with torch.cuda.stream(stream):
                    moved = tuple(
                        torch.from_numpy(np.ascontiguousarray(a))
                        .pin_memory().to(dev, non_blocking=True)
                        for a in batch)
                    ready = torch.cuda.Event()
                    ready.record(stream)
                put((moved, ready))
        except BaseException as e:  # re-raised in the consumer
            put(e)
        finally:
            put(done)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            moved, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(ready)
                for t in moved:
                    t.record_stream(current)
            yield moved
    finally:
        stop.set()
        thread.join(timeout=10)

"""Autoregressive forecast rollout (port of ``dlwp_tpu.forecast.rollout``).

``TimeSeriesEstimator`` drives multi-step forecasts when model inputs and
outputs differ: each input channel of the next window comes from the
prediction, from freshly computed insolation ('SOL'), from the previous
window where it overlaps, or from the time-mean state (imputation). The
channel reconciliation is resolved once into a static source map; the
insolation forcing of every step is computed on the device up front when
it fits :data:`SOL_PRECOMPUTE_BUDGET`; the JAX ``lax.scan`` is a Python
loop under ``torch.inference_mode()`` that writes each step's prediction
into a preallocated output. State never leaves the device. Each call is a
span ``rollout`` (:func:`~dlwp_torch.utils.profiling.span`), each loop
iteration a ``rollout.step`` around ``rollout.model`` and
``rollout.build_next``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from dlwp_torch.data.sampler import SeriesSampler
from dlwp_torch.grid.insolation import (
    day_of_year,
    insolation_from_tables,
    insolation_tables,
)
from dlwp_torch.utils.profiling import span

SOL_CHANNEL = "SOL"
# Precompute the (steps, B, in_ts, H, W) insolation forcing before the loop
# when it fits this many bytes (at 4 bytes a value); else per step.
SOL_PRECOMPUTE_BUDGET = 1 << 30  # 1 GiB


@dataclasses.dataclass
class Forecast:
    """A labeled forecast array (f_hour, time, varlev, lat, lon)."""

    values: np.ndarray
    f_hour: np.ndarray  # hours since initialization
    times: np.ndarray  # (time,) datetime64 initialization times
    varlev: list[str]
    lat: np.ndarray
    lon: np.ndarray

    @property
    def shape(self):
        return self.values.shape

    def sel_varlev(self, name: str) -> np.ndarray:
        return self.values[:, :, self.varlev.index(name)]


def _with_gate_dtype(model, gate_dtype):
    """A shallow copy of ``model`` rebuilt with ``ConvLSTM2D(gate_dtype=…)``
    and the same build config, sharing its weights; ``model`` itself is
    left as it is."""
    specs = []
    for name, args, kw in model.layer_specs:
        kw = dict(kw or {})
        if name == "ConvLSTM2D":
            kw["gate_dtype"] = gate_dtype
        specs.append((name, args, kw))
    served = copy.copy(model)
    served.build_model(specs, **model._build_config)
    served.base_model.share_params_from(model.base_model)
    return served


class TimeSeriesEstimator:
    """Autoregressive forecasts for a model + sampler pair.

    ``gate_dtype='bfloat16'`` serves the model with bf16 ConvLSTM gates (a
    rebuilt copy; weights shared, the caller's model untouched).
    """

    def __init__(self, model, sampler: SeriesSampler, gate_dtype=None):
        if gate_dtype is not None and getattr(model, "layer_specs", None):
            model = _with_gate_dtype(model, gate_dtype)
        self.model = model
        self.device = model.device
        self.sampler = sampler
        self._k = int(sampler._interval)
        self._in_ts = sampler._in_ts
        self._out_ts = sampler._out_ts
        in_names = list(sampler._input_names)
        if sampler._add_insolation:
            in_names = in_names + [SOL_CHANNEL]
        self._input_names = in_names
        self._output_names = list(sampler._output_names)
        out_pos = {n: j for j, n in enumerate(self._output_names)}
        self._sources = []
        for c, name in enumerate(in_names):
            if name == SOL_CHANNEL:
                self._sources.append(("sol", None))
            elif name in out_pos:
                self._sources.append(("pred", out_pos[name]))
            else:
                self._sources.append(("impute", c))
        data = sampler.data
        dts = np.diff(np.asarray(data.sample, dtype="datetime64[ns]"))
        if len(dts) and not (dts == dts[0]).all():
            raise ValueError("sample times must be evenly spaced")
        self._dt_hours = (float(dts[0] / np.timedelta64(1, "h"))
                          if len(dts) else 6.0)
        self._lat = np.asarray(data.lat)
        self._lon = np.asarray(data.lon)

    def _advance(self, prefer_first_times: bool = True) -> int:
        """Data steps the input window advances per model iteration."""
        in_ts, out_ts = self._in_ts, self._out_ts
        es = out_ts if out_ts <= in_ts else (
            in_ts if prefer_first_times else out_ts)
        return es + self._k - 1

    def prepare_inputs(self, samples=()):
        """``(x0, init_days, mean_state, init_times)`` on the device: the
        scaled initial window (B, in_ts, C_in, H, W) in the model's dtype,
        float64 day-of-year at initialization, the time-mean state of the
        imputed channels, and the datetime64 init times."""
        s = self.sampler
        samples = (np.arange(s._n_sample) if len(samples) == 0
                   else np.asarray(samples))
        p, _, kept = s.generate(samples, scale_and_impute=True,
                                return_indices=True)
        B = p.shape[0]
        H, W = self._lat.shape[0], self._lon.shape[0]
        p = np.asarray(p).reshape(B, self._in_ts, len(self._input_names), H, W)
        dtype = next(self.model.base_model.parameters()).dtype
        x0 = torch.as_tensor(p, dtype=dtype, device=self.device)
        init_times = s.sample_times(kept)
        init_days = torch.as_tensor(day_of_year(init_times),
                                    dtype=torch.float64, device=self.device)
        mean_state = x0.mean(dim=(0, 1))
        return x0, init_days, mean_state, init_times

    def precompute_batch_limit(self, steps: int) -> int:
        """The largest batch whose insolation forcing over ``steps`` steps
        :meth:`rollout_fn` computes before its loop (the budget
        :data:`SOL_PRECOMPUTE_BUDGET`); above it, step by step. A program
        exported from the rollout takes batches up to this size (the
        branch is decided when it is traced)."""
        H, W = self._lat.shape[0], self._lon.shape[0]
        return SOL_PRECOMPUTE_BUDGET // (int(steps) * self._in_ts * H * W * 4)

    def rollout_fn(self, steps: int, prefer_first_times: bool = True):
        """``rollout(x0, init_days, mean_state) -> (steps, B, out_ts, C_out,
        H, W)``: the program :meth:`predict` runs, one model application and
        one next-window assembly per step."""
        steps = int(steps)
        if steps < 1:
            raise ValueError("steps must be >= 1")
        in_ts, out_ts = self._in_ts, self._out_ts
        dt_hours = self._dt_hours
        H, W = self._lat.shape[0], self._lon.shape[0]
        C_in = len(self._input_names)
        sources = self._sources
        is_recurrent = getattr(self.model, "is_recurrent", False)
        net = self.model.base_model
        n_out = len(self._output_names)
        adv = self._advance(prefer_first_times)
        tables = torch.as_tensor(insolation_tables(self._lat, self._lon),
                                 device=self.device)
        needs_sol = any(kind == "sol" for kind, _ in sources)

        def out_index(m):
            j = m - in_ts + out_ts if out_ts <= in_ts else (
                m if prefer_first_times else m + out_ts - in_ts)
            return j if 0 <= j < out_ts else None

        # Per next-window slot m: predicted output j(m), else the previous
        # window's slot m + adv where it exists.
        slot_plan = []
        for m in range(in_ts):
            j = out_index(m)
            prev = m + adv if (j is None and m + adv < in_ts) else None
            slot_plan.append((j, prev))

        def step_sol(its, init_days):
            """(len(its), B, in_ts, H, W) forcing of the next windows of
            steps ``its``; day offsets are relative to the init time (the
            last input step of window 0)."""
            m_idx = torch.arange(in_ts, dtype=torch.float64, device=self.device)
            offs = ((its[:, None] + 1.0) * adv + m_idx[None, :]
                    - (in_ts - 1.0)) * (dt_hours / 24.0)
            days = init_days[None, :, None] + offs[:, None, :]
            return insolation_from_tables(days, tables)

        def build_next(x, pred, sol, mean_state):
            B = x.shape[0]
            flat = []
            for m, (j, prev) in enumerate(slot_plan):
                for c, (kind, idx) in enumerate(sources):
                    if kind == "sol":
                        flat.append(sol[:, m].to(x.dtype))
                    elif kind == "pred" and j is not None:
                        flat.append(pred[:, j, idx])
                    elif prev is not None:
                        flat.append(x[:, prev, c])
                    else:
                        flat.append(mean_state[c].expand(B, H, W))
            return torch.stack(flat, dim=1).reshape(B, in_ts, C_in, H, W)

        @torch.inference_mode()
        @span("rollout")
        def rollout(x0, init_days, mean_state):
            B = x0.shape[0]
            its = torch.arange(steps, dtype=torch.float64, device=self.device)
            sol_all = None
            if needs_sol and B <= self.precompute_batch_limit(steps):
                with span("rollout.sol"):
                    sol_all = step_sol(its, init_days).to(x0.dtype)
            preds = torch.empty((steps, B, out_ts, n_out, H, W),
                                dtype=x0.dtype, device=x0.device)
            x = x0
            for it in range(steps):
                with span("rollout.step"):
                    inp = (x if is_recurrent
                           else x.reshape(B, in_ts * C_in, H, W))
                    with span("rollout.model"):
                        pred = net(inp).reshape(B, out_ts, n_out, H, W)
                    preds[it] = pred
                    if it + 1 == steps:
                        break
                    with span("rollout.build_next"):
                        sol = None
                        if needs_sol:
                            sol = (sol_all[it] if sol_all is not None
                                   else step_sol(its[it:it + 1],
                                                 init_days)[0])
                        x = build_next(x, pred, sol, mean_state)
            return preds

        return rollout

    def predict(
        self,
        steps: int,
        samples=(),
        unscale: bool = False,
        prefer_first_times: bool = True,
        init_batch_size: int | None = None,
    ) -> Forecast:
        """Run ``steps`` model iterations (each producing out_ts time steps):
        a Forecast of shape (steps * out_ts, n_samples, C_out, H, W).
        ``unscale`` applies the dataset's mean/std; ``init_batch_size``
        runs the init times in chunks of that size (the last one padded by
        repeating its final sample)."""
        steps = int(steps)
        if steps < 1:
            raise ValueError("steps must be >= 1")
        x0, init_days, mean_state, init_times = self.prepare_inputs(samples)
        rollout = self.rollout_fn(steps, prefer_first_times)
        n_init = x0.shape[0]
        if init_batch_size and init_batch_size < n_init:
            bs = int(init_batch_size)
            chunks = []
            for i in range(0, n_init, bs):
                xc, dc = x0[i:i + bs], init_days[i:i + bs]
                nb = xc.shape[0]
                if nb < bs:
                    xc = torch.cat([xc, xc[-1:].expand(bs - nb, *xc.shape[1:])])
                    dc = torch.cat([dc, dc[-1:].expand(bs - nb)])
                chunks.append(rollout(xc, dc, mean_state)[:, :nb].cpu().numpy())
            preds = np.concatenate(chunks, axis=1)
        else:
            preds = rollout(x0, init_days, mean_state).cpu().numpy()
        out_ts, k = self._out_ts, self._k
        B = x0.shape[0]
        H, W = self._lat.shape[0], self._lon.shape[0]
        n_out = len(self._output_names)
        adv = self._advance(prefer_first_times)
        s = self.sampler
        preds = preds.transpose(0, 2, 1, 3, 4, 5).reshape(
            steps * out_ts, B, n_out, H, W)
        if unscale:
            out_idx = s.data.varlev_index(self._output_names)
            preds = (preds * s.data.std[out_idx][:, None, None]
                     + s.data.mean[out_idx][:, None, None])
        its = np.repeat(np.arange(steps), out_ts)
        js = np.tile(np.arange(out_ts), steps)
        return Forecast(
            values=preds,
            f_hour=(its * adv + k + js) * self._dt_hours,
            times=init_times,
            varlev=list(self._output_names),
            lat=self._lat,
            lon=self._lon,
        )

"""Autoregressive forecast rollout (port of ``dlwp_tpu.forecast.rollout``).

``TimeSeriesEstimator`` drives multi-step forecasts when model inputs and
outputs differ: each input channel of the next window comes from the
prediction, from freshly computed insolation ('SOL'), from the previous
window where it overlaps, or from the time-mean state (imputation). The
channel reconciliation is resolved once into a static source map; the
insolation forcing of every step is computed on the device up front when
it fits :data:`SOL_PRECOMPUTE_BUDGET`; the JAX ``lax.scan`` is a Python
loop under ``torch.inference_mode()`` that writes each step's prediction
into a preallocated output. The grid's latitudes and longitudes are 1-D
(a lat-lon grid) or 2-D (the cubed sphere's faces stacked along the
rows). State never leaves the device. Each call is a
span ``rollout`` (:func:`~dlwp_torch.utils.profiling.span`), each loop
iteration a ``rollout.step`` around ``rollout.model`` and
``rollout.build_next``.

On the card the loop replays CUDA graphs of one step (:class:`_StepGraphs`)
wherever the operands are CUDA tensors, nothing traces the rollout and the
model is not spatially sharded (:func:`_replays_graphs`): a step is then
three host calls instead of one per kernel. The CPU, ``torch.export`` and
the lat-band sharded paths run the loop eagerly. :func:`graph_counts`
says how often each path ran.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import itertools

import numpy as np
import torch

from dlwp_torch import kernels
from dlwp_torch.data.sampler import SeriesSampler
from dlwp_torch.device import keep_cached
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
# Captured step graphs an estimator keeps, one per key (batch, shapes,
# dtypes, device, weights), least recently used first out.
GRAPH_CACHE_SIZE = 4

_graph_counts = {"captures": 0, "replays": 0, "eager_steps": 0}


def graph_counts() -> dict[str, int]:
    """Since the last :func:`reset_graph_counts`: keys captured as CUDA
    graphs (``captures``), rollout steps replayed from them
    (``replays``) and steps run eagerly (``eager_steps``, the first step
    of a call that captures among them)."""
    return dict(_graph_counts)


def reset_graph_counts() -> None:
    for name in _graph_counts:
        _graph_counts[name] = 0


def _replays_graphs(model, device: torch.device) -> bool:
    """Whether a rollout on ``device`` replays captured step graphs: on a
    CUDA device, outside a trace (``torch.export`` traces the eager loop),
    for a model that is not spatially sharded (its lat-band halo and
    overlap paths synchronise across cards and processes on the host).
    Any other model replays: the lat-lon towers and the cubed-sphere
    U-Net alike."""
    return (device.type == "cuda" and not torch.compiler.is_compiling()
            and getattr(model, "_spatial", None) is None)


class _StepGraphs:
    """One rollout step as CUDA graphs, for one key, over static buffers:
    two windows that take turns, one step's insolation and the mean state.
    ``step0`` / ``step1`` run the model on window 0 / 1 into a static
    prediction and assemble the next window into the other; ``last`` runs
    the model alone on window 0. A call puts its first window where the
    turns leave its last step on window 0. The three graphs share one
    memory pool; each static prediction is copied out right after its
    replay, before another graph of the pool runs."""

    def __init__(self, x0, mean_state, needs_sol: bool):
        B, in_ts, _, H, W = x0.shape
        self.windows = (torch.empty_like(x0), torch.empty_like(x0))
        self.mean_state = torch.empty_like(mean_state)
        self.sol = (torch.empty((B, in_ts, H, W), dtype=x0.dtype,
                                device=x0.device) if needs_sol else None)
        self.graphs = {}  # name -> (graph, static prediction, launches)
        self.kept = []  # the tensor caches' values that the graphs read

    def run(self, preds, x0, mean_state, sol_at, model_step, build_next):
        """Fill ``preds`` (steps, ...) from ``x0``: each step copies its
        insolation in (``sol_at(it)``), replays and copies the prediction
        out. Before the first run, step 0 runs eagerly on a side stream,
        on the static buffers, and the graphs are captured there."""
        steps = preds.shape[0]
        with torch.cuda.device(preds.device):
            self.windows[(steps - 1) % 2].copy_(x0)
            self.mean_state.copy_(mean_state)
            it0 = 0
            if not self.graphs:
                self._first_step_and_capture(preds, sol_at, model_step,
                                             build_next)
                it0 = 1
            for it in range(it0, steps):
                with span("rollout.step"):
                    last = it + 1 == steps
                    if not last and self.sol is not None:
                        self.sol.copy_(sol_at(it))
                    with span("rollout.model"):
                        pred = self._replay(
                            "last" if last else f"step{(steps - 1 - it) % 2}")
                    preds[it] = pred

    def _first_step_and_capture(self, preds, sol_at, model_step,
                                build_next):
        """Step 0, eagerly, on a side stream (it fills the tensor caches,
        the ops' plans and cuDNN's choices), then the capture on that
        stream. A capture launches nothing: the launches it adds to the
        kernel wrappers' counts are taken back, and each replay adds
        them."""
        steps = preds.shape[0]
        src = (steps - 1) % 2
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream(preds.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            with span("rollout.step"):
                if steps > 1 and self.sol is not None:
                    self.sol.copy_(sol_at(0))
                with span("rollout.model"):
                    pred = model_step(self.windows[src])
                preds[0] = pred
                if steps > 1:
                    with span("rollout.build_next"):
                        build_next(self.windows[src], pred, self.sol,
                                   self.mean_state,
                                   out=self.windows[1 - src])
            _graph_counts["eager_steps"] += 1
        with span("rollout.capture"), keep_cached(self.kept):
            pool = torch.cuda.graph_pool_handle()
            for name, w in (("step0", 0), ("step1", 1), ("last", 0)):
                graph = torch.cuda.CUDAGraph()
                before = kernels.launch_counts()
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    pred = model_step(self.windows[w])
                    if name != "last":
                        build_next(self.windows[w], pred, self.sol,
                                   self.mean_state, out=self.windows[1 - w])
                launches = []
                for k, n in kernels.launch_counts().items():
                    if n != before[k]:
                        kernels.WRAPPERS[k].launches = before[k]
                        launches.append((kernels.WRAPPERS[k], n - before[k]))
                self.graphs[name] = (graph, pred, launches)
        current.wait_stream(side)
        _graph_counts["captures"] += 1

    def _replay(self, name: str) -> torch.Tensor:
        """Replay graph ``name`` on the current stream; its static
        prediction."""
        graph, pred, launches = self.graphs[name]
        graph.replay()
        for wrapper, n in launches:
            wrapper.launches += n
        _graph_counts["replays"] += 1
        return pred


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
        # The grid's (rows, columns): from 1-D latitudes and longitudes, or
        # from 2-D ones (a cubed sphere's faces stacked along the rows).
        self._hw = (self._lat.shape if self._lat.ndim == 2
                    else (self._lat.shape[0], self._lon.shape[0]))
        self._graphs = collections.OrderedDict()  # key -> _StepGraphs

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
        H, W = self._hw
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
        H, W = self._hw
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
        H, W = self._hw
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

        def model_step(x):
            B = x.shape[0]
            inp = x if is_recurrent else x.reshape(B, in_ts * C_in, H, W)
            return net(inp).reshape(B, out_ts, n_out, H, W)

        def build_next(x, pred, sol, mean_state, out=None):
            """The next window, into ``out`` where given (the graph path's
            static window; never ``x``, which it reads)."""
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
            if out is not None:
                torch.stack(flat, dim=1, out=out.view(B, in_ts * C_in, H, W))
                return out
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

            def sol_at(it):
                if not needs_sol:
                    return None
                return (sol_all[it] if sol_all is not None
                        else step_sol(its[it:it + 1], init_days)[0])

            if _replays_graphs(self.model, x0.device):
                self._step_graphs(x0, mean_state, needs_sol, slot_plan).run(
                    preds, x0, mean_state, sol_at, model_step, build_next)
                return preds
            x = x0
            for it in range(steps):
                with span("rollout.step"):
                    with span("rollout.model"):
                        pred = model_step(x)
                    preds[it] = pred
                    _graph_counts["eager_steps"] += 1
                    if it + 1 == steps:
                        break
                    with span("rollout.build_next"):
                        x = build_next(x, pred, sol_at(it), mean_state)
            return preds

        return rollout

    def _step_graphs(self, x0, mean_state, needs_sol, slot_plan):
        """The captured step of this key, now the most recently used, or
        a new one that captures at its first run. The key holds the batch,
        shapes, dtypes and device, the window plan, and the address of
        every parameter and buffer of the model, which the graphs read:
        weights swapped for others are captured anew, and a graph replays
        only while the model's tensors lie where it reads."""
        net = self.model.base_model
        key = (tuple(x0.shape), x0.dtype, x0.device, tuple(mean_state.shape),
               mean_state.dtype, tuple(slot_plan),
               tuple(t.data_ptr() for t in itertools.chain(
                   net.parameters(), net.buffers())))
        graphs = self._graphs.get(key)
        if graphs is None:
            graphs = self._graphs[key] = _StepGraphs(x0, mean_state,
                                                     needs_sol)
            while len(self._graphs) > GRAPH_CACHE_SIZE:
                self._graphs.popitem(last=False)
        self._graphs.move_to_end(key)
        return graphs

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
        H, W = self._hw
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

"""The port's spans (``dlwp_torch.utils.profiling.span``), on the CPU.

- Outside a profiler window a span records nothing and enters no record
  function; inside one, spans nest by thread with parent and
  root ids, as context managers and as decorators;
- each thread keeps its own stack: a checkpointed model's recompute,
  run by a backward on another thread, records its layer spans there and
  leaves the calling thread's nesting as it was;
- a span around an op contains that op's interval in the profile's own
  clock, and the profile holds the span as a host record of its name;
- ``rollout_fn``, ``train_step``, ``fit_device`` and ``evaluate`` record
  their named spans (one ``rollout.step`` a step, one ``train.step`` a
  train step);
- ``torch.export`` of a rollout, as ``dlwp_torch.serve`` makes it, is the
  same program inside a profiler window as outside one, and records no
  span.
"""

import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from dlwp_torch import (
    DLWPNeuralNet,
    DeviceSeriesSampler,
    PredictorDataset,
    SeriesSampler,
    TimeSeriesEstimator,
    build_sequential,
)
from dlwp_torch.flagship import convlstm_specs
from dlwp_torch.ops.losses import latitude_weighted_loss, mse
from dlwp_torch.serve import export_rollout
from dlwp_torch.train import chain, clip_by_global_norm, cosine_decay_schedule
from dlwp_torch.train.optim import adam
from dlwp_torch.utils import profiling
from dlwp_torch.utils.profiling import span

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)
H, W, C, TD = 8, 16, 2, 2
LAT = np.linspace(70.0, -70.0, H)
SPECS = [("CyclicConv2D", (4, 3), {"activation": "tanh"}),
         ("CyclicConv2D", (TD * C, 3), {"dilation": 2})]


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _window():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _dataset(n, seed=3):
    rs = np.random.RandomState(seed)
    return PredictorDataset(
        predictors=rs.randn(n, C, H, W).astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"], lat=LAT,
        lon=np.arange(W) * 22.5)


def _net(**build):
    net = DLWPNeuralNet(is_convolutional=True, is_recurrent=True, time_dim=TD,
                        scaler_type=None, device="cpu")
    net.build_model(convlstm_specs(H, W, C, TD), **build)
    net.base_model.init(torch.zeros(1, TD, C + 1, H, W), seed=0)
    return net


def _sampler(ds, net, **kw):
    return SeriesSampler(ds, model=net, input_time_steps=TD,
                         output_time_steps=TD, add_insolation=True, **kw)


def test_nothing_recorded_outside_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record function {name!r} entered")

    monkeypatch.setattr(profiling, "_annotate", refuse)

    @span("decorated")
    def work(a):
        with span("inner"):
            return a + 1

    with span("outer"):
        assert work(1) == 2
    assert profiling.spans() == []


def test_nesting_parent_and_root_ids():
    @span("leaf")
    def leaf():
        return threading.get_native_id()

    with _window() as prof:
        with span("a"):
            with span("b"):
                tid = leaf()
            with span("c"):
                leaf()
        with span("d"):
            pass
    got = _by_name(profiling.spans())
    (a,), (b,), (c,), (d,) = got["a"], got["b"], got["c"], got["d"]
    leaves = got["leaf"]
    assert len(leaves) == 2
    assert a.parent is None and a.root == a.id
    assert b.parent == a.id and c.parent == a.id
    assert [r.parent for r in leaves] == [b.id, c.id]
    assert {r.root for r in (a, b, c, *leaves)} == {a.id}
    assert d.parent is None and d.root == d.id != a.id
    assert {r.thread for r in (a, b, c, d, *leaves)} == {tid}
    for child, parent in ((b, a), (c, a), (leaves[0], b), (leaves[1], c)):
        assert parent.start_ns <= child.start_ns <= child.end_ns <= \
            parent.end_ns
    assert b.end_ns <= c.start_ns and a.end_ns <= d.start_ns
    # The profile holds each span as a host record of its name.
    names = Counter(e.name() for e in prof.profiler.kineto_results.events()
                    if e.name() in ("a", "b", "c", "d", "leaf"))
    assert names == Counter(a=1, b=1, c=1, d=1, leaf=2)
    # A window of the records: the spans that overlap it.
    assert [r.name for r in profiling.spans(d.start_ns, d.end_ns)] == ["d"]
    assert {r.name for r in profiling.spans(b.start_ns, b.end_ns)} == \
        {"a", "b", "leaf"}
    assert [r.name for r in profiling.spans(d.end_ns + 1)] == []


def test_recompute_on_another_thread_keeps_each_threads_stack(monkeypatch):
    model = build_sequential(SPECS, device="cpu")
    x = torch.randn(2, TD * (C + 1), H, W)
    model.init(x)
    for p in model.parameters():
        p.requires_grad_(True)
    # The autograd engine carries the profiler's on-switch to its device
    # threads; a plain thread does not have it, so it is on everywhere here.
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    main = threading.get_native_id()
    seen = {}

    def backward(loss):
        seen["thread"] = threading.get_native_id()
        loss.backward()

    with _window():
        with span("outer"):
            y = checkpoint(model, x, use_reentrant=False)
            worker = threading.Thread(target=backward,
                                      args=(y.square().sum(),))
            worker.start()
            worker.join()
            with span("after"):
                pass
    got = _by_name(profiling.spans())
    (outer,), (after,) = got["outer"], got["after"]
    layers = got["layer.CyclicConv2D"]
    assert len(layers) == 4  # the forward's two, the recompute's two
    forward = [r for r in layers if r.thread == main]
    recompute = [r for r in layers if r.thread == seen["thread"]]
    assert len(forward) == len(recompute) == 2 and seen["thread"] != main
    assert all(r.parent == outer.id and r.root == outer.id for r in forward)
    # The recompute's spans start the backward thread's own stack.
    assert all(r.parent is None and r.root == r.id for r in recompute)
    assert outer.start_ns <= min(r.start_ns for r in recompute)
    assert max(r.end_ns for r in recompute) <= after.start_ns
    # The calling thread's nesting is as it was.
    assert after.parent == outer.id and after.root == outer.id
    assert outer.parent is None


def test_a_span_contains_its_ops_interval_on_the_profiles_clock():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with _window() as prof:
        with span("matmul"):
            torch.mm(a, b)
    (rec,) = profiling.spans()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("aten::mm", "matmul"):
        e = events[name]
        assert rec.start_ns <= e.start_ns() <= e.end_ns() <= rec.end_ns, name


def test_rollout_records_its_steps_layers_and_kernel_wrappers():
    net = _net()
    est = TimeSeriesEstimator(net, _sampler(_dataset(12), net, batch_size=2))
    x0, days, mean_state, _ = est.prepare_inputs([0, 1])
    steps = 3
    rollout = est.rollout_fn(steps)
    with _window():
        rollout(x0, days, mean_state)
    records = profiling.spans()
    got = _by_name(records)
    (call,) = got["rollout"]
    assert call.parent is None
    assert {r.root for r in records} == {call.id}
    assert len(got["rollout.sol"]) == 1
    step_ids = {r.id for r in got["rollout.step"]}
    assert len(step_ids) == steps
    assert all(r.parent == call.id for r in got["rollout.step"])
    assert len(got["rollout.model"]) == steps
    assert len(got["rollout.build_next"]) == steps - 1
    assert all(r.parent in step_ids
               for r in got["rollout.model"] + got["rollout.build_next"])
    model_ids = {r.id for r in got["rollout.model"]}
    per_layer = [r for r in records if r.name.startswith("layer.")]
    assert all(r.parent in model_ids for r in per_layer)
    assert len(per_layer) == steps * len(net.base_model.layers)
    assert {"layer.ConvLSTM2D", "layer.FusedConvPool2D",
            "layer.UpConv2D"} <= set(got)
    # The wrappers run inside their layers: the gate chain once a time
    # step after the first, each conv-pool stage once.
    lstm_ids = {r.id for r in got["layer.ConvLSTM2D"]}
    assert len(got["kernel.lstm_gates"]) == steps * (TD - 1)
    assert all(r.parent in lstm_ids for r in got["kernel.lstm_gates"])
    pool_ids = {r.id for r in got["layer.FusedConvPool2D"]}
    assert len(got["kernel.fused_conv_pool"]) == len(pool_ids)
    assert all(r.parent in pool_ids for r in got["kernel.fused_conv_pool"])
    # The tower's four small-grid convs, one cyclic conv each, inside
    # their CyclicConv2D and UpConv2D layers.
    conv_ids = {r.id for name in ("layer.CyclicConv2D", "layer.UpConv2D")
                for r in got[name]}
    assert len(got["kernel.cyclic_conv"]) == 4 * steps
    assert all(r.parent in conv_ids for r in got["kernel.cyclic_conv"])


def _trainer(n_train=24, n_val=10, batch=4):
    def splice(inp, pred, k):
        return torch.cat([pred, inp[:, :, C:]], dim=2)

    ds = _dataset(n_train + n_val)
    net = DLWPNeuralNet(is_convolutional=True, is_recurrent=True, time_dim=TD,
                        scaler_type=None, device="cpu")
    optimizer = chain(clip_by_global_norm(1.0),
                      adam(cosine_decay_schedule(2e-3, 50, 0.05)))
    net.build_model(convlstm_specs(H, W, C, TD),
                    loss=latitude_weighted_loss(mse, LAT),
                    optimizer=optimizer, sequence_steps=2, splice_fn=splice)
    train = DeviceSeriesSampler(_sampler(
        ds.isel_sample(np.arange(n_train)), net, sequence=2,
        batch_size=batch, shuffle=True, seed=1), device="cpu")
    val = DeviceSeriesSampler(_sampler(
        ds.isel_sample(np.arange(n_train, n_train + n_val)), net, sequence=2,
        batch_size=batch, shuffle=False), device="cpu")
    return net, train, val


def test_train_step_and_fit_device_record_their_phases():
    net, train, val = _trainer()
    trainer = net.trainer
    with _window():
        trainer.fit_device(train, epochs=1, verbose=False,
                           validation_data=val)
    records = profiling.spans()
    got = _by_name(records)
    nb = len(train)
    steps = got["train.step"]
    assert len(steps) == nb and len(got["fit.gather"]) == nb
    assert all(r.parent is None and r.root == r.id for r in steps)
    step_ids = {r.id for r in steps}
    for phase in ("train.forward", "train.backward", "train.metrics",
                  "train.optimizer"):
        assert len(got[phase]) == nb, phase
        assert all(r.parent in step_ids for r in got[phase]), phase
    # S=2: two model steps in the forward, and on the CPU checkpoint's
    # recompute runs on the calling thread, inside the backward (it stops
    # after the last layer that saved a tensor).
    n_layers = len(net.base_model.layers)
    inside = {}
    for phase in ("train.forward", "train.backward"):
        ids = {r.id for r in got[phase]}
        inside[phase] = Counter(r.name for r in records
                                if r.name.startswith("layer.")
                                and r.parent in ids)
    assert sum(inside["train.forward"].values()) == 2 * nb * n_layers
    assert sum(inside["train.backward"].values()) <= 2 * nb * n_layers
    for phase in inside:
        assert inside[phase]["layer.ConvLSTM2D"] == 2 * nb, phase
    (readback,), (end,), (validation,) = (
        got["fit.readback"], got["fit.epoch_end"], got["fit.validation"])
    assert validation.parent == end.id
    assert readback.end_ns <= end.start_ns
    evals = got["eval.step"]
    assert len(evals) == len(val)
    assert all(r.parent == validation.id for r in evals)
    assert max(r.end_ns for r in steps) <= readback.start_ns


def test_train_step_alone_records_one_step():
    net, train, _ = _trainer()
    x, y = train[0]
    with _window():
        net.trainer.train_step(x, y)
    got = _by_name(profiling.spans())
    assert len(got["train.step"]) == 1
    assert {"train.forward", "train.backward", "train.metrics",
            "train.optimizer"} <= set(got)
    assert "fit.gather" not in got


def _graph(servable):
    return {name: p.graph_module.code for name, p in servable.programs.items()}


def test_export_is_the_same_program_inside_a_profiler_window():
    net = _net()
    x = np.zeros((2, TD, C + 1, H, W), np.float32)
    plain = _graph(export_rollout(net, x, 2))
    with _window():
        traced = _graph(export_rollout(net, x, 2))
    assert traced == plain
    assert not any("profiler" in code for code in plain.values())
    assert profiling.spans() == []

"""Serving (``dlwp_torch.serve``) against ``dlwp_tpu.serve``: each behaviour of
``tests/test_serve.py`` for the port, and the same servables held against
the JAX package's, float32 on the CPU from one set of weights.

- A rollout servable equals the eager ``predict_timeseries`` (the program
  runs the same ops: 1e-6 relative, as the JAX tests hold theirs) and the
  JAX servable's output (1e-5 relative: float32 convolutions sum in
  another order), at the example's batch and at one it never saw.
- A barotropic servable equals the eager plain engine and JAX's
  (rtol 1e-5, atol 1e-4, the JAX test's limits). Rolled (two programs of
  one snapshot interval each, looped by ``Servable.call``): at the
  reference's ``run_with_snapshots(24, 12)``, both forms, bit-equal to
  eager in float32 and float64 through serialize and load, and in float64
  within 1e-14 relative (max abs over max, the order of float64 sums over
  288 steps; 1.3e-15 measured) of JAX's scan servable; fewer graph nodes
  than the unrolled export of the same run, compared at (6, 3); a
  format-1 artifact (one program) still loads.
- A program exported on the CPU holds the ``dlwp_torch::fused_conv_pool``
  and ``dlwp_torch::lstm_gates`` nodes (so the card runs the kernels), and
  moving it to another device moves every weight, constant and device
  argument: it runs on the ``meta`` device, which any tensor left behind
  on the CPU would stop.
- ``entry()``'s forward equals ``__graft_entry__.entry()``'s (1e-5
  relative) and exports.
- A table cache that a model's forward fills (padding indices, the
  parity-fold matrix of a conv after an upsampling, the spherical engine)
  keeps no traced tensor when its first build happens under export: the
  eager model afterwards returns real tensors equal to its output before
  the export.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch.export import Dim
from torch.export.passes import move_to_device_pass

import __graft_entry__
import dlwp_tpu.serve as jserve
from dlwp_tpu.barotropic import BarotropicModel as JaxVrt
from dlwp_tpu.barotropic import BarotropicModelPsi as JaxPsi
from dlwp_tpu.grid import LatLonGrid as JaxGrid
from dlwp_tpu.models import DLWPNeuralNet as JaxNet

from dlwp_torch import (
    BarotropicModel,
    BarotropicModelPsi,
    DLWPNeuralNet,
    LatLonGrid,
    PredictorDataset,
    SeriesSampler,
    TimeSeriesEstimator,
    build_sequential,
    load_flax_params,
)
from dlwp_torch.entry import entry
from dlwp_torch.flagship import convlstm_specs
from dlwp_torch.models.spherical import _engine, s2_near_identity_grid
from dlwp_torch.ops.conv import _fold_matrix
from dlwp_torch.ops.padding import _gather_index
from dlwp_torch.serve import (
    Servable,
    export_barotropic,
    export_program,
    export_rollout,
)

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(2)
TOL_EAGER = 1e-6
TOL_JAX = 1e-5
OPS = {"dlwp_torch.fused_conv_pool.default", "dlwp_torch.lstm_gates.default"}


def _specs(kind, time_dim, c, nlat, nlon):
    if kind == "plain":
        return [
            ("CyclicConv2D", (8, 3), {"activation": "tanh"}),
            ("CyclicConv2D", (time_dim * c, 3), {"activation": "linear"}),
        ]
    if kind == "recurrent":
        return [
            ("ConvLSTM2D", (4, 3), {"return_sequences": True,
                                    "activation": "tanh"}),
            ("Reshape", ((time_dim * 4, nlat, nlon),), None),
            ("CyclicConv2D", (c, 3), {"activation": "linear"}),
            ("Reshape", ((1, c, nlat, nlon),), None),
        ]
    # The flagship at 16x32, fed two channels so that in equals out.
    return convlstm_specs(nlat, nlon, c, time_dim)


def _jax_net(kind, time_dim, c, nlat, nlon, scaler_type=None):
    """The JAX model of ``_models``, its parameters not yet made, and the
    input it is made for."""
    recurrent = kind != "plain"
    shape = ((4, time_dim, c, nlat, nlon) if recurrent
             else (4, time_dim * c, nlat, nlon))
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jnet = JaxNet(is_recurrent=recurrent, time_dim=time_dim,
                  scaler_type=scaler_type)
    jnet.build_model(_specs(kind, time_dim, c, nlat, nlon))
    return jnet, x


@functools.cache
def _jax_params(kind, time_dim, c, nlat, nlon):
    """The parameters of ``Trainer.init`` for ``_jax_net``'s model, from one
    compiled init (bit for bit those of the trainer's op-by-op init:
    ``test_compiled_jax_init_is_the_trainers``), made once a model for
    every test of it."""
    jnet, x = _jax_net(kind, time_dim, c, nlat, nlon)
    return jax.jit(jnet.trainer.model.init)(
        jax.random.PRNGKey(jnet.trainer.config.seed), x)


def _models(kind="plain", time_dim=2, c=2, nlat=8, nlon=16, scaler_type=None):
    """The JAX and port models of ``tests/test_serve.py``'s ``_small_model``
    (and the 16x32 flagship), JAX weights loaded into the port, with the
    port's parameters requiring grad as after its trainer's init."""
    recurrent = kind != "plain"
    specs = _specs(kind, time_dim, c, nlat, nlon)
    jnet, x = _jax_net(kind, time_dim, c, nlat, nlon, scaler_type)
    jnet.trainer.params = _jax_params(kind, time_dim, c, nlat, nlon)
    jnet.trainer.opt_state = jnet.trainer.tx.init(jnet.trainer.params)
    net = DLWPNeuralNet(is_recurrent=recurrent, time_dim=time_dim,
                        scaler_type=scaler_type, device="cpu")
    net.build_model(specs)
    net.load_flax_params(jax.tree_util.tree_map(np.asarray,
                                                jnet.trainer.params))
    net.trainer.init(x)
    return net, jnet, x


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_compiled_jax_init_is_the_trainers():
    """``_models``' JAX parameters and Adam state, from one compiled init,
    are ``Trainer.init``'s bit for bit."""
    _, jnet, _ = _models()
    want, x = _jax_net("plain", 2, 2, 8, 16)
    want.trainer.init(x)
    for name in ("params", "opt_state"):
        got_leaves, got_tree = jax.tree_util.tree_flatten(
            getattr(jnet.trainer, name))
        want_leaves, want_tree = jax.tree_util.tree_flatten(
            getattr(want.trainer, name))
        assert got_tree == want_tree, name
        for got, ref in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


# (model, time steps, step_sequence): test_serve's parity, step_sequence
# and recurrent cases, and the 16x32 flagship.
ROLLOUTS = {
    "plain": ("plain", 4, False),
    "step_sequence": ("plain", 3, True),
    "recurrent": ("recurrent", 2, True),
    "flagship_16x32": ("flagship", 4, False),
}


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_rollout_matches_eager_and_jax_at_any_batch(case):
    kind, steps, seq = ROLLOUTS[case]
    size = dict(nlat=16, nlon=32) if kind == "flagship" else {}
    net, jnet, x = _models(kind, **size)
    servable = export_rollout(net, x, steps, step_sequence=seq)
    jservable = jserve.export_rollout(jnet, x, steps, step_sequence=seq,
                                      platforms=("cpu",))
    x7 = np.random.RandomState(1).randn(7, *x.shape[1:]).astype(np.float32)
    for xb in (x, x7):
        got = servable.predict_timeseries(xb)
        np.testing.assert_allclose(
            got, net.predict_timeseries(xb, steps, step_sequence=seq),
            rtol=TOL_EAGER)
        want = np.asarray(jservable.predict_timeseries(xb))
        assert got.shape == want.shape
        assert _rel(got, want) <= TOL_JAX


def test_save_load_roundtrip(tmp_path):
    net, _, x = _models()
    path = str(tmp_path / "fc.dlwpserve")
    servable = export_rollout(net, x, 2, path=path)
    loaded = Servable.load(path, device="cpu")
    assert loaded.device == torch.device("cpu")
    assert loaded.meta["kind"] == "rollout"
    assert loaded.in_specs == ((("b",) + x.shape[1:], "float32"),)
    np.testing.assert_allclose(loaded.predict_timeseries(x),
                               servable.predict_timeseries(x), rtol=1e-6)
    assert "rollout" in repr(loaded)
    again = Servable.load(servable.serialize(), device="cpu")
    np.testing.assert_allclose(again.predict_timeseries(x),
                               servable.predict_timeseries(x), rtol=1e-6)


def test_weights_are_baked_in():
    """The servable owns its weights, as the JAX artifact's constants: a
    model trained on after the export does not change it, and none of its
    tensors requires grad (the model's still do)."""
    net, _, x = _models()
    servable = export_rollout(net, x, 2)
    before = servable.predict_timeseries(x)
    with torch.no_grad():
        for p in net.base_model.parameters():
            p.mul_(0.5)
    assert all(p.requires_grad for p in net.base_model.parameters())
    program = servable.program
    assert not any(t.requires_grad for t in (*program.state_dict.values(),
                                             *program.constants.values()))
    assert np.array_equal(servable.predict_timeseries(x), before)
    assert not np.allclose(net.predict_timeseries(x, 2), before)


def test_scaler_travels_with_artifact():
    net, jnet, x = _models(scaler_type="standard")
    y = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    net.init_fit(x, y)
    jnet.init_fit(x, y)
    loaded = Servable.load(export_rollout(net, x, 4).serialize(),
                           device="cpu")
    got = loaded.predict_timeseries(x)
    np.testing.assert_allclose(got, net.predict_timeseries(x, 4), rtol=1e-5)
    want = np.asarray(jserve.export_rollout(
        jnet, x, 4, platforms=("cpu",)).predict_timeseries(x))
    assert _rel(got, want) <= TOL_JAX


def test_pinned_batch():
    net, _, x = _models()
    servable = export_rollout(net, x, 2, batch=4)
    assert servable.predict_timeseries(x).shape[1] == 4
    with pytest.raises(ValueError):
        servable.call(torch.zeros((5,) + x.shape[1:]))


def test_unfitted_model():
    net = DLWPNeuralNet(scaler_type=None, device="cpu")
    net.build_model([("CyclicConv2D", (4, 3), {})])
    with pytest.raises(ValueError, match="no parameters"):
        export_rollout(net, np.zeros((1, 4, 8, 16), np.float32), 2)


def test_bad_magic_and_truncation():
    with pytest.raises(ValueError, match="magic"):
        Servable.load(b"NOTDLWP" + b"\0" * 64, device="cpu")
    net, _, x = _models()
    blob = export_rollout(net, x, 2).serialize()
    with pytest.raises(ValueError, match="truncated"):
        Servable.load(blob[: len(blob) // 2], device="cpu")


def test_jax_artifact_refused_by_name():
    _, jnet, x = _models()
    blob = jserve.export_rollout(jnet, x, 2, platforms=("cpu",)).serialize()
    with pytest.raises(ValueError, match="dlwp_tpu servable artifact"):
        Servable.load(blob, device="cpu")


@pytest.mark.parametrize("bad", ["shape", "dtype", "count"])
def test_wrong_input_call(bad):
    net, _, x = _models()
    servable = export_rollout(net, x, 2)
    args = {"shape": (torch.zeros((2, 3, 8, 16)),),
            "dtype": (torch.zeros(x.shape, dtype=torch.float64),),
            "count": (torch.zeros(x.shape), torch.zeros(x.shape))}[bad]
    with pytest.raises(ValueError):
        servable.call(*args)


def test_custom_kind_has_no_timeseries():
    servable = export_program(lambda a: a * 2.0, (torch.ones(3),),
                              batch=None)
    np.testing.assert_allclose(servable.call(torch.ones(3)).numpy(), 2.0)
    with pytest.raises(ValueError, match="export_rollout"):
        servable.predict_timeseries(np.ones((3,), np.float32))


def _baro_pair():
    model = BarotropicModelPsi(LatLonGrid.regular(25, 48), truncation=15,
                               dt=1800.0, device="cpu")
    jmodel = JaxPsi(JaxGrid.regular(25, 48), truncation=15, dt=1800.0)
    return model, jmodel


def test_barotropic_roundtrip_and_parity(tmp_path):
    model, jmodel = _baro_pair()
    p = str(tmp_path / "baro.dlwpserve")
    export_barotropic(model, 2, 3, path=p)
    z0 = (100.0 * np.random.RandomState(0).randn(25, 48)).astype(np.float32)
    out = Servable.load(p, device="cpu").call(torch.from_numpy(z0)).numpy()
    assert out.shape == (2, 25, 48)
    _, _, eager = model.run_with_snapshots(model.from_z(z0), 2, 3)
    np.testing.assert_allclose(out, eager.numpy(), rtol=1e-5, atol=1e-4)
    want = np.asarray(jserve.export_barotropic(
        jmodel, 2, 3, platforms=("cpu",)).call(jnp.asarray(z0)))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-4)


def test_barotropic_batch_polymorphic():
    model, jmodel = _baro_pair()
    sv = export_barotropic(model, 2, 2, batch="b")
    jsv = jserve.export_barotropic(jmodel, 2, 2, batch="b",
                                   platforms=("cpu",))
    for B in (1, 3):
        z0 = (100.0 * np.random.RandomState(B).randn(B, 25, 48)).astype(
            np.float32)
        out = sv.call(torch.from_numpy(z0)).numpy()
        assert out.shape == (2, B, 25, 48)
        np.testing.assert_allclose(out, np.asarray(jsv.call(jnp.asarray(z0))),
                                   rtol=1e-5, atol=1e-4)


def test_kernel_model_rejected():
    model = BarotropicModelPsi(LatLonGrid.regular(25, 48), truncation=15,
                               dt=1800.0, step_impl="kernel", device="cpu")
    with pytest.raises(ValueError, match="step_impl='plain'"):
        export_barotropic(model, 2, 2)


TOL_BARO_JAX_F64 = 1e-14
FORMS = {"psi": (BarotropicModelPsi, JaxPsi), "vrt": (BarotropicModel, JaxVrt)}


def _small_baro(form, dtype):
    return FORMS[form][0](LatLonGrid.regular(13, 24), 7, dt=1800.0,
                          dtype=dtype, device="cpu")


def _z0_small(seed=0, lead=()):
    return (5500.0 + 100.0 * np.random.RandomState(seed).randn(
        *lead, 13, 24)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("form", list(FORMS))
def test_rolled_barotropic_export_at_the_reference_run(form, dtype):
    """export_barotropic(model, 24, 12): two programs of 12 steps, looped
    24 times by call after serialize and load, bit-equal to eager; in
    float64 also against the JAX servable (one scan)."""
    model = _small_baro(form, dtype)
    blob = export_barotropic(model, 24, 12).serialize()
    sv = Servable.load(blob, device="cpu")
    assert set(sv.programs) == {"first", "body"} and sv.meta["loop"] == 24
    z0 = _z0_small()
    got = sv.call(torch.from_numpy(z0))
    _, _, eager = model.run_with_snapshots(model.from_z(z0), 24, 12)
    assert got.shape == (24, 13, 24) and torch.equal(got, eager)
    if dtype == torch.float64:
        jm = FORMS[form][1](JaxGrid.regular(13, 24), 7, dt=1800.0,
                            dtype=jnp.float64)
        want = np.asarray(jserve.export_barotropic(
            jm, 24, 12, platforms=("cpu",)).call(jnp.asarray(z0)))
        assert want.dtype == np.float64
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL_BARO_JAX_F64, err


def test_rolled_barotropic_export_batched_is_bit_equal():
    model = _small_baro("psi", torch.float32)
    sv = export_barotropic(model, 3, 2, batch="b")
    for B in (1, 3):
        z0 = _z0_small(B, (B,))
        _, _, eager = model.run_with_snapshots(model.from_z(z0), 3, 2)
        assert torch.equal(sv.call(torch.from_numpy(z0)), eager)
    one = export_barotropic(model, 1, 2)
    assert set(one.programs) == {"first"}
    z0 = _z0_small(5)
    assert torch.equal(one.call(torch.from_numpy(z0)),
                       model.run_with_snapshots(model.from_z(z0), 1, 2)[2])


def test_rolled_export_holds_fewer_nodes_than_the_unrolled():
    """The same run, (6, 3), rolled against every step unrolled into one
    program (the export before the rolled form): fewer nodes, the same
    snapshots."""
    model = _small_baro("psi", torch.float32)

    def unrolled(z0):
        return model.run_with_snapshots(model.from_z(z0), 6, 3)[2]

    flat = export_program(unrolled, (torch.zeros(13, 24),), batch=None)
    rolled = export_barotropic(model, 6, 3)
    n_rolled = sum(len(p.graph.nodes) for p in rolled.programs.values())
    assert n_rolled < len(flat.program.graph.nodes)
    z0 = torch.from_numpy(_z0_small(2))
    assert torch.equal(rolled.call(z0), flat.call(z0))


def test_format_1_artifact_loads():
    """An artifact of the single-program layout (format 1: the program
    part is one saved program) still loads and runs."""
    import io
    import pickle

    from dlwp_torch.serve import _pack

    sv = export_program(lambda x: 2.0 * x, (torch.ones(2, 3),))
    blob = io.BytesIO()
    torch.export.save(sv.program, blob)
    meta = dict(sv.meta, format_version=1)
    old = _pack(meta, blob.getvalue(), pickle.dumps({}))
    back = Servable.load(old, device="cpu")
    assert torch.equal(back.call(torch.ones(4, 3)), torch.full((4, 3), 2.0))


def _calls(program):
    return [str(n.target) for m in program.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if n.op == "call_function"]


def _forecast(nlat=8, nlon=16, n=14):
    """The flagship forecast stack at 8x16 on the CPU, random weights."""
    rng = np.random.RandomState(0)
    data = PredictorDataset(
        predictors=rng.randn(n, 2, nlat, nlon).astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, nlat), lon=np.arange(nlon) * 22.5,
        mean=np.zeros(2, np.float32), std=np.ones(2, np.float32))
    net = DLWPNeuralNet(time_dim=2, is_recurrent=True, scaler_type=None,
                        device="cpu")
    net.build_model(convlstm_specs(nlat, nlon))
    sampler = SeriesSampler(data, model=net, input_time_steps=2,
                            output_time_steps=2, add_insolation=True)
    net.init(sampler.generate(np.arange(1))[0], seed=0)
    return TimeSeriesEstimator(net, sampler)


def test_forecast_servable_holds_the_kernel_ops_and_moves_whole():
    """The estimator's rollout exported on the CPU: both ops a step, equal
    to the eager rollout at batches 1..6 (the symbol is bounded by the
    insolation precompute's batch limit, and a larger batch is refused),
    and runnable after a move of the whole program to ``meta``."""
    est = _forecast()
    steps = 3
    x0, days, mean, _ = est.prepare_inputs(np.arange(6))
    limit = est.precompute_batch_limit(steps)
    rollout = est.rollout_fn(steps)
    servable = export_program(rollout, (x0, days, mean),
                              batch=Dim("b", max=limit), batched=(0, 1))
    calls = _calls(servable.program)
    assert sorted(c for c in calls if c in OPS) == sorted(
        ["dlwp_torch.fused_conv_pool.default"] * 2 * steps
        + ["dlwp_torch.lstm_gates.default"] * steps)
    assert servable.meta["batch_range"][1] == limit
    for B in (1, 2, 6):
        got = servable.call(x0[:B], days[:B], mean)
        assert torch.equal(got, rollout(x0[:B], days[:B], mean))
    big = limit + 1
    with pytest.raises(ValueError, match="axis 0"):
        servable.call(x0[:1].expand(big, *x0.shape[1:]),
                      days[:1].expand(big), mean)
    moved = move_to_device_pass(servable.program, "meta")
    tables = [*moved.state_dict.values(), *moved.constants.values()]
    assert tables and all(t.device.type == "meta" for t in tables)
    out = moved.module()(*(t.to("meta") for t in (x0, days, mean)))
    assert out.device.type == "meta" and out.shape == (steps, 6, 2, 2, 8, 16)


def test_export_program_batches_only_the_named_inputs():
    """At an example batch of 3 the estimator's ``mean_state`` (3, 8, 16)
    has the batch's length on axis 0; it is not batched unless named, so
    the servable serves batch 6 with the same ``mean_state``, equal to the
    eager rollout, and refuses another ``mean_state``."""
    est = _forecast()
    steps = 3
    x0, days, mean, _ = est.prepare_inputs(np.arange(6))
    assert mean.shape[0] == 3
    rollout = est.rollout_fn(steps)
    servable = export_program(
        rollout, (x0[:3], days[:3], mean), batched=(0, 1),
        batch=Dim("b", max=est.precompute_batch_limit(steps)))
    assert servable.meta["inputs"][2][0] == list(mean.shape)
    assert servable.meta["inputs"][0][0][0] == "b"
    got = servable.call(x0, days, mean)
    assert got.shape[1] == 6
    assert torch.equal(got, rollout(x0, days, mean))
    with pytest.raises(ValueError, match="input 2: axis 0"):
        servable.call(x0, days, mean[:2])


def test_export_program_refuses_a_symbolic_batch_traced_at_1(monkeypatch):
    """A symbolic batch traced at 1 is refused before ``torch.export``
    runs (export would specialise the size and fail on its constraint)."""
    est = _forecast()
    x0, days, mean, _ = est.prepare_inputs(np.arange(1))
    monkeypatch.setattr(torch.export, "export", lambda *a, **k: (
        pytest.fail("torch.export ran")))
    with pytest.raises(ValueError, match="2 or more"):
        export_program(est.rollout_fn(2), (x0, days, mean), batched=(0, 1))
    with pytest.raises(ValueError, match="2 or more"):
        export_program(lambda a: a * 2.0, (torch.ones(1, 3),))


def test_cpu_export_of_the_recurrent_rollout_holds_both_ops():
    net, _, x = _models("flagship", nlat=16, nlon=32)
    servable = export_rollout(net, x, 6)
    calls = [c for c in _calls(servable.program) if c in OPS]
    assert calls.count("dlwp_torch.fused_conv_pool.default") == 6
    assert calls.count("dlwp_torch.lstm_gates.default") == 3


def test_entry_matches_jax_and_exports():
    jfn, (jparams, jx) = __graft_entry__.entry()
    fn, (params, x) = entry(device="cpu")
    assert tuple(x.shape) == jx.shape
    model = build_sequential(convlstm_specs(), device="cpu")
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, jparams))
    same = dict(model.named_parameters())
    assert same.keys() == params.keys()
    xb = np.random.RandomState(3).randn(*jx.shape).astype(np.float32)
    want = np.asarray(jax.jit(jfn)(jparams, jnp.asarray(xb)))
    got = fn(same, torch.from_numpy(xb)).numpy()
    assert _rel(got, want) <= TOL_JAX
    servable = export_program(functools.partial(fn, same), (x,))
    assert torch.equal(servable.call(torch.from_numpy(xb)),
                       torch.from_numpy(got))
    assert OPS <= set(_calls(servable.program))


@pytest.mark.parametrize("case", ["padding", "fold", "spherical"])
def test_export_leaves_no_traced_tensor_in_a_cache(case):
    """The case's cache is emptied after an eager forward, so that its
    first build happens under the export (the padding indices of a periodic conv, the fold matrix of a
    dilation-2 conv-pool composition, an S2Convolution's engine)."""
    grid = s2_near_identity_grid(max_beta=0.2, n_alpha=12, n_beta=1)
    specs, shape, cache = {
        "padding": ([("CyclicConv2D", (4, 3), {"activation": "tanh"})],
                    (2, 3, 8, 16), _gather_index),
        "fold": ([("UpConv2D", (4, 3), {"activation": "tanh"})],
                 (2, 3, 8, 16), _fold_matrix),
        "spherical": ([("S2Convolution", (3, 4, 10, 6, grid),
                        {"mean_gamma": True, "activation": "tanh"})],
                      (2, 3, 19, 36), _engine),
    }[case]
    x = torch.from_numpy(
        np.random.RandomState(4).randn(*shape).astype(np.float32))
    model = build_sequential(specs, device="cpu")
    model.init(x[:1], seed=0)
    with torch.no_grad():
        want = model(x)
    cache.cache_clear()
    export_program(model, (x,))
    with torch.no_grad():
        got = model(x)
    for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        assert type(g) is torch.Tensor
        assert torch.equal(g, w)

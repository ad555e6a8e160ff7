"""The port's forecast path vs dlwp_tpu: dataset -> sampler -> model ->
TimeSeriesEstimator.predict, same data and weights, float64 on the CPU.

Checks values (1e-10), f_hour, init times, the channel source map (predicted,
imputed with the mean state, insolation recomputed per valid time), host
scaling, ``unscale``, and ``init_batch_size`` chunking with a padded last
chunk. Under x64 the JAX rollout carries float64 init days, as the port
always does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dlwp_tpu.data as jdata
from dlwp_tpu.forecast import TimeSeriesEstimator as JaxEstimator
from dlwp_tpu.models import DLWPNeuralNet as JaxNet

import dlwp_torch.forecast.rollout as port_rollout
from dlwp_torch import DLWPNeuralNet, PredictorDataset, SeriesSampler
from dlwp_torch import TimeSeriesEstimator
from dlwp_torch.flagship import convlstm_specs

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(2)
TOL = 1e-10
NLAT, NLON, C, TD = 8, 16, 2, 2

CASES = {
    # all channels predicted, insolation spliced in, chunked predict
    "flagship": dict(specs=convlstm_specs(NLAT, NLON, C, TD), output_sel=None,
                     scaler_type=None, samples=[0, 1, 2, 3, 4],
                     predict=dict(init_batch_size=2)),
    # THICK imputed with the mean state, host scaling, unscaled output
    "imputed": dict(
        specs=[
            ("ConvLSTM2D", (4, 3), {"dilation": 2, "activation": "tanh"}),
            ("Reshape", ((TD * 4, NLAT, NLON),), None),
            ("CyclicConv2D", (TD, 3), {}),
            ("Reshape", ((TD, 1, NLAT, NLON),), None),
        ],
        output_sel=["HGT/500"], scaler_type="standard", samples=[0, 2, 3],
        predict=dict(unscale=True),
    ),
    # 2 input and 3 output steps, the next window seeded from the last
    # outputs (prefer_first_times=False): it advances 3 steps, not 2
    "later_times": dict(
        specs=[
            ("ConvLSTM2D", (4, 3), {"dilation": 2, "activation": "tanh"}),
            ("Reshape", ((TD * 4, NLAT, NLON),), None),
            ("CyclicConv2D", (3 * C, 3), {}),
            ("Reshape", ((3, C, NLAT, NLON),), None),
        ],
        output_sel=None, scaler_type=None, samples=[0, 1, 4],
        steps=(TD, 3), predict=dict(prefer_first_times=False),
    ),
}


def _dataset_kwargs(seed=0, n=14):
    rng = np.random.RandomState(seed)
    return dict(
        predictors=rng.randn(n, C, NLAT, NLON),
        sample=(np.datetime64("2007-03-01T06")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, NLAT),
        lon=np.arange(NLON) * (360.0 / NLON),
        mean=rng.randn(C),
        std=1.0 + rng.rand(C),
    )


def _stack(net_cls, sampler_cls, dataset_cls, case, **net_kw):
    net = net_cls(time_dim=TD, is_recurrent=True,
                  scaler_type=case["scaler_type"], **net_kw)
    net.build_model(case["specs"])
    in_ts, out_ts = case.get("steps", (TD, TD))
    sampler = sampler_cls(
        dataset_cls(**_dataset_kwargs()), model=net, input_time_steps=in_ts,
        output_time_steps=out_ts, output_sel=case["output_sel"],
        add_insolation=True, dtype=np.float64,
    )
    if case["scaler_type"]:
        x, y = sampler.generate((), scale_and_impute=False)
        net.scaler_fit(x, y)
    return net, sampler


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    case = CASES[request.param]
    net, sampler = _stack(DLWPNeuralNet, SeriesSampler, PredictorDataset,
                          case, device="cpu")
    x, _ = sampler.generate(np.arange(1))
    net.base_model.init(torch.from_numpy(x), seed=5)
    tree = {"params": {
        f"layers_{i}": {k: jnp.asarray(p.numpy())
                        for k, p in layer.named_parameters()}
        for i, layer in enumerate(net.base_model.layers)
        if any(True for _ in layer.parameters())
    }}
    jnet, jsampler = _stack(JaxNet, jdata.SeriesSampler,
                            jdata.PredictorDataset, case)
    jnet.trainer.params = tree
    jest = JaxEstimator(jnet, jsampler)
    want = jest.predict(3, samples=case["samples"], **case["predict"])
    return case, TimeSeriesEstimator(net, sampler), jest, want


def test_predict_matches_jax(pair):
    case, est, jest, want = pair
    assert est._sources == jest._sources
    got = est.predict(3, samples=case["samples"], **case["predict"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.values, np.asarray(want.values), atol=TOL)
    name = got.varlev[-1]
    np.testing.assert_allclose(got.sel_varlev(name),
                               np.asarray(want.sel_varlev(name)), atol=TOL)
    np.testing.assert_array_equal(got.f_hour, want.f_hour)
    np.testing.assert_array_equal(got.times, want.times)
    assert got.varlev == want.varlev


def test_chunking_and_per_step_insolation_agree(pair, monkeypatch):
    case, est, _, _ = pair
    kw = {k: v for k, v in case["predict"].items() if k != "init_batch_size"}
    whole = est.predict(3, samples=case["samples"], **kw).values
    chunked = est.predict(3, samples=case["samples"], init_batch_size=2,
                          **kw).values
    np.testing.assert_allclose(chunked, whole, atol=1e-12)
    monkeypatch.setattr(port_rollout, "SOL_PRECOMPUTE_BUDGET", 0)
    per_step = est.predict(3, samples=case["samples"], **kw).values
    np.testing.assert_allclose(per_step, whole, atol=1e-12)


@pytest.mark.parametrize("scaler_type", ["standard", "minmax"])
def test_net_predict_scales_and_imputes_like_jax(scaler_type):
    """``DLWPNeuralNet.predict``: NaNs imputed with the fitted means, inputs
    scaled, outputs unscaled, in batches."""
    rng = np.random.RandomState(4)
    x = rng.randn(5, 3, NLAT, NLON)
    x[rng.rand(*x.shape) < 0.05] = np.nan
    y = 2.0 + 3.0 * rng.randn(5, 2, NLAT, NLON)
    specs = [("CyclicConv2D", (2, 3), {"activation": "tanh"})]
    nets = []
    for cls, kw in ((DLWPNeuralNet, {"device": "cpu"}), (JaxNet, {})):
        net = cls(scaler_type=scaler_type, impute_missing=True, **kw)
        net.build_model(specs)
        net.imputer_fit(x)
        net.scaler_fit(net.imputer_transform(x), y)
        nets.append(net)
    net, jnet = nets
    net.init(x, seed=2)
    jnet.trainer.params = {"params": {"layers_0": {
        k: jnp.asarray(p.numpy(), dtype=jnp.float64)
        for k, p in net.base_model.layers[0].named_parameters()}}}
    net.load_flax_params(jnet.trainer.params, dtype=torch.float64)
    got = net.predict(x, batch_size=2)
    assert got.shape == y.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jnet.predict(x)), atol=TOL)


def test_prepare_inputs_matches_jax(pair):
    case, est, jest, _ = pair
    x0, days, mean_state, times = est.prepare_inputs(case["samples"])
    jx0, jdays, jmean, jtimes = jest.prepare_inputs(case["samples"])
    assert days.dtype == torch.float64 and jdays.dtype == jnp.float64
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), atol=TOL)
    np.testing.assert_array_equal(days.numpy(), np.asarray(jdays))
    np.testing.assert_allclose(mean_state.numpy(), np.asarray(jmean),
                               atol=TOL)
    np.testing.assert_array_equal(times, jtimes)


def test_graph_rule_takes_the_eager_loop_off_the_card(pair, monkeypatch):
    """The graph path engages for CUDA operands of an unsharded model
    outside a trace; the CPU, a trace (``torch.export``) and a lat-sharded
    model take the eager loop."""
    _, est, _, _ = pair
    rule = port_rollout._replays_graphs
    assert rule(est.model, torch.device("cuda"))
    assert not rule(est.model, torch.device("cpu"))
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert not rule(est.model, torch.device("cuda"))


def test_graph_rule_takes_the_eager_loop_for_a_lat_sharded_model():
    from dlwp_torch.parallel import MeshConfig, build_mesh

    net = DLWPNeuralNet(time_dim=TD, is_recurrent=True, scaler_type=None,
                        device="cpu")
    mesh = build_mesh(MeshConfig(data=1, lat=2), devices=["cpu"] * 2)
    net.build_model(convlstm_specs(NLAT, NLON, C, TD), mesh=mesh,
                    batch_spec=("data", None, None, "lat", None))
    assert net._spatial is not None
    assert not port_rollout._replays_graphs(net, torch.device("cuda"))


def test_cpu_predict_replays_no_graph(pair):
    """A CPU forecast runs every step eagerly: no capture, no replay."""
    case, est, _, _ = pair
    port_rollout.reset_graph_counts()
    est.predict(3, samples=case["samples"])
    assert port_rollout.graph_counts() == {"captures": 0, "replays": 0,
                                           "eager_steps": 3}
    assert not est._graphs

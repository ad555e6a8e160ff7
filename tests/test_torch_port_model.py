"""The port's layers and ``build_sequential`` vs dlwp_tpu, weights carried over.

Each case makes a flax-layout tree of seeded random weights, applies the JAX
layer or model with it, loads the same tree into the port with
``load_flax_params``, and feeds both the same float64 input made with
numpy; tolerance 1e-10 (float64 rounding), 5e-2 for bf16 gates. The port runs on the CPU, where the kernel
wrappers take their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_tpu.models import build_sequential as jax_build
from dlwp_tpu.models import layers as JL

from dlwp_torch import build_sequential, load_flax_params, tree_from_leaves
from dlwp_torch.flagship import convlstm_specs
from dlwp_torch.models import layers as TL
from dlwp_torch.models.cnn import SequentialModel

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(2)
TOL = 1e-10


def _random_tree(model, x, seed=0):
    """A flax-layout tree of random weights for ``model``'s architecture
    (made by the port's seeded init, so the JAX side needs no init)."""
    model.init(torch.from_numpy(x), seed=seed)
    return {"params": {
        f"layers_{i}": {k: p.numpy().copy()
                        for k, p in layer.named_parameters()}
        for i, layer in enumerate(model.layers)
        if any(True for _ in layer.parameters())
    }}


def _run_layer(jax_layer, make_port_layer, x):
    """Same random weights through the JAX layer and a fresh port layer
    filled by ``load_flax_params``."""
    tree = _random_tree(SequentialModel([make_port_layer()], device="cpu"), x)
    want = np.asarray(jax.jit(jax_layer.apply)(
        {"params": tree["params"]["layers_0"]}, jnp.asarray(x)))
    model = SequentialModel([make_port_layer()], device="cpu")
    load_flax_params(model, tree, dtype=torch.float64)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("impl", ["pallas", "default"])
@pytest.mark.parametrize("T", [1, 2, 3, 6])
def test_convlstm_matches_jax(T, impl, monkeypatch):
    # 'default' is the JAX layer's XLA path, whose unrolled steps use the
    # joint zx+zh conv unless the environment overrides it.
    monkeypatch.delenv("DLWP_CONVLSTM_JOINT", raising=False)
    x = np.random.RandomState(T).randn(2, T, 3, 6, 8)
    kw = dict(features=4, kernel_size=3, dilation=2)
    jl = JL.ConvLSTM2D(**kw, gate_impl="pallas" if impl == "pallas" else "auto")
    got, want = _run_layer(jl, lambda: TL.ConvLSTM2D(4, 3, dilation=2), x)
    assert got.shape == (2, T, 4, 6, 8)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("option", [
    {"return_sequences": False},
    {"recurrent_activation": "sigmoid"},
    {"lat_mode": "edge"},
    {"kernel_size": 5, "dilation": 1},
])
def test_convlstm_options_match_jax(option, monkeypatch):
    monkeypatch.delenv("DLWP_CONVLSTM_JOINT", raising=False)
    x = np.random.RandomState(9).randn(2, 3, 3, 6, 8)
    kw = {"kernel_size": 3, "dilation": 2, **option}
    got, want = _run_layer(JL.ConvLSTM2D(features=4, **kw),
                           lambda: TL.ConvLSTM2D(4, **kw), x)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_convlstm_bf16_gates_match_jax():
    x = np.random.RandomState(10).randn(2, 3, 3, 6, 8)
    jl = JL.ConvLSTM2D(features=4, dilation=2, gate_dtype=jnp.bfloat16,
                       gate_impl="pallas")
    got, want = _run_layer(jl, lambda: TL.ConvLSTM2D(
        4, 3, dilation=2, gate_dtype="bfloat16"), x)
    np.testing.assert_allclose(got, want, atol=5e-2)


@pytest.mark.parametrize("dil", [1, 2])
def test_fused_conv_pool_layer_matches_jax(dil):
    x = np.random.RandomState(11).randn(2, 5, 8, 12)
    got, want = _run_layer(JL.FusedConvPool2D(features=6, dilation=dil),
                           lambda: TL.FusedConvPool2D(6, 3, dilation=dil), x)
    assert got.shape == (2, 6, 4, 6)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("specs", [
    [("UpSampling2D", (2,), None),
     ("CyclicConv2D", (5, 3), {"activation": "tanh"})],
    [("UpSampling2D", (2,), None),
     ("CyclicConv2D", (6, 3), {"dilation": 2, "activation": "tanh"}),
     ("CyclicConv2D", (3, 5), {"activation": "linear"})],
], ids=["upconv", "emit_small_chain"])
def test_upconv_chains_match_jax(specs):
    x = np.random.RandomState(12).randn(2, 4, 5, 8)
    jm = jax_build(specs)
    params = _random_tree(build_sequential(specs, device="cpu"), x)
    tm = build_sequential(specs, device="cpu")
    assert ([type(l).__name__ for l in tm.layers]
            == [type(l).__name__ for l in jm.layers])
    assert ([getattr(l, "emit_small", None) for l in tm.layers]
            == [getattr(l, "emit_small", None) for l in jm.layers])
    load_flax_params(tm, params, dtype=torch.float64)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, x)), atol=TOL)


@pytest.fixture(scope="module")
def flagship():
    """The fused ConvLSTM flagship at 8x16 in both packages, same weights."""
    specs = convlstm_specs(8, 16)
    x = np.random.RandomState(13).randn(2, 2, 3, 8, 16)
    jm = jax_build(specs)
    params = _random_tree(build_sequential(specs, device="cpu"), x, seed=1)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    return specs, x, jm, params, want


def test_flagship_matches_jax(flagship):
    specs, x, jm, params, want = flagship
    tm = build_sequential(specs, device="cpu")
    assert ([type(l).__name__ for l in tm.layers]
            == [type(l).__name__ for l in jm.layers])
    load_flax_params(tm, params, dtype=torch.float64)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2, 2, 8, 16)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_fused_and_unfused_towers_agree(flagship):
    specs, x, _, params, want = flagship
    outs = []
    for fuse in (True, False):
        tm = build_sequential(specs, fuse=fuse, device="cpu")
        load_flax_params(tm, params, dtype=torch.float64)
        with torch.inference_mode():
            outs.append(tm(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(outs[1], outs[0], atol=TOL)


def test_golden_convlstm_roll3():
    """tests/fixtures/update_golden.py:76-87, through the port in float64."""
    import os

    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "golden.npz"))
    tm = build_sequential(convlstm_specs(8, 16), device="cpu")
    leaves = [data[f"convlstm_param_{i}"] for i in range(15)]
    load_flax_params(tm, tree_from_leaves(tm, leaves), dtype=torch.float64)
    x = torch.from_numpy(data["convlstm_x0"])
    with torch.inference_mode():
        for _ in range(3):
            x = torch.cat([tm(x), x[:, :, 2:3]], dim=2)
    np.testing.assert_allclose(x.numpy(), data["convlstm_roll3"], atol=TOL)


@pytest.mark.parametrize("fault", ["missing_slot", "extra_key", "bad_shape"])
def test_load_flax_params_rejects(fault, flagship):
    specs, _, _, params, _ = flagship
    tree = {k: dict(v) for k, v in params["params"].items()}
    if fault == "missing_slot":
        del tree["layers_4"]
    elif fault == "extra_key":
        tree["layers_2"]["scale"] = np.ones(32)
    else:
        tree["layers_0"]["bias"] = np.zeros(47)
    tm = build_sequential(specs, device="cpu")
    with pytest.raises((KeyError, ValueError)):
        load_flax_params(tm, {"params": tree})


def test_random_init_is_seeded():
    specs = convlstm_specs(8, 16)
    x = torch.zeros(1, 2, 3, 8, 16)
    a = build_sequential(specs, device="cpu").init(x, seed=3)
    b = build_sequential(specs, device="cpu").init(x, seed=3)
    c = build_sequential(specs, device="cpu").init(x, seed=4)
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert pa.keys() == pb.keys() and len(pa) == 15
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["layers.2.kernel"], pc["layers.2.kernel"])
    assert pa["layers.0.recurrent_kernel"].shape == (48, 12, 3, 3)

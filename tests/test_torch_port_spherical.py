"""The port's spherical layers (``S2Convolution`` / ``SO3Convolution``) and
the ``examples/train_spherical.py`` stack against the JAX package on the
CPU.

Both packages compute these layers in float32 whatever the input's dtype
(float32 engines and parameters), so they are held at fp32 limits: a layer
within 2e-5 x the output's scale (the engines' sums run in another order,
over up to 19 x 36 points); the stack's forward the same; after 3 Adam
steps (lr 1e-3) the loss within 1e-5 relative and each parameter leaf
within 1e-3 relative RMS, since Adam's first steps move each weight by
about lr x sign(gradient) and fp32 noise decides the sign of the smallest
gradients. Weights cross both ways exactly.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_tpu.models import build_sequential as jax_build
from dlwp_tpu.models.spherical import S2Convolution as JS2
from dlwp_tpu.models.spherical import SO3Convolution as JSO3
from dlwp_tpu.models.spherical import s2_near_identity_grid as jax_s2_grid
from dlwp_tpu.train import TrainConfig as JConfig
from dlwp_tpu.train import Trainer as JTrainer

from dlwp_torch import build_sequential, flax_tree, load_flax_params
from dlwp_torch import load_optax_state
from dlwp_torch.models import S2Convolution, SO3Convolution
from dlwp_torch.models import s2_near_identity_grid
from dlwp_torch.models.spherical import _engine
from dlwp_torch.train import TrainConfig, Trainer

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(2)
RNG = jax.random.PRNGKey(3)
TOL_F32 = 2e-5  # x the output's scale
TOL_LOSS = 1e-5
TOL_PARAMS_RRMS = 1e-3


def _close(got, want, tol=TOL_F32):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _layer_pair(cls_port, cls_jax, args, kw, x):
    """The JAX layer's init on ``x`` loaded into the port's layer."""
    jl = cls_jax(*args, **kw)
    params = jax.tree.map(np.asarray, jl.init(RNG, jnp.asarray(x)))
    model = build_sequential([cls_port(*args, **kw)], device="cpu")
    load_flax_params(model, {"params": {"layers_0": params["params"]}})
    return jl, params, model


LAYER_CASES = [
    # (args, kwargs, input shape): the reference stack's two layers cut to
    # 19x36, keep_shape, a clamped b_in, b_out > b_in, no bias, an odd grid.
    ((3, 8, 10, 6, None), {"activation": "tanh"}, (2, 3, 19, 36)),
    ((8, 8, 6, 6, None), {"activation": "tanh"}, (2, 8, 12, 12)),
    ((2, 5, 9, 9, None), {"keep_shape": True}, (3, 2, 19, 36)),
    ((2, 4, 30, 5, None), {}, (1, 2, 17, 32)),
    ((2, 3, 4, 8, None), {"use_bias": False}, (2, 2, 13, 24)),
]


@pytest.mark.parametrize("cls", ["S2", "SO3"])
@pytest.mark.parametrize("case", range(len(LAYER_CASES)))
def test_layer_matches_jax(case, cls):
    args, kw, shape = LAYER_CASES[case]
    pair = (S2Convolution, JS2) if cls == "S2" else (SO3Convolution, JSO3)
    x = np.random.RandomState(case).randn(*shape).astype(np.float32)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        jl, params, model = _layer_pair(*pair, args, kw, x)
        want = jl.apply(params, jnp.asarray(x))
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_float64_input_computes_in_float32_as_jax():
    """A float64 input is analysed by the float32 engine and comes back
    float64, as in the JAX layer under x64; the parameters stay float32
    even when the tree is loaded as float64."""
    x = np.random.RandomState(4).randn(2, 3, 19, 36)
    jl = JS2(3, 4, 10, 6, None, activation="tanh")
    params = jax.tree.map(np.asarray, jl.init(RNG, jnp.asarray(x)))
    model = build_sequential([S2Convolution(3, 4, 10, 6, None,
                                            activation="tanh")], device="cpu")
    load_flax_params(model, {"params": {"layers_0": params["params"]}},
                     dtype=torch.float64)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    got = model(torch.from_numpy(x))
    want = jl.apply(params, jnp.asarray(x))
    assert got.dtype == torch.float64 and np.asarray(want).dtype == np.float64
    _close(got.numpy(), want)


def test_clamp_warning_and_refusals():
    layer = S2Convolution(2, 3, 30, 5, None)
    x = torch.randn(1, 2, 17, 32)
    model = build_sequential([layer], device="cpu")
    with pytest.warns(UserWarning, match="clamping to truncation 16"):
        model.init(x, seed=0)
    assert layer.spectral_kernel.shape == (5, 2, 3)
    with pytest.raises(NotImplementedError, match="mean_gamma"):
        build_sequential([S2Convolution(1, 1, 6, 6, None, mean_gamma=False)],
                         device="cpu").init(torch.zeros(1, 1, 12, 24), seed=0)
    with pytest.raises(ValueError, match="nfeature_in=3"):
        build_sequential([S2Convolution(3, 4, 6, 6, None)],
                         device="cpu").init(torch.zeros(1, 2, 12, 24), seed=0)
    # Parameters made for one grid refuse a grid of another degree count.
    small = build_sequential([S2Convolution(1, 1, 12, 12, None,
                                            keep_shape=True)], device="cpu")
    small.init(torch.zeros(1, 1, 9, 16), seed=0)
    with pytest.raises(ValueError, match="degrees"):
        small(torch.zeros(1, 1, 25, 48))


def test_init_scale_and_engine_cache():
    """normal(1/sqrt(C_in)) filters, zero bias; one engine per (grid,
    truncation, device), float32, shared by layers and calls."""
    layer = S2Convolution(16, 32, 12, 12, None)
    build_sequential([layer], device="cpu").init(
        torch.zeros(1, 16, 24, 24), seed=1)
    std = float(layer.spectral_kernel.std())
    assert abs(std - 0.25) < 0.02 and float(layer.bias.abs().max()) == 0.0
    a = _engine(24, 24, 11, torch.device("cpu"))
    assert a is _engine(24, 24, 11, torch.device("cpu"))
    assert a.dtype == torch.float32 and a.fourier == "matmul"


def test_longitudinal_rotation_equivariance():
    """A roll in longitude (an exact rotation about the polar axis) of a
    band-limited input rolls the output (keep_shape)."""
    eng = _engine(19, 36, 8, torch.device("cpu"))
    rs = np.random.RandomState(2)
    M = 9
    spec = (rs.randn(2, 3, M, M) + 1j * rs.randn(2, 3, M, M)) * eng.mask.numpy()
    spec[..., 0, :] = spec[..., 0, :].real
    x = eng.synthesize(torch.from_numpy(spec.astype(np.complex64)))
    model = build_sequential([S2Convolution(3, 5, 9, 9, None,
                                            keep_shape=True)], device="cpu")
    model.init(x, seed=0)
    y = model(x)
    for shift in (1, 7):
        _close(model(torch.roll(x, shift, -1)).numpy(),
               torch.roll(y, shift, -1).numpy())


def test_per_degree_eigenaction():
    """Y_l^m in, W[l] Y_l^m out: one weight per degree, the same for every
    m (what rotation equivariance requires of a spectral filter)."""
    eng = _engine(19, 36, 8, torch.device("cpu"))
    layer = S2Convolution(1, 1, 9, 9, None, use_bias=False, keep_shape=True)
    model = build_sequential([layer], device="cpu")
    for m, n in ((3, 6), (0, 6), (6, 6)):
        spec = torch.zeros(9, 9, dtype=torch.complex64)
        spec[m, n] = 1.0 - 0.25j if m else 1.0
        f = eng.synthesize(spec)[None, None]
        if not layer.built:
            model.init(f, seed=2)
        out = eng.analyze(model(f)[0, 0]).numpy()
        want = np.zeros((9, 9), np.complex64)
        want[m, n] = spec[m, n].item() * float(layer.spectral_kernel[n, 0, 0])
        np.testing.assert_allclose(out, want, atol=1e-5)


# ------------------------------------------------- the train_spherical stack
NLAT, NLON, TRUNC, FEAT = 19, 36, 6, 8


def stack_specs(grid_fn):
    """``examples/train_spherical.py``'s ``build_layer_specs`` at 19x36,
    b_in 10, truncation 6, 8 features (``tests/test_spherical.py``)."""
    g = grid_fn(max_beta=0.2, n_alpha=12, n_beta=1)
    return [
        ("S2Convolution", (3, FEAT, 10, TRUNC, g),
         {"mean_gamma": True, "activation": "tanh"}),
        ("S2Convolution", (FEAT, FEAT, TRUNC, TRUNC, g),
         {"mean_gamma": True, "activation": "tanh"}),
        ("TorchReshape", ((-1, FEAT * (2 * TRUNC) ** 2),), None),
        ("Linear", (FEAT * (2 * TRUNC) ** 2, 3 * NLAT * NLON), None),
        ("TorchReshape", ((-1, 3, NLAT, NLON),), None),
    ]


@pytest.fixture(scope="module")
def stack_tree():
    x = jnp.zeros((1, 3, NLAT, NLON), jnp.float32)
    params = jax_build(stack_specs(jax_s2_grid)).init(RNG, x)
    return jax.tree.map(np.asarray, params)


def _stack_data(n=6, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 3, NLAT, NLON).astype(np.float32)
    return x, (0.5 * x + 0.1 * rs.randn(*x.shape)).astype(np.float32)


def test_stack_forward_and_weight_round_trip(stack_tree):
    model = build_sequential(stack_specs(s2_near_identity_grid), device="cpu")
    load_flax_params(model, stack_tree)
    back = flax_tree(model)
    flat_w = jax.tree_util.tree_leaves_with_path(stack_tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_b)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_b[path], leaf)
    x, _ = _stack_data()
    want = jax_build(stack_specs(jax_s2_grid)).apply(stack_tree,
                                                     jnp.asarray(x))
    _close(model(torch.from_numpy(x)).detach().numpy(), want)


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.sqrt(np.mean((got - want) ** 2) / max(np.mean(want ** 2),
                                                    1e-30))


def test_stack_trains_as_jax_and_carries_adam_state(stack_tree):
    """3 Adam steps (``train_spherical.py``'s mse and adam, lr 1e-3) from
    the same weights and batches; then JAX's optax state carried into a
    fresh port trainer with ``load_optax_state`` and one more step on
    both."""
    x, y = _stack_data()
    cfg = dict(epochs=1, batch_size=2, learning_rate=1e-3, loss="mse",
               optimizer="adam", shuffle=False)
    jt = JTrainer(jax_build(stack_specs(jax_s2_grid)), JConfig(**cfg))
    jt.params = jax.tree.map(jnp.asarray, stack_tree)
    jt.opt_state = jt.tx.init(jt.params)
    want = jt.fit(x=x, y=y, verbose=False)
    model = build_sequential(stack_specs(s2_near_identity_grid), device="cpu")
    load_flax_params(model, stack_tree)
    got = Trainer(model, TrainConfig(**cfg)).fit(x=x, y=y, verbose=False)
    np.testing.assert_allclose(got.history["loss"], want.history["loss"],
                               rtol=TOL_LOSS)
    jp = jax.tree.map(np.asarray, jt.params)["params"]
    tp = flax_tree(model)["params"]
    for slot in jp:
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp[slot]):
            got_leaf = tp[slot]
            for k in path:
                got_leaf = got_leaf[k.key]
            assert _rel_rms(got_leaf, leaf) < TOL_PARAMS_RRMS, (slot, path)
    # Carry JAX's weights and optax state across, then one more step each.
    model2 = build_sequential(stack_specs(s2_near_identity_grid),
                              device="cpu")
    load_flax_params(model2, jax.tree.map(np.asarray, jt.params))
    pt2 = Trainer(model2, TrainConfig(**cfg))
    pt2.init(x[:1])
    load_optax_state(pt2.optimizer, jax.tree.map(np.asarray, jt.opt_state))
    jm = jt._jit_train_step(jt.params, jt.opt_state, jnp.asarray(x[:2]),
                            jnp.asarray(y[:2]))
    pm = pt2.train_step(x[:2], y[:2])
    np.testing.assert_allclose(float(pm["loss"]), float(jm[2]["loss"]),
                               rtol=TOL_LOSS)
    jp2 = jax.tree.map(np.asarray, jm[0])["params"]
    assert _rel_rms(flax_tree(model2)["params"]["layers_3"]["dense"]["kernel"],
                    jp2["layers_3"]["dense"]["kernel"]) < TOL_PARAMS_RRMS
    assert _rel_rms(flax_tree(model2)["params"]["layers_0"]["spectral_kernel"],
                    jp2["layers_0"]["spectral_kernel"]) < TOL_PARAMS_RRMS

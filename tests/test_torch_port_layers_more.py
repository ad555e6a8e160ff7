"""The port's remaining layers, ops and SkipTower vs dlwp_tpu, on the CPU.

- the padding functions, ``conv_pool2_even_dilation``, ``row_conv2d``
  and ``cyclic_conv2d_edgefix`` against the JAX functions;
- every name of the JAX ``LAYER_REGISTRY`` in the port's, and spec models
  of the new names built by ``build_sequential`` on both sides with one
  flax tree: the tree's layout equals the JAX ``init``'s, the forward
  agrees, and for ``Conv2D`` and ``RowConv2D`` the parameter gradient;
- ``SplitConvPool2D`` (both branches) with gradients;
- ``SkipTower`` unsharded at ``time_steps`` 0 and 2 (forward and
  parameter gradient) and its lat-band branch's forward on a mesh that
  repeats the CPU, as ``tests/test_torch_port_parallel.py`` runs it.

Inputs come from numpy seeds; JAX runs in float64 (the conftest's
x64), the port in float64, to 1e-10; the sharded branch in float32 to
1e-5, the bar of the port's other sharded tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from dlwp_tpu.models import build_sequential as jax_build
from dlwp_tpu.models import layers as JL
from dlwp_tpu.models.cnn import LAYER_REGISTRY as JAX_REGISTRY
from dlwp_tpu.models.unet import SkipTower as JSkipTower
from dlwp_tpu.ops import conv as jconv
from dlwp_tpu.ops import padding as jpad
from dlwp_tpu.parallel.spatial import SpatialSharding as JaxSpatial

from dlwp_torch import build_sequential, flax_tree, load_flax_params
from dlwp_torch import tree_from_leaves
from dlwp_torch.models import LAYER_REGISTRY, SkipTower, SplitConvPool2D
from dlwp_torch.models.cnn import SequentialModel
from dlwp_torch.ops import conv as tconv
from dlwp_torch.ops import padding as tpad
from dlwp_torch.ops.pooling import max_pool2d
from dlwp_torch.parallel import MeshConfig, SpatialSharding, build_mesh

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)
TOL = 1e-10
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _plain_convlstm_joint(monkeypatch):
    monkeypatch.delenv("DLWP_CONVLSTM_JOINT", raising=False)


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape)


def jax_out_and_grad(apply, params, x, ct):
    """``apply(params, x)`` and the parameter gradient of
    ``sum(apply(params, x) * ct)`` (the cotangent that ``jax.grad`` of the
    sum hands the output is ``ct``), from one compiled program."""
    def both(p):
        out, vjp = jax.vjp(lambda q: apply(q, x), p)
        return out, vjp(ct)[0]

    return jax.jit(both)(params)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize("padding", [1, (2, 3), ((2, 1), (0, 7)),
                                     ((5, 6), (9, 1))])
@pytest.mark.parametrize("fn", ["periodic", "fill", "constant", "reflect",
                                "symmetric"])
def test_padding_functions_match_jax(fn, padding):
    """Each padding function, amounts wider than the axis included (the
    last case pads 5 rows and 9 columns of a 4x6 grid)."""
    x = rand(2, 3, 4, 6)
    jfn, tfn, kw = {
        "periodic": (jpad.pad_periodic, tpad.pad_periodic, {}),
        "fill": (jpad.pad_fill, tpad.pad_fill, {}),
        "constant": (jpad.pad_constant, tpad.pad_constant, {"value": 0.5}),
        "reflect": (jpad.pad_reflect, tpad.pad_reflect, {}),
        "symmetric": (jpad.pad_reflect, tpad.pad_reflect,
                      {"symmetric": True}),
    }[fn]
    want = np.asarray(jfn(jnp.asarray(x), padding, **kw))
    got = tfn(torch.from_numpy(x), padding, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["group", "dense"])
@pytest.mark.parametrize("d", [2, 4])
def test_conv_pool2_even_dilation_matches_jax(d, form):
    x, k = rand(2, 3, 8, 16), rand(5, 3, 3, 3, seed=1)
    want = jconv.conv_pool2_even_dilation(jnp.asarray(x), jnp.asarray(k),
                                          (d, d), form=form)
    got = tconv.conv_pool2_even_dilation(torch.from_numpy(x),
                                         torch.from_numpy(k), (d, d),
                                         form=form)
    close(got, want)
    composed = max_pool2d(tconv.cyclic_conv2d(
        torch.from_numpy(x), torch.from_numpy(k), dilation=(d, d)))
    close(got, composed)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("mode", ["zero", "edge", "reflect", "symmetric",
                                  "no_wrap"])
def test_row_conv2d_matches_jax(mode, bias):
    x, bank = rand(2, 3, 6, 10), rand(6, 4, 3, 3, 5, seed=1)
    b = rand(6, 4, seed=2) if bias else None
    kw = (dict(lon_periodic=False) if mode == "no_wrap"
          else dict(lat_mode=mode))
    want = jconv.row_conv2d(jnp.asarray(x), jnp.asarray(bank),
                            None if b is None else jnp.asarray(b), **kw)
    got = tconv.row_conv2d(torch.from_numpy(x), torch.from_numpy(bank),
                           None if b is None else torch.from_numpy(b), **kw)
    close(got, want)


@pytest.mark.parametrize("ksize,d", [(3, 1), (3, 2), (5, 1), (4, 1), (2, 3)])
def test_cyclic_conv2d_edgefix_matches_jax(ksize, d):
    """Against the JAX function and against the port's wrap-padded conv,
    odd and even kernels."""
    x, k = rand(2, 3, 6, 12), rand(4, 3, ksize, ksize, seed=1)
    want = jconv.cyclic_conv2d_edgefix(jnp.asarray(x), jnp.asarray(k),
                                       (d, d))
    got = tconv.cyclic_conv2d_edgefix(torch.from_numpy(x),
                                      torch.from_numpy(k), (d, d))
    close(got, want)
    close(got, tconv.cyclic_conv2d(torch.from_numpy(x), torch.from_numpy(k),
                                   dilation=(d, d)))


# ------------------------------------------------------------ registry
def test_registry_has_every_jax_name():
    # Every JAX name, and beyond them only the cubed-sphere layers, which
    # the JAX package does not have.
    cube = {"CubeUNet", "CubeSpherePadding2D", "CubeSphereConv2D",
            "CubeAveragePooling2D", "CubeUpSampling2D"}
    assert set(LAYER_REGISTRY) - cube == set(JAX_REGISTRY)
    assert cube <= set(LAYER_REGISTRY) and not cube & set(JAX_REGISTRY)
    # The spherical names build the spectral layers and match JAX at fp32
    # limits (their own tests: tests/test_torch_port_spherical.py).
    x = rand(2, 1, 16, 16).astype(np.float32)
    for name in ("S2Convolution", "SO3Convolution"):
        spec = [(name, (1, 1, 8, 8, "dh"), None)]
        jm = jax_build(spec)
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)))
        model = build_sequential(spec, device="cpu")
        load_flax_params(model, params)
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want,
                                   rtol=0, atol=2e-5 * np.abs(want).max())
    for build in (jax_build, lambda s: build_sequential(s, device="cpu")):
        with pytest.raises(ValueError, match="lead with -1"):
            build([("TorchReshape", ((4, 3, 8),), None)])


H, W = 8, 16
SPECS = {
    "conv2d_same_stride2_even": (
        (2, 3, H, W),
        [("Conv2D", (4, 4), {"strides": (2, 2), "padding": "same",
                             "activation": "tanh"}),
         ("Conv2D", (3, 2), {"padding": "SAME", "dilation_rate": 2}),
         ("Conv2D", (2, (3, 2)), {"strides": (2, 1)})]),
    "padding_2d": (
        (2, 3, H, W),
        [("PeriodicPadding2D", ((0, 2),), None),
         ("ZeroPadding2D", ((1, 0),), None),
         ("Conv2D", (3, 3), {"use_bias": False}),
         ("FillPadding2D", (1,), None),
         ("TFPadding2D", (((1, 2), (2, 1)),), {"mode": "symmetric"}),
         ("TFPadding2D", ((2, 1),), {"mode": "REFLECT"}),
         ("TFPadding2D", (), {"padding": 2, "constant_values": 0.5})]),
    "padding_3d": (
        (2, 2, 3, 6, 8),
        [("PeriodicPadding3D", ((0, 1, 2),), None),
         ("ZeroPadding3D", (1,), None),
         ("FillPadding3D", (((1, 0), (0, 1), (2, 2)),), None),
         ("TFPadding3D", (1,), {"mode": "SYMMETRIC"}),
         ("TFPadding3D", (), {"mode": "REFLECT"})]),
    "row_conv": (
        (2, 3, H, W),
        [("RowConv2D", (4, 3), {"activation": "tanh", "lat_mode": "edge"}),
         ("RowConnected2D", (2, (3, 5)), {"use_bias": False})]),
    "pool_dense_slice": (
        (2, 3, H, W),
        [("slice_layer", (0, 2, 1), None),
         ("AveragePooling2D", (2,), None),
         ("Reshape", ((2 * H * W // 4,),), None),
         ("Dense", (6,), {"activation": "tanh"}),
         ("Linear", (6, 5), None),
         ("TorchReshape", ((-1, 5, 1),), None)]),
    "edgefix": (
        (2, 3, H, W),
        [("CyclicConv2D", (4, 3), {"impl": "edgefix", "dilation": 2,
                                   "activation": "tanh"}),
         ("CyclicConv2D", (3, 5), {"impl": "edgefix"}),
         ("CyclicConv2D", (2, 4), {"impl": "edgefix", "lat_mode": "edge"})]),
}


def _tree_paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_tree_paths(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("case", sorted(SPECS))
def test_spec_models_match_jax(case):
    """The port's tree has the JAX init's layout and shapes; forward to
    1e-10; for the weighted cases also the parameter gradient."""
    shape, specs = SPECS[case]
    x = rand(*shape, seed=3)
    tm = build_sequential(specs, device="cpu")
    tm.init(torch.from_numpy(x), seed=1)
    tree = flax_tree(tm)
    jm = jax_build(specs)
    layout = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    assert _tree_paths(tree) == _tree_paths(layout)
    jtree = jax.tree.map(jnp.asarray, tree)
    g = rand(*jax.eval_shape(jm.apply, jtree, jnp.asarray(x)).shape, seed=4)
    want, jgrad = jax_out_and_grad(jm.apply, jtree, jnp.asarray(x), g)
    want = np.asarray(want)
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    close(got.detach(), want)
    if not tree["params"]:
        return
    params = list(tm.parameters())
    for p in params:
        p.requires_grad_(True)
    (tm(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    for name, p in tm.named_parameters():
        parts = name.split(".")
        node = jax.tree.map(np.asarray, jgrad)["params"]
        for key in [f"layers_{parts[1]}"] + parts[2:]:
            node = node[key]
        close(p.grad, node)


@pytest.mark.parametrize("act", ["tanh", "gelu"])
@pytest.mark.parametrize("d", [1, 2])
def test_split_conv_pool_matches_jax(d, act):
    """Both branches: the parity-plane form (even dilation, monotone
    activation) and conv -> activation -> pool; forward and gradient."""
    x = rand(2, 3, H, W, seed=5)
    tm = SequentialModel([SplitConvPool2D(6, 4, 3, dilation=d,
                                          activation=act)], device="cpu")
    tm.init(torch.from_numpy(x), seed=2)
    leaves = flax_tree(tm)["params"]["layers_0"]
    jl = JL.SplitConvPool2D(features=6, keep=4, dilation=d, activation=act)
    jp = {"params": jax.tree.map(jnp.asarray, leaves)}
    g1, g2 = (rand(*w.shape, seed=6 + i) for i, w in enumerate(
        jax.eval_shape(jl.apply, jp, jnp.asarray(x))))
    # The gradient of sum(a * g1) + sum(b * g2).
    want, jgrad = jax_out_and_grad(jl.apply, jp, jnp.asarray(x), (g1, g2))
    jgrad = jgrad["params"]
    got = tm(torch.from_numpy(x))
    for a, b in zip(got, want):
        close(a.detach(), b)
    layer = tm.layers[0]
    for p in layer.parameters():
        p.requires_grad_(True)
    a, b = tm(torch.from_numpy(x))
    ((a * torch.from_numpy(g1)).sum() + (b * torch.from_numpy(g2)).sum()
     ).backward()
    close(layer.kernel.grad, jgrad["kernel"])
    close(layer.bias.grad, jgrad["bias"])


# ------------------------------------------------------------ SkipTower
@pytest.mark.parametrize("time_steps", [0, 2])
def test_skip_tower_matches_jax(time_steps):
    """The tree of a SkipTower in a SequentialModel slot has the JAX
    module's names and shapes; forward and parameter gradient."""
    shape = (2, 3, H, W) if not time_steps else (2, time_steps, 3, H, W)
    x = rand(*shape, seed=7)
    tm = build_sequential([SkipTower(2, width=8, time_steps=time_steps,
                                     lstm_features=4)], device="cpu")
    tm.init(torch.from_numpy(x), seed=3)
    tree = flax_tree(tm)
    jm = JSkipTower(c_out=2, width=8, time_steps=time_steps, lstm_features=4)
    layout = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    assert (_tree_paths(tree["params"]["layers_0"])
            == _tree_paths(layout["params"]))
    jp = {"params": jax.tree.map(jnp.asarray, tree["params"]["layers_0"])}
    g = rand(*jax.eval_shape(jm.apply, jp, jnp.asarray(x)).shape, seed=8)
    want, jgrad = jax_out_and_grad(jm.apply, jp, jnp.asarray(x), g)
    want = np.asarray(want)
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 2, H, W)
    close(got.detach(), want)
    for p in tm.parameters():
        p.requires_grad_(True)
    (tm(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    flat = {"/".join(k): v for k, v in _flat(
        jax.tree.map(np.asarray, jgrad)["params"]).items()}
    for name, p in tm.named_parameters():
        close(p.grad, flat["/".join(name.split(".")[2:])])
    # tree_from_leaves orders nested leaves as jax.tree_util does.
    leaves = jax.tree.leaves(jax.tree.map(np.asarray, {"params": {
        "layers_0": jp["params"]}}))
    again = build_sequential([SkipTower(2, width=8, time_steps=time_steps,
                                        lstm_features=4)], device="cpu")
    load_flax_params(again, tree_from_leaves(again, leaves),
                     dtype=torch.float64)
    with torch.no_grad():
        close(again(torch.from_numpy(x)), want)


def _flat(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)))
    return out


def test_skip_tower_spatial_branch_matches_jax():
    """The lat-band branch (plain CyclicConv2Ds, names _0.._5) on a lat=2
    mesh: the JAX module on 2 virtual CPU devices with interpret-mode
    kernels, the port on a mesh repeating the CPU (plain versions)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    x = rand(2, 2, 3, 16, 32, seed=9).astype(np.float32)
    ps = SpatialSharding(build_mesh(MeshConfig(data=1, lat=2),
                                    devices=[CPU] * 2),
                         data_axis=None, impl="overlap")
    js = JaxSpatial(mesh=JaxMesh(np.asarray(jax.devices()[:2]), ("lat",)),
                    data_axis=None, impl="overlap", interpret=True)
    tm = build_sequential([SkipTower(2, width=8, time_steps=2,
                                     lstm_features=4)], spatial=ps,
                          device="cpu")
    assert tm.layers[0].spatial is ps
    assert sorted(n for n, _ in tm.layers[0].named_children()) == [
        "ConvLSTM2D_0"] + [f"CyclicConv2D_{i}" for i in range(6)]
    tm.init(torch.from_numpy(x), seed=4)
    leaves = flax_tree(tm)["params"]["layers_0"]
    jm = JSkipTower(c_out=2, width=8, time_steps=2, lstm_features=4,
                    spatial=js)
    want = np.asarray(jax.jit(jm.apply)(
        {"params": jax.tree.map(jnp.asarray, leaves)}, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

"""Every keyword of the optax factories behind the port's optimizer names
(``dlwp_torch.train.optim``), against optax itself in float64.

For each name and each keyword optax takes beyond the learning rate, a
value other than optax's default: five steps from the same parameters and
gradients, through ``resolve_optimizer`` of the JAX package and of the
port, to 1e-12. A keyword optax does not know raises in both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dlwp_tpu.train.trainer import resolve_optimizer as jax_optimizer

from dlwp_torch.train.trainer import resolve_optimizer

TOL = 1e-12
LR = 3e-2

# The mask of adamw / lion: decay the kernels, not the bias.
JAX_MASK = {"layers_0": {"kernel": True, "bias": False},
            "layers_2": {"kernel": True}}
PORT_MASK = {"layers.0.kernel": True, "layers.0.bias": False,
             "layers.2.kernel": True}

CASES = [
    ("adam", {"eps_root": 1e-3}, None),
    ("adam", {"nesterov": True}, None),
    ("adam", {"mu_dtype": "float32"}, None),
    ("adam", {"b1": 0.8, "b2": 0.99, "eps": 1e-6}, None),
    ("adamw", {"eps_root": 1e-3, "weight_decay": 0.05}, None),
    ("adamw", {"nesterov": True}, None),
    ("adamw", {"mu_dtype": "float32"}, None),
    ("adamw", {"weight_decay": 0.05, "mask": "tree"}, None),
    ("adamw", {"weight_decay": 0.05, "mask": "callable"}, None),
    ("sgd", {"momentum": 0.9, "accumulator_dtype": "float32"}, None),
    ("sgd", {"momentum": 0.5, "nesterov": True}, None),
    ("rmsprop", {"initial_scale": 1.0}, None),
    ("rmsprop", {"eps_in_sqrt": False}, None),
    ("rmsprop", {"centered": True, "initial_scale": 1.0}, None),
    ("rmsprop", {"momentum": 0.9}, None),
    ("rmsprop", {"momentum": 0.9, "nesterov": True}, None),
    ("rmsprop", {"bias_correction": True}, None),
    ("rmsprop", {"centered": True, "bias_correction": True,
                 "eps_in_sqrt": False}, None),
    ("rmsprop", {"momentum": 0.9}, "schedule"),
    ("adagrad", {"eps": 1e-3, "initial_accumulator_value": 0.5}, None),
    ("lion", {"mu_dtype": "float32", "b1": 0.8}, None),
    ("lion", {"weight_decay": 0.05, "mask": "tree"}, None),
    ("lion", {"weight_decay": 0.05, "mask": "callable"}, None),
]


def _ids():
    out = []
    for name, kw, lr in CASES:
        parts = [f"{k}={v}" for k, v in kw.items()]
        out.append("-".join([name] + parts + ([lr] if lr else [])))
    return out


def _params():
    rs = np.random.RandomState(11)
    return {"params": {"layers_0": {"kernel": rs.randn(4, 3, 3, 3),
                                    "bias": rs.randn(4)},
                       "layers_2": {"kernel": rs.randn(2, 4, 5, 5)}}}


def _keywords(kw, port):
    """The case's keywords for one side: dtype names as each takes them,
    the mask as a tree (optax) or a name mapping (the port), or a
    callable that returns it."""
    out = dict(kw)
    for key in ("mu_dtype", "accumulator_dtype"):
        if key in out:
            out[key] = (getattr(torch, out[key]) if port
                        else jnp.dtype(out[key]))
    if "mask" in out:
        want = PORT_MASK if port else {"params": JAX_MASK}
        out["mask"] = want if out["mask"] == "tree" else (lambda p: want)
    return out


@pytest.mark.parametrize("name,kw,lr_kind", CASES, ids=_ids())
def test_optax_keyword_matches_optax(name, kw, lr_kind):
    params = _params()
    rs = np.random.RandomState(12)
    grads = [jax.tree.map(lambda p: rs.randn(*p.shape)
                          * 10.0 ** rs.randint(-3, 2), params)
             for _ in range(5)]
    lr = (optax.cosine_decay_schedule(LR, 4, 0.1) if lr_kind == "schedule"
          else LR)
    tx = jax_optimizer(name, lr, **_keywords(kw, port=False))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)

    tensors = {f"layers.{slot[7:]}.{k}": torch.tensor(v, requires_grad=True)
               for slot, leaves in params["params"].items()
               for k, v in leaves.items()}
    port_lr = ((lambda c: float(optax.cosine_decay_schedule(LR, 4, 0.1)(c)))
               if lr_kind == "schedule" else LR)
    opt = resolve_optimizer(name, port_lr, **_keywords(kw, port=True))(
        list(tensors.items()))
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for key, t in tensors.items():
            _, i, leaf = key.split(".")
            t.grad = torch.from_numpy(g["params"][f"layers_{i}"][leaf])
        opt.step()
        for key, t in tensors.items():
            _, i, leaf = key.split(".")
            np.testing.assert_allclose(
                t.detach().numpy(),
                np.asarray(jp["params"][f"layers_{i}"][leaf]),
                rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("name,bad", [
    ("adam", "mask"), ("adam", "weight_decay"), ("sgd", "eps"),
    ("rmsprop", "mu_dtype"), ("adagrad", "momentum"), ("lion", "eps"),
    ("adamw", "centered"),
])
def test_a_keyword_optax_does_not_know_raises(name, bad):
    with pytest.raises(TypeError):
        jax_optimizer(name, LR, **{bad: 0.5})
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(TypeError):
        resolve_optimizer(name, LR, **{bad: 0.5})([("w", t)])


def test_a_mask_without_parameter_names_raises():
    t = torch.zeros(3, requires_grad=True)
    opt = resolve_optimizer("adamw", LR, mask={"w": False})([t])
    t.grad = torch.ones(3)
    with pytest.raises(ValueError, match="named parameters"):
        opt.step()

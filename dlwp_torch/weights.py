"""Carry flax parameter trees and barotropic states into the port.

A flax ``SequentialModel`` keeps its parameters as
``{"params": {"layers_{i}": {name: array}}}``. The port's
``SequentialModel.layers[i]`` holds the same names with the same shapes
(OIHW ``kernel`` and ``bias``; ``input_kernel``, ``recurrent_kernel`` and
``bias`` for ``ConvLSTM2D``), so loading is a checked one-to-one copy.

:func:`flax_tree` takes the weights out again in that layout, and
:func:`load_optax_adam_state` carries an optax Adam state into the port's
:class:`~dlwp_torch.train.optim.Adam`, so a run of the JAX package can be
continued here.

The barotropic core has no weights; its state is what crosses:
:func:`barotropic_state_from_numpy` resumes a JAX ``BarotropicState`` taken
out as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from dlwp_torch.barotropic.model import BarotropicState
from dlwp_torch.device import resolve_device
from dlwp_torch.models.layers import ParamLayer


def _param_layers(model) -> dict[str, ParamLayer]:
    return {
        f"layers_{i}": layer for i, layer in enumerate(model.layers)
        if isinstance(layer, ParamLayer)
    }


def load_flax_params(model, params, dtype=torch.float32) -> None:
    """Fill ``model`` (a port ``SequentialModel``) from a flax tree given as
    nested dicts of numpy arrays. Raises on a missing key, an extra key or
    a wrong shape; tensors land on ``model.device`` in ``dtype``."""
    tree = params.get("params", params)
    slots = _param_layers(model)
    extra = sorted(set(tree) - set(slots))
    missing = sorted(set(slots) - set(tree))
    if extra or missing:
        raise KeyError(f"flax tree slots: extra {extra}, missing {missing}")
    staged = {}
    for slot, layer in slots.items():
        leaves = tree[slot]
        c_in = np.shape(leaves.get("input_kernel", leaves.get("kernel")))
        expect = layer.param_shapes(c_in[1] if len(c_in) > 1 else -1)
        extra = sorted(set(leaves) - set(expect))
        missing = sorted(set(expect) - set(leaves))
        if extra or missing:
            raise KeyError(f"{slot}: extra keys {extra}, missing {missing}")
        for name, shape in expect.items():
            got = tuple(np.shape(leaves[name]))
            have = getattr(layer, name)
            if got != tuple(shape) or (have is not None
                                       and tuple(have.shape) != got):
                raise ValueError(
                    f"{slot}.{name}: flax shape {got}, layer expects "
                    f"{tuple(shape) if have is None else tuple(have.shape)}"
                )
            staged[(slot, name)] = torch.tensor(
                np.asarray(leaves[name]), dtype=dtype, device=model.device
            )
    for (slot, name), val in staged.items():
        setattr(slots[slot], name, nn.Parameter(val, requires_grad=False))


def flax_tree(model) -> dict:
    """``model``'s weights as a flax-layout tree of numpy arrays (the
    inverse of :func:`load_flax_params`)."""
    return {"params": {
        slot: {name: p.detach().cpu().numpy()
               for name, p in layer.named_parameters(recurse=False)}
        for slot, layer in _param_layers(model).items()
    }}


def _adam_state(opt_state):
    """The first (count, mu, nu) in an optax state: a ``ScaleByAdamState``
    (or any object or dict with those fields), possibly inside the tuples
    of an optax chain."""
    if isinstance(opt_state, dict) and {"count", "mu", "nu"} <= set(opt_state):
        return opt_state["count"], opt_state["mu"], opt_state["nu"]
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


@torch.no_grad()
def load_optax_adam_state(optimizer, opt_state) -> None:
    """Fill ``optimizer`` (the port's :class:`~dlwp_torch.train.optim.Adam`
    over a ``SequentialModel``'s ``named_parameters()``, as the trainer
    builds it) from an optax Adam state given as numpy arrays: the step
    ``count`` and the ``mu`` and ``nu`` trees in flax ``layers_{i}``
    slots. Raises when a parameter has no moment, a moment no parameter, or
    shapes differ."""
    found = _adam_state(opt_state)
    if found is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    count, mu, nu = found
    mu, nu = mu.get("params", mu), nu.get("params", nu)
    seen = set()
    for group in optimizer.param_groups:
        names = group.get("param_names")
        if names is None:
            raise ValueError("the optimizer needs named parameters: build it "
                             "over model.named_parameters()")
        for name, p in zip(names, group["params"]):
            parts = name.split(".")
            if len(parts) != 3 or parts[0] != "layers":
                raise ValueError(f"parameter {name!r} is not a layer weight")
            slot, leaf = f"layers_{parts[1]}", parts[2]
            try:
                m, v = np.asarray(mu[slot][leaf]), np.asarray(nu[slot][leaf])
            except KeyError:
                raise KeyError(f"no moment for {slot}.{leaf}") from None
            if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
                raise ValueError(f"{slot}.{leaf}: moments {m.shape}, "
                                 f"parameter {tuple(p.shape)}")
            optimizer.state[p] = {
                "count": int(np.asarray(count)),
                "mu": torch.tensor(m, dtype=p.dtype, device=p.device),
                "nu": torch.tensor(v, dtype=p.dtype, device=p.device),
            }
            seen.add((slot, leaf))
    extra = sorted(f"{slot}.{leaf}" for slot in mu for leaf in mu[slot]
                   if (slot, leaf) not in seen)
    if extra:
        raise KeyError(f"moments without a parameter: {extra}")


def tree_from_leaves(model, leaves) -> dict:
    """Rebuild the flax tree of ``model``'s architecture from its leaves in
    ``jax.tree_util`` order (dict keys sorted as strings, so ``layers_10``
    comes before ``layers_2``). Leaf shapes are checked by
    :func:`load_flax_params`."""
    slots = _param_layers(model)
    names = [(slot, name) for slot in sorted(slots)
             for name in sorted(slots[slot].param_shapes(1))]
    leaves = list(leaves)
    if len(leaves) != len(names):
        raise ValueError(f"{len(leaves)} leaves for {len(names)} parameters")
    tree = {slot: {} for slot in slots}
    for (slot, name), leaf in zip(names, leaves):
        tree[slot][name] = leaf
    return {"params": tree}


def barotropic_state_from_numpy(vrt_spec, vrt_spec_prev, step, t,
                                device=None) -> BarotropicState:
    """A :class:`BarotropicState` from numpy arrays (e.g. a JAX state's
    ``np.asarray`` fields): complex spectra (..., T+1, T+1) on ``device``
    (``None`` -> ``cuda``) in their own precision, ``step`` as an int and
    ``t`` as a host 0-d tensor of the matching real dtype."""
    dev = resolve_device(device)
    cur, prev = np.asarray(vrt_spec), np.asarray(vrt_spec_prev)
    if not (np.iscomplexobj(cur) and cur.shape == prev.shape
            and cur.dtype == prev.dtype):
        raise ValueError(
            f"vrt_spec {cur.dtype}{cur.shape} and vrt_spec_prev "
            f"{prev.dtype}{prev.shape} must be complex of one shape and dtype"
        )
    real = torch.float64 if cur.dtype == np.complex128 else torch.float32
    return BarotropicState(
        vrt_spec=torch.tensor(cur, device=dev),
        vrt_spec_prev=torch.tensor(prev, device=dev),
        step=int(step),
        t=torch.tensor(float(np.asarray(t)), dtype=real),
    )

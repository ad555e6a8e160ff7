"""Carry flax parameter trees and barotropic states into the port.

A flax ``SequentialModel`` keeps its parameters as ``{"params":
{"layers_{i}": ...}}``, with the module names of nested modules below a
slot (``SkipTower``'s ``CyclicConv2D_0``, ``UpConv2D_0``, ...; ``Dense``'s
``dense``). The port's modules carry the same names, so a parameter
``layers.{i}.a.b.leaf`` of the port is the flax leaf ``layers_{i}/a/b/leaf``
with the same shape: OIHW ``kernel`` and ``bias``; ``input_kernel``,
``recurrent_kernel`` and ``bias`` for ``ConvLSTM2D``; the (H, O, C, kh, kw)
bank and (H, O) bias of ``RowConv2D``; Dense's (in, out) kernel, which the
port multiplies as flax does (``x @ kernel``), so nothing is transposed.
Loading is a checked one-to-one copy.

:func:`flax_tree` takes the weights out again in that layout;
:func:`load_optax_adam_state` carries an optax Adam state into the port's
:class:`~dlwp_torch.train.optim.Adam`, and :func:`load_optax_state` a
chained one (``clip_by_global_norm``, adam, a schedule's count), so a run
of the JAX package can be continued here.

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


def _flax_path(name: str) -> tuple[str, ...]:
    """A port module or parameter name ``layers.{i}.a.b`` as its flax path
    ``("layers_{i}", "a", "b")``."""
    parts = name.split(".")
    if len(parts) < 2 or parts[0] != "layers":
        raise ValueError(f"{name!r} is not inside a layer slot")
    return (f"layers_{parts[1]}",) + tuple(parts[2:])


def _param_layers(model) -> dict[tuple[str, ...], ParamLayer]:
    """Every parameter layer of ``model``, nested ones too, by flax path."""
    return {_flax_path(name): m for name, m in model.named_modules()
            if isinstance(m, ParamLayer)}


def _flatten(tree, prefix=()) -> dict[tuple[str, ...], object]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (k,)))
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def load_flax_params(model, params, dtype=torch.float32) -> None:
    """Fill ``model`` (a port ``SequentialModel``) from a flax tree given as
    nested dicts of numpy arrays. Raises on a missing leaf, an extra leaf
    or a wrong shape; tensors land on ``model.device`` in ``dtype`` (in the
    layer's ``param_dtype`` where it has one: the spherical layers' float32
    ``spectral_kernel`` (n_deg, C_in, C_out) and ``bias``, whose degree
    count the shape check reads from the tree)."""
    flat = _flatten(params.get("params", params))
    layers = _param_layers(model)
    slots = {path + (n,) for path, layer in layers.items()
             for n in layer.param_names()}
    extra = sorted("/".join(p) for p in set(flat) - slots)
    missing = sorted("/".join(p) for p in slots - set(flat))
    if extra or missing:
        raise KeyError(f"flax tree leaves: extra {extra}, missing {missing}")
    staged = {}
    for path, layer in layers.items():
        slot = "/".join(path)
        shapes = {n: tuple(np.shape(flat[path + (n,)]))
                  for n in layer.param_names()}
        expect = layer.param_shapes(layer.flax_dims(shapes))
        for name, shape in expect.items():
            got = shapes[name]
            have = getattr(layer, name)
            if got != tuple(shape) or (have is not None
                                       and tuple(have.shape) != got):
                raise ValueError(
                    f"{slot}/{name}: flax shape {got}, layer expects "
                    f"{tuple(shape) if have is None else tuple(have.shape)}"
                )
            staged[(layer, name)] = torch.tensor(
                np.asarray(flat[path + (name,)]),
                dtype=layer.param_dtype or dtype, device=model.device)
    for (layer, name), val in staged.items():
        setattr(layer, name, nn.Parameter(val, requires_grad=False))


def flax_tree(model) -> dict:
    """``model``'s weights as a flax-layout tree of numpy arrays (the
    inverse of :func:`load_flax_params`), copies that training the model
    leaves as they are."""
    return {"params": _nest({
        _flax_path(name): p.detach().cpu().numpy().copy()
        for name, p in model.named_parameters()
    })}


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


def _schedule_count(opt_state):
    """The count of the first ``ScaleByScheduleState`` (a named tuple or
    dict whose one field is ``count``) in an optax chain's state, or
    None."""
    if isinstance(opt_state, dict):
        return opt_state["count"] if set(opt_state) == {"count"} else None
    if getattr(opt_state, "_fields", None) == ("count",):
        return opt_state.count
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _schedule_count(part)
            if found is not None:
                return found
    return None


@torch.no_grad()
def load_optax_state(optimizer, opt_state) -> None:
    """Fill ``optimizer`` (the port's :class:`~dlwp_torch.train.optim.Adam`
    over a ``SequentialModel``'s ``named_parameters()``, plain or built by
    ``chain``) from an optax state given as numpy arrays, possibly the
    tuples of an optax chain: ``clip_by_global_norm``'s empty state, the
    ``ScaleByAdamState`` (``count``, and ``mu`` and ``nu`` trees in the
    flax layout, nested module names too) and, with a learning-rate
    schedule, the ``ScaleByScheduleState`` count. Raises when a parameter
    has no moment, a moment no parameter, shapes differ, or a schedule's
    count is missing on one side."""
    found = _adam_state(opt_state)
    if found is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    count, mu, nu = found
    mu = _flatten(mu.get("params", mu))
    nu = _flatten(nu.get("params", nu))
    seen = set()
    for group in optimizer.param_groups:
        names = group.get("param_names")
        if names is None:
            raise ValueError("the optimizer needs named parameters: build it "
                             "over model.named_parameters()")
        for name, p in zip(names, group["params"]):
            path = _flax_path(name)
            if path not in mu or path not in nu:
                raise KeyError(f"no moment for {'/'.join(path)}")
            m, v = np.asarray(mu[path]), np.asarray(nu[path])
            if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: moments {m.shape}, "
                                 f"parameter {tuple(p.shape)}")
            optimizer.state[p] = {
                "count": int(np.asarray(count)),
                "mu": torch.tensor(m, dtype=p.dtype, device=p.device),
                "nu": torch.tensor(v, dtype=p.dtype, device=p.device),
            }
            seen.add(path)
    extra = sorted("/".join(p) for p in set(mu) - seen)
    if extra:
        raise KeyError(f"moments without a parameter: {extra}")
    sched = _schedule_count(opt_state)
    scheduled = [g for g in optimizer.param_groups if "schedule_count" in g]
    if (sched is None) != (not scheduled):
        raise ValueError(
            "the optax state and the optimizer disagree on a learning-rate "
            f"schedule (state count {sched}, optimizer scheduled "
            f"{bool(scheduled)})")
    for group in scheduled:
        group["schedule_count"] = int(np.asarray(sched))


def tree_from_leaves(model, leaves) -> dict:
    """Rebuild the flax tree of ``model``'s architecture from its leaves in
    ``jax.tree_util`` order (dict keys sorted as strings at every level,
    so ``layers_10`` comes before ``layers_2``). Leaf shapes are checked by
    :func:`load_flax_params`."""
    paths = sorted(path + (n,) for path, layer in _param_layers(model).items()
                   for n in layer.param_names())
    leaves = list(leaves)
    if len(leaves) != len(paths):
        raise ValueError(f"{len(leaves)} leaves for {len(paths)} parameters")
    return {"params": _nest(dict(zip(paths, leaves)))}


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

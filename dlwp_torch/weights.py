"""Carry flax parameter trees and barotropic states into the port.

A flax ``SequentialModel`` keeps its parameters as
``{"params": {"layers_{i}": {name: array}}}``. The port's
``SequentialModel.layers[i]`` holds the same names with the same shapes
(OIHW ``kernel`` and ``bias``; ``input_kernel``, ``recurrent_kernel`` and
``bias`` for ``ConvLSTM2D``), so loading is a checked one-to-one copy.

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

"""Model persistence in a torch format (port of
``dlwp_tpu.utils.serialization``).

Three files, as in the JAX package: the wrapper's configuration (layer
specs, scaler statistics, flags, training configuration) pickles to
``<path>.pkl`` without its model and trainer; the parameters, a flax-style
``{"params": {"layers_{i}": {name: tensor}}}`` tree on the CPU, go to
``<path>.params`` with ``torch.save``; the training history pickles to
``<path>.history``. Loading rebuilds the model from its specs and fills
it with :func:`~dlwp_torch.weights.load_flax_params`. Only load files
this package wrote: unpickling runs code.
"""

from __future__ import annotations

import pickle

import torch


def _tree_map(fn, tree: dict) -> dict:
    """``fn`` on every leaf of a nested dict (a layer's module holds its
    own level, as ``layers_3/dense/kernel``)."""
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def save_model(model, file_path: str, history=None) -> None:
    """Save a ``DLWPNeuralNet`` (or ``DLWPFunctional``) and, if given, its
    ``History``."""
    state = model.__getstate__()
    params = state.pop("_params", None)
    with open(file_path + ".pkl", "wb") as f:
        pickle.dump({"class": type(model).__name__, "state": state}, f)
    if params is not None:
        torch.save(_tree_map(lambda v: torch.as_tensor(v).detach().cpu(),
                             params), file_path + ".params")
    if history is not None:
        with open(file_path + ".history", "wb") as f:
            pickle.dump({"epoch": history.epoch, "history": history.history}, f)


def load_model(file_path: str, history: bool = False, device=None):
    """Load a saved wrapper onto ``device`` (default ``cuda``; raises
    without a card unless ``device='cpu'``); with ``history``, return
    ``(model, history_dict or None)``."""
    from dlwp_torch.models.api import DLWPFunctional, DLWPNeuralNet

    with open(file_path + ".pkl", "rb") as f:
        blob = pickle.load(f)
    classes = {"DLWPNeuralNet": DLWPNeuralNet,
               "DLWPFunctional": DLWPFunctional}
    cls = classes[blob["class"]]
    state = blob["state"]
    state["device"] = device
    try:
        tree = torch.load(file_path + ".params", weights_only=True)
    except FileNotFoundError:
        pass
    else:
        state["_params"] = _tree_map(lambda v: v.numpy(), tree)
    model = cls.__new__(cls)
    model.__setstate__(state)
    if history:
        try:
            with open(file_path + ".history", "rb") as f:
                h = pickle.load(f)
        except FileNotFoundError:
            h = None
        return model, h
    return model


__all__ = ["load_model", "save_model"]

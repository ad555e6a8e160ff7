"""Checkpoint save and restore in a torch format (port of
``dlwp_tpu.train.checkpoint``).

The JAX package's layout, with ``torch.save`` in place of orbax: a
``step_{n}`` directory per save holding ``state.pt`` (the parameters'
state dict and, when given, the optimizer's), and ``metadata.json`` beside
them with the latest save's metadata. Restoring takes the latest step by
default.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

STATE_FILE = "state.pt"


def save_checkpoint(
    directory: str,
    params,
    opt_state=None,
    step: int = 0,
    metadata: dict | None = None,
) -> None:
    """Save ``params`` (a state dict) and ``opt_state`` (an optimizer's
    state dict) as step ``step`` of ``directory``, and ``metadata``."""
    directory = os.path.abspath(directory)
    step_dir = os.path.join(directory, f"step_{step}")
    os.makedirs(step_dir, exist_ok=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    tmp = os.path.join(step_dir, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(step_dir, STATE_FILE))
    if metadata is not None:
        with open(os.path.join(directory, "metadata.json"), "w") as f:
            json.dump(_jsonify(metadata), f, indent=2)


def restore_checkpoint(directory: str, step: int | None = None,
                       device=None) -> tuple[dict, dict]:
    """Restore the latest (or given) step: ``(state, metadata)``, the state
    a dict with ``params`` and, when saved, ``opt_state``, its tensors on
    ``device`` (default: where they were saved)."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = [
            int(d.split("_", 1)[1])
            for d in (os.listdir(directory) if os.path.isdir(directory) else ())
            if d.startswith("step_")
            and os.path.exists(os.path.join(directory, d, STATE_FILE))
        ]
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = max(steps)
    path = os.path.join(directory, f"step_{step}", STATE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    state = torch.load(path, map_location=device, weights_only=True)
    meta_path = os.path.join(directory, "metadata.json")
    metadata = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return state, metadata


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


__all__ = ["restore_checkpoint", "save_checkpoint"]

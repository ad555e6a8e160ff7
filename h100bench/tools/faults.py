"""Faults planted in the program under the benchmark, to show that the
check catches them (``h100bench/tests``) and to read their numbers at a
cell's size (``h100bench/tools/calibrate.py``). Never used by a run of
``run.py``.

- ``unchanged``: a step returns its state unchanged (a forecast step
  returns its input window's fields; a train step leaves the parameters
  as they were);
- ``half_batch``: half of the batch left out (a forecast step computes the
  first half and repeats it; a train step's loss is the mean over the
  first half);
- ``altered``: an answer altered where it is produced (the first sample's
  prediction of every model step shifted by 1).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def plant(fault: str, cfg: dict, driver: str):
    """Patch the program for the duration of the block."""
    from dlwp_torch.models.cnn import SequentialModel
    from dlwp_torch.train.optim import _OptaxRule
    from dlwp_torch.train.trainer import Trainer

    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    T = cfg["input_time_steps"]
    C = len(cfg["channels"])
    patches = []

    def patch(owner, name, fn):
        patches.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, fn)

    forward = SequentialModel.forward
    if fault == "unchanged" and driver == "forecast":
        def same(self, x):
            B, H, W = x.shape[0], x.shape[-2], x.shape[-1]
            fields = x.reshape(B, T, -1, H, W)[:, :, :C]
            return fields.reshape(forward(self, x).shape)
        patch(SequentialModel, "forward", same)
    elif fault == "unchanged":
        patch(_OptaxRule, "step", lambda self, closure=None: None)
    elif fault == "half_batch" and driver == "forecast":
        def half(self, x):
            h = max(x.shape[0] // 2, 1)
            y = forward(self, x[:h])
            return torch.cat([y, y[: x.shape[0] - h]]) if h < x.shape[0] else y
        patch(SequentialModel, "forward", half)
    elif fault == "half_batch":
        loss = Trainer._forward_loss

        def half_loss(self, x, y):
            h = max(x.shape[0] // 2, 1)
            return loss(self, x[:h], y[:h])
        patch(Trainer, "_forward_loss", half_loss)
    else:
        def altered(self, x):
            y = forward(self, x)
            return torch.cat([y[:1] + 1.0, y[1:]])
        patch(SequentialModel, "forward", altered)
    try:
        yield
    finally:
        for owner, name, old in reversed(patches):
            setattr(owner, name, old)

"""Training callbacks (port of ``dlwp_tpu.train.callbacks``).

Callbacks are callables ``cb(epoch, metrics, params)`` that
``Trainer.fit`` calls after each epoch (``params``: the model's state
dict); one with an ``on_batch(loss)`` method is also called after each
batch.

- :class:`LearningRateTracker` prints the effective learning rate;
- :class:`BatchHistory` records per-batch losses;
- :class:`RunHistory` mirrors epoch metrics to an experiment logger, any
  object with ``log(key, value)``; :class:`JsonlRun` is a file-backed one.
- Early stopping is :class:`dlwp_torch.train.trainer.EarlyStoppingMin`.
"""

from __future__ import annotations

import json
from typing import Any


class LearningRateTracker:
    """Print the effective learning rate each epoch: ``schedule(step)``
    when a schedule (a callable of the step) is given, else ``base_lr``
    with inverse-time ``decay`` and, for ``kind='adam'``, Adam's bias
    correction."""

    def __init__(self, base_lr: float, schedule=None, beta_1=0.9, beta_2=0.999,
                 decay: float = 0.0, kind: str = "adam",
                 steps_per_epoch: int = 1):
        self.base_lr = base_lr
        self.schedule = schedule
        self.beta_1, self.beta_2 = beta_1, beta_2
        self.decay = decay
        self.kind = kind
        self.steps_per_epoch = steps_per_epoch

    def effective_lr(self, epoch: int) -> float:
        t = (epoch + 1) * self.steps_per_epoch
        if self.schedule is not None:
            return float(self.schedule(t))
        lr = self.base_lr / (1.0 + self.decay * t)
        if self.kind == "adam":
            lr = lr * (1.0 - self.beta_2 ** t) ** 0.5 / (1.0 - self.beta_1 ** t)
        return float(lr)

    def __call__(self, epoch: int, metrics: dict, params: Any) -> None:
        print(f"  effective learning rate: {self.effective_lr(epoch):.3e}")


class BatchHistory:
    """Per-batch losses, one list per epoch."""

    def __init__(self):
        self.batch_losses: list[list[float]] = []
        self._current: list[float] = []

    def on_batch(self, loss: float) -> None:
        self._current.append(float(loss))

    def __call__(self, epoch: int, metrics: dict, params: Any) -> None:
        self.batch_losses.append(self._current)
        self._current = []


class RunHistory:
    """Mirror epoch metrics to ``run``, any object with ``log(key,
    value)``."""

    def __init__(self, run):
        self.run = run

    def __call__(self, epoch: int, metrics: dict, params: Any) -> None:
        for k, v in metrics.items():
            self.run.log(k, v)


class JsonlRun:
    """Minimal experiment logger writing JSON lines."""

    def __init__(self, path: str):
        self.path = path

    def log(self, key: str, value) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"key": key, "value": float(value)}) + "\n")


__all__ = ["BatchHistory", "JsonlRun", "LearningRateTracker", "RunHistory"]

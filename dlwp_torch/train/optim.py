"""Optimizers with optax's update rules, as ``torch.optim.Optimizer``s.

The JAX package trains with optax (``adam``, ``adamw``, ``sgd``,
``rmsprop``, ``adagrad``, ``lion``). ``torch.optim`` differs from optax in
defaults and in arithmetic, so each rule here is written out as optax
0.2.6 computes it, with optax's defaults:

- ``adam``: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, the
  update mu_hat / (sqrt(nu_hat) + eps) with bias-corrected moments;
- ``adamw``: adam's direction plus ``weight_decay`` (default 1e-4, where
  ``torch.optim.AdamW`` defaults to 1e-2) times the parameter, before the
  learning rate;
- ``sgd``: the gradient, or with ``momentum`` the trace g + m t (optax
  ``trace``, no dampening);
- ``rmsprop``: decay 0.9 (torch: alpha 0.99), eps *inside* the square
  root, g / sqrt(nu + eps) (torch: g / (sqrt(nu) + eps));
- ``adagrad``: the sum of squares starts at 0.1 with eps 1e-7 (torch: 0
  and 1e-10), g / sqrt(sum + eps);
- ``lion`` (no torch counterpart): sign((1 - b1) g + b1 m), then m = b2 m
  + (1 - b2) g, plus ``weight_decay`` (default 1e-3) times the parameter.

Each step computes the update u of the rule and sets p = p + (-lr) u, as
``optax.apply_updates`` adds the scaled update. :func:`add_decayed_weights`
is optax's transform of the same name, chained in front of any optimizer:
it adds ``weight_decay * p`` to each gradient before the step.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch


class _OptaxRule(torch.optim.Optimizer):
    """One optax rule over every parameter. A parameter without a
    gradient steps as if its gradient were zero, as optax updates every
    leaf (JAX gives an unused parameter a zero gradient): its weight decay
    still applies and its moments and count still advance."""

    def __init__(self, params, lr, **defaults):
        if not (isinstance(lr, (int, float)) and lr >= 0):
            raise ValueError(f"learning rate must be a number >= 0, got {lr!r}")
        super().__init__(params, dict(lr=float(lr), **defaults))

    def _update(self, g, p, state, group):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                u = self._update(g, p, self.state[p], group)
                p.add_(u * (-group["lr"]))
        return loss


def _bias_correction(moment, decay, count):
    return moment / (1 - decay ** count)


class Adam(_OptaxRule):
    """optax ``adam`` (``weight_decay`` 0) and ``adamw`` (decoupled
    ``weight_decay``, added to the direction before the learning rate).
    State: ``count``, ``mu``, ``nu``, as optax's ``ScaleByAdamState``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)

    def _update(self, g, p, state, group):
        if not state:
            state["count"] = 0
            state["mu"] = torch.zeros_like(p)
            state["nu"] = torch.zeros_like(p)
        b1, b2 = group["b1"], group["b2"]
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * (g ** 2) + b2 * state["nu"]
        count = state["count"] + 1
        state.update(count=count, mu=mu, nu=nu)
        u = _bias_correction(mu, b1, count) / (
            torch.sqrt(_bias_correction(nu, b2, count)) + group["eps"])
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        return u


class SGD(_OptaxRule):
    """optax ``sgd``: the gradient, or its trace with ``momentum``."""

    def __init__(self, params, lr=1e-3, momentum=None, nesterov=False):
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov)

    def _update(self, g, p, state, group):
        m = group["momentum"]
        if m is None:
            return g
        t = g + m * state.get("trace", torch.zeros_like(p))
        state["trace"] = t
        return g + m * t if group["nesterov"] else t


class RMSprop(_OptaxRule):
    """optax ``rmsprop`` (not centered, no momentum): eps inside the root."""

    def __init__(self, params, lr=1e-3, decay=0.9, eps=1e-8):
        super().__init__(params, lr, decay=decay, eps=eps)

    def _update(self, g, p, state, group):
        if not state:
            state["nu"] = torch.zeros_like(p)
        d = group["decay"]
        nu = (1 - d) * (g ** 2) + d * state["nu"]
        state["nu"] = nu
        return torch.rsqrt(nu + group["eps"]) * g


class Adagrad(_OptaxRule):
    """optax ``adagrad``: the sum of squares starts at
    ``initial_accumulator_value``."""

    def __init__(self, params, lr=1e-3, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(params, lr, eps=eps,
                         initial_accumulator_value=initial_accumulator_value)

    def _update(self, g, p, state, group):
        if not state:
            state["sum_of_squares"] = torch.full_like(
                p, group["initial_accumulator_value"])
        s = g * g + state["sum_of_squares"]
        state["sum_of_squares"] = s
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                          torch.zeros_like(s))
        return inv * g


class Lion(_OptaxRule):
    """optax ``lion``, with its decoupled ``weight_decay``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.99, weight_decay=1e-3):
        super().__init__(params, lr, b1=b1, b2=b2, weight_decay=weight_decay)

    def _update(self, g, p, state, group):
        if not state:
            state["mu"] = torch.zeros_like(p)
        b1, b2 = group["b1"], group["b2"]
        u = torch.sign((1.0 - b1) * g + b1 * state["mu"])
        state["mu"] = (1 - b2) * g + b2 * state["mu"]
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        return u


# name -> the rule's class, called (params, learning_rate, **hyperparameters)
OPTIMIZERS: dict[str, Callable] = {
    "adam": Adam,
    "adamw": functools.partial(Adam, weight_decay=1e-4),
    "sgd": SGD,
    "rmsprop": RMSprop,
    "adagrad": Adagrad,
    "lion": Lion,
}


@torch.no_grad()
def add_decayed_weights(params, weight_decay: float) -> None:
    """optax ``add_decayed_weights`` in front of an optimizer: each
    gradient becomes g + weight_decay * p (a missing gradient counts
    as zero)."""
    for p in params:
        p.grad = (weight_decay * p if p.grad is None
                  else p.grad + weight_decay * p)


__all__ = [
    "OPTIMIZERS",
    "Adagrad",
    "Adam",
    "Lion",
    "RMSprop",
    "SGD",
    "add_decayed_weights",
]

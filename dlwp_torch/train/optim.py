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

The learning rate is a number or a schedule, a callable of the step count
that returns a number (:func:`cosine_decay_schedule`): as optax's
``scale_by_schedule``, step n uses ``schedule(n)`` with n counted from 0,
and the count is the optimizer's state (its ``param_groups``, so it is in
``state_dict`` and in checkpoints). It stays a Python int, so evaluating
the schedule reads nothing back from a card.

:func:`chain` puts gradient transforms (:func:`clip_by_global_norm`) in
front of a rule factory such as :func:`adam`, as ``optax.chain`` does.
The result is the ``params -> Optimizer`` factory that ``Trainer``
takes, so the chain of ``examples/train_convlstm.py --cosine-decay`` is::

    chain(clip_by_global_norm(1.0),
          adam(cosine_decay_schedule(lr, steps, 0.05)))
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch


class _OptaxRule(torch.optim.Optimizer):
    """One optax rule over every parameter. A parameter without a
    gradient steps as if its gradient were zero, as optax updates every
    leaf (JAX gives an unused parameter a zero gradient): its weight decay
    still applies and its moments and count still advance.

    ``lr``: a number, or a schedule of the step count (each group then
    keeps its ``schedule_count``). ``_transforms``: gradient transforms
    applied, in order, to the list of every gradient before the rule
    (set by :func:`chain`)."""

    def __init__(self, params, lr, **defaults):
        self._schedule = lr if callable(lr) else None
        if self._schedule is not None:
            defaults["schedule_count"] = 0
            lr = self._schedule(0)
        if not (isinstance(lr, (int, float)) and lr >= 0):
            raise ValueError(
                f"learning rate must be a number >= 0 or a schedule, got {lr!r}")
        super().__init__(params, dict(lr=float(lr), **defaults))
        self._transforms: tuple = ()

    def _update(self, g, p, state, group):
        raise NotImplementedError

    def _step_lr(self, group) -> float:
        """This step's learning rate; a schedule's count advances."""
        if self._schedule is None:
            return group["lr"]
        group["lr"] = float(self._schedule(group["schedule_count"]))
        group["schedule_count"] += 1
        return group["lr"]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for group in self.param_groups for p in group["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        for transform in self._transforms:
            grads = transform(grads)
        grads = iter(grads)
        for group in self.param_groups:
            lr = self._step_lr(group)
            for p in group["params"]:
                u = self._update(next(grads), p, self.state[p], group)
                p.add_(u * (-lr))
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


def adam(learning_rate, **kwargs) -> Callable:
    """optax ``adam`` as a factory ``params -> Adam`` (``learning_rate`` a
    number or a schedule), for :func:`chain`."""
    return lambda params: Adam(params, learning_rate, **kwargs)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule``: ``count -> init_value * ((1 -
    alpha) * (0.5 (1 + cos(pi c / decay_steps)))**exponent + alpha)`` with
    c the count clamped at ``decay_steps``; Python floats."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps!r}.")
    decay_steps = float(decay_steps)

    def schedule(count) -> float:
        c = min(float(count), decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def clip_by_global_norm(max_norm: float) -> Callable:
    """optax ``clip_by_global_norm``, a gradient transform for
    :func:`chain`: with n the global norm of every gradient, each g stays
    g when n < max_norm and becomes (g / n) * max_norm otherwise. The
    choice is made on the device (``torch.where``), so it reads nothing
    back to the host."""

    def transform(grads: list) -> list:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < max_norm
        return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
                for g in grads]

    return transform


def chain(*parts) -> Callable:
    """optax ``chain`` of gradient transforms ending in a rule factory
    (:func:`adam`): a factory ``params -> Optimizer`` whose
    step runs the transforms, in order, on the gradients before the rule."""
    if not parts or not callable(parts[-1]):
        raise ValueError("chain needs a rule factory last")
    *transforms, make = parts

    def build(params):
        opt = make(params)
        if not isinstance(opt, _OptaxRule):
            raise TypeError("the last part of a chain must be a rule factory "
                            "such as adam(learning_rate)")
        opt._transforms = tuple(transforms) + opt._transforms
        return opt

    return build


__all__ = [
    "OPTIMIZERS",
    "Adagrad",
    "Adam",
    "Lion",
    "RMSprop",
    "SGD",
    "adam",
    "add_decayed_weights",
    "chain",
    "clip_by_global_norm",
    "cosine_decay_schedule",
]

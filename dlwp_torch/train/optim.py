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
  root, g / sqrt(nu + eps) (torch: g / (sqrt(nu) + eps)); ``centered``
  subtracts the squared mean, ``bias_correction`` corrects the moments,
  and ``momentum`` traces the update *after* the learning rate, as
  optax chains ``trace`` behind ``scale_by_learning_rate`` there;
- ``adagrad``: the sum of squares starts at 0.1 with eps 1e-7 (torch: 0
  and 1e-10), g / sqrt(sum + eps);
- ``lion`` (no torch counterpart): sign((1 - b1) g + b1 m), then m = b2 m
  + (1 - b2) g, plus ``weight_decay`` (default 1e-3) times the parameter.

Each name of :data:`OPTIMIZERS` takes every keyword of its optax factory,
with optax's defaults and meaning (a keyword optax does not know raises
``TypeError``): ``eps_root``, ``mu_dtype`` and ``nesterov`` (adam,
adamw), ``mask`` (adamw, lion: the parameters whose weight decay
applies, a mapping of parameter names to bools or a callable of the
``{name: parameter}`` dict that returns one; the optimizer then needs
named parameters), ``initial_scale``, ``eps_in_sqrt``, ``centered``,
``momentum``, ``nesterov``, ``bias_correction`` (rmsprop),
``accumulator_dtype`` (sgd), ``mu_dtype`` (lion). A dtype is a
``torch.dtype`` or anything ``numpy.dtype`` names (``"bfloat16"``).

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

import math
from typing import Callable

import numpy as np
import torch


def _dtype(dtype) -> torch.dtype | None:
    """optax's ``canonicalize_dtype`` for the port: None, a
    ``torch.dtype``, or a name or numpy-like dtype (``"bfloat16"``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return getattr(torch, name)


def _stored(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` kept in the state dtype ``dtype`` (as it is for None)."""
    return t if dtype is None else t.to(dtype)


class _OptaxRule(torch.optim.Optimizer):
    """One optax rule over every parameter. A parameter without a
    gradient steps as if its gradient were zero, as optax updates every
    leaf (JAX gives an unused parameter a zero gradient): its weight decay
    still applies and its moments and count still advance.

    ``lr``: a number, or a schedule of the step count (each group then
    keeps its ``schedule_count``). ``_transforms``: gradient transforms
    applied, in order, to the list of every gradient before the rule
    (set by :func:`chain`)."""

    def __init__(self, params, lr, mask=None, **defaults):
        self._mask = mask  # not a hyperparameter of the state dict
        self._schedule = lr if callable(lr) else None
        if self._schedule is not None:
            defaults["schedule_count"] = 0
            lr = self._schedule(0)
        if not (isinstance(lr, (int, float)) and lr >= 0):
            raise ValueError(
                f"learning rate must be a number >= 0 or a schedule, got {lr!r}")
        super().__init__(params, dict(lr=float(lr), **defaults))
        self._transforms: tuple = ()
        self._decay = True  # the weight decay applies to the parameter
        # being stepped (``mask``)

    def _update(self, g, p, state, group):
        raise NotImplementedError

    def _delta(self, g, p, state, group, lr):
        """The change of ``p`` this step: the rule's update times -lr
        (``scale_by_learning_rate`` then ``apply_updates``)."""
        return self._update(g, p, state, group) * (-lr)

    def _decays(self, group) -> list:
        """Whether each parameter of ``group`` takes the weight decay:
        every one without a ``mask``; else the mask's value at its name."""
        mask = self._mask
        if mask is None:
            return [True] * len(group["params"])
        names = group.get("param_names")
        if names is None:
            raise ValueError("a weight-decay mask needs named parameters: "
                             "build the optimizer over named_parameters()")
        if callable(mask):
            mask = mask(dict(zip(names, group["params"])))
        return [bool(mask[n]) for n in names]

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
            for p, self._decay in zip(group["params"], self._decays(group)):
                p.add_(self._delta(next(grads), p, self.state[p], group, lr))
        return loss


def _bias_correction(moment, decay, count):
    return moment / (1 - decay ** count)


class Adam(_OptaxRule):
    """optax ``adam`` (``weight_decay`` 0) and ``adamw`` (decoupled
    ``weight_decay``, added to the direction before the learning rate,
    where ``mask`` allows). State: ``count``, ``mu`` (in ``mu_dtype``),
    ``nu``, as optax's ``ScaleByAdamState``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, eps_root=0.0, mu_dtype=None, mask=None,
                 nesterov=False):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, eps_root=eps_root,
                         mu_dtype=_dtype(mu_dtype), mask=mask,
                         nesterov=nesterov)

    def _update(self, g, p, state, group):
        if not state:
            state["count"] = 0
            state["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"])
            state["nu"] = torch.zeros_like(p)
        b1, b2 = group["b1"], group["b2"]
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * (g ** 2) + b2 * state["nu"]
        count = state["count"] + 1
        state.update(count=count, mu=_stored(mu, group["mu_dtype"]), nu=nu)
        if group["nesterov"]:
            mu_hat = (b1 * _bias_correction(mu, b1, count + 1)
                      + (1 - b1) * _bias_correction(g, b1, count))
        else:
            mu_hat = _bias_correction(mu, b1, count)
        u = mu_hat / (torch.sqrt(_bias_correction(nu, b2, count)
                                 + group["eps_root"]) + group["eps"])
        if group["weight_decay"] and self._decay:
            u = u + group["weight_decay"] * p
        return u


def _trace(u, p, state, decay, nesterov, dtype=None):
    """optax ``trace``: t = u + decay t (kept in ``dtype``); the update is
    t, or u + decay t with ``nesterov``."""
    t = u + decay * state.get("trace", torch.zeros_like(p, dtype=dtype))
    state["trace"] = _stored(t, dtype)
    return u + decay * t if nesterov else t


class SGD(_OptaxRule):
    """optax ``sgd``: the gradient, or its trace with ``momentum`` (the
    trace kept in ``accumulator_dtype``)."""

    def __init__(self, params, lr=1e-3, momentum=None, nesterov=False,
                 accumulator_dtype=None):
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov,
                         accumulator_dtype=_dtype(accumulator_dtype))

    def _update(self, g, p, state, group):
        m = group["momentum"]
        if m is None:
            return g
        return _trace(g, p, state, m, group["nesterov"],
                      group["accumulator_dtype"])


class RMSprop(_OptaxRule):
    """optax ``rmsprop``: ``scale_by_rms`` (``scale_by_stddev`` where
    ``centered``), the learning rate, then optax ``trace`` where
    ``momentum`` is set. State: ``nu`` from ``initial_scale`` (and ``mu``
    where centered, ``count`` with ``bias_correction``, ``trace`` of the
    lr-scaled updates with momentum)."""

    def __init__(self, params, lr=1e-3, decay=0.9, eps=1e-8,
                 initial_scale=0.0, eps_in_sqrt=True, centered=False,
                 momentum=None, nesterov=False, bias_correction=False):
        super().__init__(params, lr, decay=decay, eps=eps,
                         initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt,
                         centered=centered, momentum=momentum,
                         nesterov=nesterov, bias_correction=bias_correction)

    def _update(self, g, p, state, group):
        d = group["decay"]
        if "nu" not in state:
            state["nu"] = torch.full_like(p, group["initial_scale"])
            if group["centered"]:
                state["mu"] = torch.zeros_like(p)
            if group["bias_correction"]:
                state["count"] = 0
        nu = (1 - d) * (g ** 2) + d * state["nu"]
        state["nu"] = nu
        if group["centered"]:
            mu = (1 - d) * g + d * state["mu"]
            state["mu"] = mu
        if group["bias_correction"]:
            state["count"] += 1
            nu = _bias_correction(nu, d, state["count"])
            if group["centered"]:
                mu = _bias_correction(mu, d, state["count"])
        if group["centered"]:
            nu = nu - mu * mu
        if group["eps_in_sqrt"]:
            return torch.rsqrt(nu + group["eps"]) * g
        return 1 / (torch.sqrt(nu) + group["eps"]) * g

    def _delta(self, g, p, state, group, lr):
        delta = super()._delta(g, p, state, group, lr)
        if group["momentum"] is None:
            return delta
        return _trace(delta, p, state, group["momentum"], group["nesterov"])


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
    """optax ``lion``, with its decoupled ``weight_decay`` (where ``mask``
    allows); the moment kept in ``mu_dtype``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.99, weight_decay=1e-3,
                 mu_dtype=None, mask=None):
        super().__init__(params, lr, b1=b1, b2=b2, weight_decay=weight_decay,
                         mu_dtype=_dtype(mu_dtype), mask=mask)

    def _update(self, g, p, state, group):
        if not state:
            state["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"])
        b1, b2 = group["b1"], group["b2"]
        u = torch.sign((1.0 - b1) * g + b1 * state["mu"])
        state["mu"] = _stored((1 - b2) * g + b2 * state["mu"],
                              group["mu_dtype"])
        if group["weight_decay"] and self._decay:
            u = u + group["weight_decay"] * p
        return u


def _adam(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          mu_dtype=None, *, nesterov=False):
    """optax ``adam``'s signature."""
    return Adam(params, learning_rate, b1, b2, eps, eps_root=eps_root,
                mu_dtype=mu_dtype, nesterov=nesterov)


def _adamw(params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
           mu_dtype=None, weight_decay=1e-4, mask=None, *, nesterov=False):
    """optax ``adamw``'s signature."""
    return Adam(params, learning_rate, b1, b2, eps, weight_decay,
                eps_root=eps_root, mu_dtype=mu_dtype, mask=mask,
                nesterov=nesterov)


# name -> the rule, called (params, learning_rate, **optax keywords)
OPTIMIZERS: dict[str, Callable] = {
    "adam": _adam,
    "adamw": _adamw,
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

"""The general generator: weights, series and draws from ``--seed``, sized
by a configuration file and a traffic file.

Everything is made on the device with ``torch.Generator``s there, in a few
large calls; the same seed gives the same inputs. Seeds of any size go
through ``numpy.random.SeedSequence``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench import specs
from h100bench.reference import spec_net

SERIES_START = np.datetime64("2001-01-01T00:00")
BIAS_RANGE = 0.1


def sub_seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 32-bit seeds from ``seed``."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """Every parameter leaf, glorot-uniform kernels and small uniform
    biases, cut from one uniform draw: ``{layers.<i>.<leaf>: tensor}``."""
    leaves = specs.leaves(cfg)
    total = sum(math.prod(shape) for _, shape in leaves)
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape in leaves:
        n = math.prod(shape)
        if len(shape) == 4:
            o, c, kh, kw = shape
            scale = math.sqrt(6.0 / ((o + c) * kh * kw))
        else:
            scale = BIAS_RANGE
        out[name] = (u[at:at + n] * scale).reshape(shape)
        at += n
    return out


def series_times(n: int) -> np.ndarray:
    dt = np.timedelta64(6, "h")
    return SERIES_START + dt * np.arange(n)


def make_series(cfg: dict, n: int, gen: torch.Generator, device):
    """A standardised series ``(n, C, H, W)`` float32 of the configuration's
    channels, 6-hourly from :data:`SERIES_START`, its insolation ``(n, H,
    W)`` float32 and its days-of-year ``(n,)`` float64."""
    g = specs.grid(cfg)
    C = len(cfg["channels"])
    series = torch.randn((n, C, g.nlat, g.nlon), generator=gen, device=device)
    days = torch.as_tensor(spec_net.day_of_year(series_times(n)),
                           device=device)
    sol = spec_net.insolation(days, g.lat(), g.lon()).to(torch.float32)
    return series, sol, days


def window(series, sol, rows: torch.Tensor) -> torch.Tensor:
    """(B, T, C+1, H, W) windows of the series at ``rows`` (B, T)."""
    B, T = rows.shape
    flat = rows.reshape(-1)
    x = torch.cat([series.index_select(0, flat),
                   sol.index_select(0, flat)[:, None]], dim=1)
    return x.reshape((B, T) + tuple(x.shape[1:]))


def load_into(model, weights: dict) -> None:
    """Hand ``weights`` to a ``dlwp_torch`` model: a copy of each leaf into
    the parameter slot of the same name."""
    mods = dict(model.named_modules())
    for name, value in weights.items():
        owner, leaf = name.rsplit(".", 1)
        setattr(mods[owner], leaf,
                torch.nn.Parameter(value.detach().clone(), requires_grad=False))

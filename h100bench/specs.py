"""Configuration files and the shapes of their layers.

A configuration (``h100bench/configs/<name>.json``) lists its layers as
``[name, args, kwargs]`` in the layer-spec language of ``dlwp_torch``'s
``build_sequential``; the strings ``"nlat"`` and ``"nlon"`` in them stand
for the grid's sizes. :func:`walk` follows one sample's shape through the
layers (the configuration's reference module does the pass) and gives
each layer's parameter leaves and multiply-adds at its nominal
resolution: what the FLOP counts and the benchmark's weights are made
from.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    """``h100bench/<kind>/<name>.json``, found by name."""
    path = ROOT / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass(frozen=True)
class Grid:
    nlat: int
    nlon: int
    lat0: float  # first latitude, degrees
    dlat: float
    lon0: float
    dlon: float

    def lat(self):
        return [self.lat0 + self.dlat * i for i in range(self.nlat)]

    def lon(self):
        return [self.lon0 + self.dlon * i for i in range(self.nlon)]


def grid(cfg: dict) -> Grid:
    return Grid(**cfg["grid"])


def _subst(v, g: Grid):
    if isinstance(v, str) and v in ("nlat", "nlon"):
        return getattr(g, v)
    if isinstance(v, list):
        return tuple(_subst(e, g) for e in v)
    if isinstance(v, dict):
        return {k: _subst(e, g) for k, e in v.items()}
    return v


def layers(cfg: dict) -> list[tuple]:
    """The configuration's layer specs as ``(name, args, kwargs)`` tuples
    with the grid's sizes put in."""
    g = grid(cfg)
    return [(name, _subst(args, g), _subst(kwargs or {}, g) or None)
            for name, args, kwargs in cfg["layers"]]


@dataclasses.dataclass
class LayerShape:
    index: int
    kind: str
    args: tuple
    kwargs: dict
    in_shape: tuple
    out_shape: tuple
    params: dict  # leaf name -> shape
    macs: int  # multiply-adds for one sample at the nominal resolution


def walk(cfg: dict) -> list[LayerShape]:
    """Every layer's shapes, leaves and multiply-adds for one sample, from
    the shape pass of the configuration's reference module."""
    from h100bench import reference

    return reference.load(cfg["reference"]).walk(cfg)


def leaves(cfg: dict) -> list[tuple[str, tuple]]:
    """``(parameter name, shape)`` in the order of the model's
    ``named_parameters()``: ``layers.<i>.<leaf>``."""
    return [(f"layers.{s.index}.{n}", shp) for s in walk(cfg)
            for n, shp in s.params.items()]

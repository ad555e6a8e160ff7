"""Plain reference of DLWP-CS's cubed-sphere U-Net (Weyn, Durran & Caruana
2020, doi:10.1029/2020MS002109), its forecast rollout and its loss.

Written from the published description and this benchmark's
configuration file, not from ``dlwp_torch``:

- the cube: six faces of n x n cells, equiangular gnomonic; faces 0-3 on
  the equator centred at longitudes 0, 90, 180, 270, face 4 north, face 5
  south. Face frames (centre, column direction u, up direction v): face k
  < 4 ((cos, sin, 0) at 90k degrees, east, north); north ((0, 0, 1), +y,
  -x); south ((0, 0, -1), +y, +x). Row 0 is each face's +v edge, column 0
  its -u edge. (The face order and orientation are this benchmark's
  choice: the paper fixes neither in its text.)
- ``CubeSpherePadding2D``: each face's halo copied from its four
  neighbours, one explicit slice a side with the rotation the cube's
  edges need (:func:`pad`). The corner cells, where three faces meet,
  repeat the nearest cell of the halo across the face's top or bottom
  edge (an assumption: the paper does not say).
- ``CubeSphereConv2D`` with DLWP-CS's defaults: one kernel and bias for
  the four equatorial faces, one for the two polar faces, the north face
  flipped top to bottom before its conv and flipped back after
  (``flip_north_pole=True``), so both polar faces see their pole the same
  way.
- the U-Net: two 3 x 3 convs per level at 32, 64, 128 filters, 2 x 2
  average pooling and nearest 2 x upsampling inside faces, skip
  concatenations, the 128 -> 64 bottleneck (assumed), leaky ReLU of slope
  0.1 (assumed) after every conv but the last, a linear 1 x 1 conv to 2
  times x 4 fields. The 2021 follow-up's constant inputs (land-sea mask,
  topography) and capped activation are left out.
- top-of-atmosphere insolation at each cell centre from the first-order
  orbit with fixed 1995 elements, in float64, from fractional
  day-of-year; the forecast feeds each step's prediction back with the
  insolation of its valid times.

Fields outside the model are ``(B, C, 6 n, n)``: the faces stacked along
the rows. Everything runs in float32 with TF32 off unless
:func:`precision` says otherwise (the control runs it in TF32).
:func:`walk` is the shape pass that the benchmark's FLOP counts and
weights come from.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from h100bench import specs
from h100bench.reference.spec_net import (  # noqa: F401 (re-exported)
    ADAM_B1,
    ECCENTRICITY,
    OBLIQUITY,
    PERIHELION_LON,
    day_of_year,
    precision,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NORTH, SOUTH = 4, 5


def widths(cfg: dict) -> list[tuple[int, int, int]]:
    """(input channels, output channels, kernel size) of the 11 convs, in
    the order of the forward pass."""
    f0, f1, f2 = cfg["filters"]
    c_in = cfg["input_time_steps"] * (len(cfg["channels"]) + 1)
    c_out = cfg["output_time_steps"] * len(cfg["channels"])
    return [(c_in, f0, 3), (f0, f0, 3), (f0, f1, 3), (f1, f1, 3),
            (f1, f2, 3), (f2, f1, 3), (f1 + f1, f1, 3), (f1, f0, 3),
            (f0 + f0, f0, 3), (f0, f0, 3), (f0, c_out, 1)]


# The face size each conv runs at, as a divisor of the cube's.
LEVELS = (1, 1, 2, 2, 4, 4, 2, 2, 1, 1, 1)


def walk(cfg: dict) -> list:
    """Each conv's shapes (channels, 6, n, n), leaves (named as the
    program's ``layers.0.CubeSphereConv2D_<k>.<leaf>``) and multiply-adds
    for one sample."""
    n = cfg["grid"]["face_size"]
    out = []
    for k, ((c, o, ks), lev) in enumerate(zip(widths(cfg), LEVELS)):
        m = n // lev
        params = {}
        for group in ("equatorial", "polar"):
            params[f"CubeSphereConv2D_{k}.{group}_kernel"] = (o, c, ks, ks)
            params[f"CubeSphereConv2D_{k}.{group}_bias"] = (o,)
        out.append(specs.LayerShape(
            0, f"CubeSphereConv2D_{k}", (o, ks), {}, (c, 6, m, m),
            (o, 6, m, m), params, 6 * m * m * o * c * ks * ks))
    return out


# ----------------------------------------------------------------- the cube
def _frames() -> np.ndarray:
    f = []
    for k in range(4):
        a = math.radians(90.0 * k)
        f.append([[math.cos(a), math.sin(a), 0.0],
                  [-math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
    f.append([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
    f.append([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    return np.asarray(f)


def lat_lon(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(6 n, n) latitude and longitude (degrees) of the cell centres, the
    faces stacked along the rows."""
    ang = -math.pi / 4 + (np.arange(n) + 0.5) * (math.pi / 2 / n)
    x, y = np.tan(ang)[None, :], np.tan(-ang)[:, None]  # column, row
    lat, lon = [], []
    for c, u, v in _frames():
        p = c[:, None, None] + x * u[:, None, None] + y * v[:, None, None]
        p = p / np.sqrt((p ** 2).sum(0))
        lat.append(np.degrees(np.arcsin(p[2])))
        lon.append(np.degrees(np.arctan2(p[1], p[0])) % 360.0)
    return np.concatenate(lat), np.concatenate(lon)


def insolation(days: torch.Tensor, lat: np.ndarray,
               lon: np.ndarray) -> torch.Tensor:
    """``(..., 6 n, n)`` float64 insolation, clipped at 0, at the cells of
    2-D ``lat`` / ``lon`` for fractional days-of-year ``days``."""
    dev = days.device
    lat = torch.as_tensor(np.radians(lat), device=dev)
    lon = torch.as_tensor(lon, device=dev)
    d = days.to(torch.float64)[..., None, None]
    beta = math.sqrt(1.0 - ECCENTRICITY ** 2)
    lambda_m0 = ECCENTRICITY * (1.0 + beta) * math.sin(PERIHELION_LON)
    lambda_m = lambda_m0 + 2.0 * math.pi * (d - 80.5) / 365.0
    lam = lambda_m + 2.0 * ECCENTRICITY * torch.sin(lambda_m - PERIHELION_LON)
    decl = torch.asin(math.sin(OBLIQUITY) * torch.sin(lam))
    hour_angle = 2.0 * math.pi * (d + lon / 360.0)
    rho = (1.0 - ECCENTRICITY ** 2) / (
        1.0 + ECCENTRICITY * torch.cos(lam - PERIHELION_LON))
    sol = (torch.sin(lat) * torch.sin(decl)
           - torch.cos(lat) * torch.cos(decl) * torch.cos(hour_angle))
    return torch.clamp(sol * rho ** -2, min=0.0)


def _t(a):
    return a.transpose(-1, -2)


def _strips(x, p):
    """Each face's four halo strips from its neighbours' edges. ``x`` is
    (B, C, 6, n, n). Top and bottom strips are (p, n), left and right (n,
    p), ordered as the padded face holds them (top: farthest row first;
    left: farthest column first)."""
    f = [x[:, :, k] for k in range(6)]
    top = [f[4][..., -p:, :],
           _t(f[4][..., :, -p:].flip(-2)),
           f[4][..., :p, :].flip(-2).flip(-1),
           _t(f[4][..., :, :p].flip(-1)),
           f[2][..., :p, :].flip(-2).flip(-1),
           f[0][..., -p:, :]]
    bottom = [f[5][..., :p, :],
              _t(f[5][..., :, -p:].flip(-1)),
              f[5][..., -p:, :].flip(-2).flip(-1),
              _t(f[5][..., :, :p].flip(-2)),
              f[0][..., :p, :],
              f[2][..., -p:, :].flip(-2).flip(-1)]
    left = [f[3][..., :, -p:], f[0][..., :, -p:], f[1][..., :, -p:],
            f[2][..., :, -p:],
            _t(f[3][..., :p, :].flip(-2)),
            _t(f[3][..., -p:, :].flip(-1))]
    right = [f[1][..., :, :p], f[2][..., :, :p], f[3][..., :, :p],
             f[0][..., :, :p],
             _t(f[1][..., :p, :].flip(-1)),
             _t(f[1][..., -p:, :].flip(-2))]
    return top, bottom, left, right


def pad(x: torch.Tensor, p: int = 1) -> torch.Tensor:
    """(B, C, 6, n, n) -> (B, C, 6, n + 2p, n + 2p): each face with its
    halo; corners repeat the end cells of the top and bottom strips."""
    top, bottom, left, right = _strips(x, p)
    faces = []
    for k in range(6):
        t, b = top[k], bottom[k]
        t = torch.cat([t[..., :1].expand(*t.shape[:-1], p), t,
                       t[..., -1:].expand(*t.shape[:-1], p)], dim=-1)
        b = torch.cat([b[..., :1].expand(*b.shape[:-1], p), b,
                       b[..., -1:].expand(*b.shape[:-1], p)], dim=-1)
        mid = torch.cat([left[k], x[:, :, k], right[k]], dim=-1)
        faces.append(torch.cat([t, mid, b], dim=-2))
    return torch.stack(faces, dim=2)


def conv(x, params, k, act: bool):
    """Conv ``k`` of the U-Net on (B, C, 6, n', n') faces (padded by 1
    for a 3 x 3 kernel): the equatorial kernel on faces 0-3, the polar one
    on the south face and on the north face flipped top to bottom (its
    output flipped back)."""
    pre = f"layers.0.CubeSphereConv2D_{k}"
    we, be = (params[f"{pre}.equatorial_kernel"],
              params[f"{pre}.equatorial_bias"])
    wp, bp = params[f"{pre}.polar_kernel"], params[f"{pre}.polar_bias"]
    out = [F.conv2d(x[:, :, f], we, be) for f in range(4)]
    out.append(F.conv2d(x[:, :, NORTH].flip(-2), wp, bp).flip(-2))
    out.append(F.conv2d(x[:, :, SOUTH], wp, bp))
    y = torch.stack(out, dim=2)
    return F.leaky_relu(y, 0.1) if act else y


def _over_faces(fn, x):
    B, C, six, n, _ = x.shape
    y = fn(x.reshape(B, C * six, n, n))
    return y.reshape(B, C, six, y.shape[-2], y.shape[-1])


def unet(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The U-Net on (B, C, 6, n, n) faces."""
    def c(k, h):
        return conv(pad(h, 1), params, k, True)

    def pool(h):
        return _over_faces(lambda t: F.avg_pool2d(t, 2), h)

    def up(h):
        return h.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    e1 = c(1, c(0, x))
    e2 = c(3, c(2, pool(e1)))
    b = c(5, c(4, pool(e2)))
    d2 = c(7, c(6, torch.cat([up(b), e2], dim=1)))
    d1 = c(9, c(8, torch.cat([up(d2), e1], dim=1)))
    return conv(d1, params, 10, False)


def forward(params: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """The model on ``x`` (B, C, 6 n, n) -> (B, c_out, 6 n, n)."""
    B, C, rows, n = x.shape
    y = unet(params, x.reshape(B, C, 6, n, n))
    return y.reshape(B, y.shape[1], rows, n)


def rollout(params: dict, cfg: dict, x0: torch.Tensor,
            init_days: torch.Tensor, steps: int):
    """Yield each step's prediction (B, T, C, 6 n, n) of a forecast from
    the window ``x0`` (B, T, C+1, 6 n, n; insolation last) whose last time
    is at day-of-year ``init_days`` (B,). The next window holds the
    prediction's T times and their insolation."""
    n = cfg["grid"]["face_size"]
    lat, lon = lat_lon(n)
    T = cfg["input_time_steps"]
    C = len(cfg["channels"])
    dt_days = cfg["dt_hours"] / 24.0
    B = x0.shape[0]
    x = x0
    for it in range(steps):
        pred = forward(params, cfg, x.reshape(B, -1, 6 * n, n)).reshape(
            B, T, C, 6 * n, n)
        yield pred
        if it + 1 == steps:
            break
        offs = torch.arange(T, dtype=torch.float64, device=x0.device)
        days = init_days.to(torch.float64)[:, None] + \
            ((it + 1) * T + offs - (T - 1))[None, :] * dt_days
        sol = insolation(days, lat, lon).to(x.dtype)
        x = torch.cat([pred, sol[:, :, None]], dim=2)


def loss(params: dict, cfg: dict, x: torch.Tensor, y: torch.Tensor):
    """Mean squared error of one model step from the window ``x`` (B, T,
    C+1, 6 n, n) against ``y`` (B, T, C, 6 n, n)."""
    B = x.shape[0]
    pred = forward(params, cfg, x.reshape((B, -1) + tuple(x.shape[-2:])))
    return torch.mean((pred.reshape(y.shape) - y) ** 2)

"""Plain reference of the DLWP CNNs built from layer specs, their forecast
rollout and their training step.

Written from the published description (jweyn/DLWP v0.7.0, Keras
semantics), not from ``dlwp_torch``:

- ``CyclicConv2D``: a convolution whose input is wrapped around in
  longitude and zero-padded in latitude ("same" output size), then bias and
  activation;
- ``ConvLSTM2D``: Keras's ConvLSTM with ``hard_sigmoid`` gates (``clip(0.2 z
  + 0.5, 0, 1)``) and ``tanh`` candidate and output, gates ordered i, f, g, o,
  both convs cyclic, the recurrent one undilated, starting from h = c = 0;
- ``MaxPooling2D(2)``, nearest ``UpSampling2D(2)``, ``Reshape``;
- top-of-atmosphere insolation from the first-order orbit with fixed 1995
  elements, in float64, from fractional day-of-year;
- the forecast: each step's prediction becomes the next window's fields,
  its insolation recomputed at the window's valid times;
- training: the model rolled ``S`` steps with the insolation of the input
  window persisted, the mean of the steps' cos(lat)-weighted MSE, global
  norm clipping at 1, Adam (b1 0.9, b2 0.999, eps 1e-8) at a cosine-decayed
  rate (optax's rules).

Everything runs in float32 with TF32 off unless :func:`precision` says
otherwise (the control runs it in TF32). :func:`walk` is the shape pass
over the specs that the benchmark's FLOP counts and weights come from.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from h100bench import specs

OBLIQUITY = math.radians(23.4441)
ECCENTRICITY = 0.016715
PERIHELION_LON = math.radians(282.7)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
KINDS = ("ConvLSTM2D", "CyclicConv2D", "Reshape", "MaxPooling2D",
         "UpSampling2D")


@contextlib.contextmanager
def precision(tf32: bool = False):
    """cuDNN and cuBLAS float32 products in TF32 (``tf32``) or in full
    float32 inside; the previous settings come back after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def day_of_year(times) -> np.ndarray:
    """Fractional days since 1 January of each datetime64's year."""
    t = np.asarray(times, dtype="datetime64[s]")
    return (t - t.astype("datetime64[Y]")).astype(np.float64) / 86400.0


def insolation(days: torch.Tensor, lat, lon) -> torch.Tensor:
    """``(..., nlat, nlon)`` float64 insolation, clipped at 0, for
    fractional days-of-year ``days`` (a float64 tensor, any shape)."""
    dev = days.device
    lat = torch.as_tensor(np.radians(np.asarray(lat, np.float64)),
                          device=dev)[:, None]
    lon = torch.as_tensor(np.asarray(lon, np.float64), device=dev)[None, :]
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


def input_shape(cfg: dict) -> tuple:
    """One sample's model input: (T, C+1, H, W) for a recurrent model,
    (T*(C+1), H, W) for a stacked one (the +1 is insolation)."""
    g = specs.grid(cfg)
    T = cfg["input_time_steps"]
    c = len(cfg["channels"]) + (1 if cfg["insolation"] else 0)
    if cfg["is_recurrent"]:
        return (T, c, g.nlat, g.nlon)
    return (T * c, g.nlat, g.nlon)


def _k(args) -> int:
    k = args[1] if len(args) > 1 else 3
    return k if isinstance(k, int) else k[0]


def walk(cfg: dict) -> list:
    """Every layer's shapes, leaves and multiply-adds for one sample."""
    shape = input_shape(cfg)
    out = []
    for i, (kind, args, kwargs) in enumerate(specs.layers(cfg)):
        kw = kwargs or {}
        params, macs = {}, 0
        if kind == "ConvLSTM2D":
            T, C, H, W = shape
            F, k = args[0], _k(args)
            params = {"input_kernel": (4 * F, C, k, k),
                      "recurrent_kernel": (4 * F, F, k, k),
                      "bias": (4 * F,)}
            # The recurrent conv of step 0 reads the zero state: not counted.
            macs = H * W * 4 * F * k * k * (T * C + (T - 1) * F)
            new = (T, F, H, W) if kw.get("return_sequences", True) \
                else (F, H, W)
        elif kind == "CyclicConv2D":
            C, H, W = shape
            O, k = args[0], _k(args)
            params = {"kernel": (O, C, k, k), "bias": (O,)}
            macs = H * W * O * C * k * k
            new = (O, H, W)
        elif kind == "MaxPooling2D":
            C, H, W = shape
            new = (C, H // 2, W // 2)
        elif kind == "UpSampling2D":
            C, H, W = shape
            new = (C, 2 * H, 2 * W)
        elif kind == "Reshape":
            new = tuple(args[0])
        else:
            raise ValueError(f"layer kind {kind!r} is not one of {KINDS}")
        out.append(specs.LayerShape(i, kind, tuple(args), dict(kw),
                                    tuple(shape), tuple(new), params, macs))
        shape = new
    return out


def _act(name):
    if name in (None, "linear"):
        return lambda t: t
    if name == "tanh":
        return torch.tanh
    if name == "sigmoid":
        return torch.sigmoid
    if name == "hard_sigmoid":
        return lambda t: torch.clamp(0.2 * t + 0.5, 0.0, 1.0)
    raise ValueError(f"activation {name!r} not in the reference")


def cyclic_conv(x, w, dilation: int = 1):
    """'Same' conv of (N, C, H, W) by (O, C, k, k): wrapped longitude,
    zero latitude."""
    k = w.shape[-1]
    e = (k - 1) * dilation
    left, right = e // 2, e - e // 2
    W = x.shape[-1]
    x = torch.cat([x[..., W - left:], x, x[..., :right]], dim=-1)
    x = F.pad(x, (0, 0, left, right))
    return F.conv2d(x, w, dilation=dilation)


def _conv_lstm(x, p, prefix, args, kw):
    B, T, C, H, W = x.shape
    act = _act(kw.get("activation", "tanh"))
    r_act = _act(kw.get("recurrent_activation", "hard_sigmoid"))
    d = kw.get("dilation", 1)
    wx, wh, b = (p[f"{prefix}.input_kernel"], p[f"{prefix}.recurrent_kernel"],
                 p[f"{prefix}.bias"])
    F_ = b.shape[0] // 4
    h = c = None
    hs = []
    for t in range(T):
        z = cyclic_conv(x[:, t], wx, d) + b[:, None, None]
        if h is not None:
            z = z + cyclic_conv(h, wh, 1)
        i, f, g, o = torch.split(z, F_, dim=1)
        c = r_act(i) * act(g) if c is None else r_act(f) * c + r_act(i) * act(g)
        h = r_act(o) * act(c)
        hs.append(h)
    return torch.stack(hs, 1) if kw.get("return_sequences", True) else h


def forward(params: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """The model applied to a batch ``x``; ``params`` maps
    ``layers.<i>.<leaf>`` to tensors."""
    for i, (kind, args, kw) in enumerate(specs.layers(cfg)):
        kw = kw or {}
        prefix = f"layers.{i}"
        if kind == "ConvLSTM2D":
            x = _conv_lstm(x, params, prefix, args, kw)
        elif kind == "CyclicConv2D":
            x = cyclic_conv(x, params[f"{prefix}.kernel"], kw.get("dilation", 1))
            x = _act(kw.get("activation"))(x + params[f"{prefix}.bias"][:, None, None])
        elif kind == "MaxPooling2D":
            x = F.max_pool2d(x, 2)
        elif kind == "UpSampling2D":
            x = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        elif kind == "Reshape":
            x = x.reshape((x.shape[0],) + tuple(args[0]))
        else:
            raise ValueError(f"layer kind {kind!r} not in the reference")
    return x


def _window(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """A (B, T, C+1, H, W) window as the model takes it."""
    if cfg["is_recurrent"]:
        return x
    return x.reshape((x.shape[0], -1) + tuple(x.shape[-2:]))


def rollout(params: dict, cfg: dict, x0: torch.Tensor,
            init_days: torch.Tensor, steps: int):
    """Yield each step's prediction (B, T, C, H, W) of a forecast from the
    window ``x0`` (B, T, C+1, H, W; insolation last) whose last time is at
    day-of-year ``init_days`` (B,). The next window holds the prediction's
    T times and their insolation: T data steps later than the last."""
    g = specs.grid(cfg)
    T = cfg["input_time_steps"]
    C = len(cfg["channels"])
    dt_days = cfg["dt_hours"] / 24.0
    B = x0.shape[0]
    x = x0
    for it in range(steps):
        pred = forward(params, cfg, _window(cfg, x)).reshape(
            B, T, C, g.nlat, g.nlon)
        yield pred
        if it + 1 == steps:
            break
        offs = torch.arange(T, dtype=torch.float64, device=x0.device)
        days = init_days.to(torch.float64)[:, None] + \
            ((it + 1) * T + offs - (T - 1))[None, :] * dt_days
        sol = insolation(days, g.lat(), g.lon()).to(x.dtype)
        x = torch.cat([pred, sol[:, :, None]], dim=2)


def lat_weights(cfg: dict, device) -> torch.Tensor:
    g = specs.grid(cfg)
    return torch.cos(torch.deg2rad(torch.tensor(
        g.lat(), dtype=torch.float64, device=device))).to(torch.float32)


def sequence_loss(params, cfg, x, y):
    """Mean over the S steps of the cos(lat)-weighted MSE; ``y`` is (B, S,
    T, C, H, W). Each prediction's fields replace the window's, its
    insolation persists."""
    w = lat_weights(cfg, x.device)[:, None]
    C = len(cfg["channels"])
    losses, inp = [], x
    for s in range(y.shape[1]):
        pred = forward(params, cfg, _window(cfg, inp)).reshape(y[:, s].shape)
        losses.append(torch.mean((y[:, s] * w - pred * w) ** 2))
        inp = torch.cat([pred, inp[:, :, C:]], dim=2)
    return torch.stack(losses).mean()


def cosine_lr(cfg_train: dict, count: int) -> float:
    c = min(float(count), float(cfg_train["decay_steps"]))
    cosine = 0.5 * (1 + math.cos(math.pi * c / cfg_train["decay_steps"]))
    a = cfg_train["alpha"]
    return cfg_train["learning_rate"] * ((1 - a) * cosine + a)


def train(params0: dict, cfg: dict, batches, cfg_train: dict):
    """Train from ``params0`` over ``batches`` [(x, y), ...]: returns the
    step losses (float64), the first step's clipped gradient and the
    parameters after the last step, as dicts of tensors."""
    names = list(params0)
    p = {n: params0[n].detach().clone() for n in names}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, first_grad = [], None
    for k, (x, y) in enumerate(batches):
        leaves = {n: t.detach().requires_grad_(True) for n, t in p.items()}
        loss = sequence_loss(leaves, cfg, x, y)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = 1.0 if float(norm) < cfg_train["clip_norm"] else \
            cfg_train["clip_norm"] / norm
        grads = {n: g * scale for n, g in zip(names, grads)}
        if k == 0:
            first_grad = {n: g.detach().clone() for n, g in grads.items()}
        lr = cosine_lr(cfg_train, k)
        t = k + 1
        with torch.no_grad():
            for n in names:
                mu[n] = ADAM_B1 * mu[n] + (1 - ADAM_B1) * grads[n]
                nu[n] = ADAM_B2 * nu[n] + (1 - ADAM_B2) * grads[n] ** 2
                m_hat = mu[n] / (1 - ADAM_B1 ** t)
                v_hat = nu[n] / (1 - ADAM_B2 ** t)
                p[n] = p[n] - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first_grad, "params": p}

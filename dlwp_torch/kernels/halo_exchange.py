"""Latitude halo exchange over lat-band shards (kernel ``csrc/halo_exchange.cu``).

Port of ``dlwp_tpu.parallel.pallas_halo.pallas_halo_exchange_lat`` (the
Pallas ``_halo_kernel``). Shards come as ``shards[d][l]``: data row ``d``,
latitude band ``l`` (north to south), each a contiguous (..., H, W)
tensor. :func:`halo_exchange` returns the padded blocks (..., top + H +
bot, W) in the same layout, in the input dtype, with zeros north of the
first band and south of the last. For CUDA tensors it launches the kernel
once per card, covering every shard on it; for CPU tensors it takes the
plain version, :func:`halo_exchange_plain`. ``halo_exchange.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from dlwp_torch.kernels import _build

PEER_TODO = ("a lat neighbour on another card needs peer access, which is "
             "not ported yet (ROADMAP.md section 1, item 6e)")


def halo_rows_plain(row: list[torch.Tensor],
                    halo: tuple[int, int]) -> list[torch.Tensor]:
    """The padded blocks of one data row of lat-ordered shards."""
    top, bot = halo
    n = len(row)
    out = []
    for i, x in enumerate(row):
        parts = []
        if top > 0:
            parts.append(row[i - 1][..., -top:, :].to(x.device) if i > 0
                         else x.new_zeros(x.shape[:-2] + (top, x.shape[-1])))
        parts.append(x)
        if bot > 0:
            parts.append(row[i + 1][..., :bot, :].to(x.device) if i < n - 1
                         else x.new_zeros(x.shape[:-2] + (bot, x.shape[-1])))
        out.append(torch.cat(parts, dim=-2))
    return out


def halo_exchange_plain(shards, halo):
    return [halo_rows_plain(row, halo) for row in shards]


def check_shards(shards, name: str) -> torch.Tensor:
    """Raise unless ``shards`` is a non-empty grid of same-shaped,
    same-typed tensors of rank >= 2, all on the CPU or all on CUDA; return
    the first."""
    if not shards or not shards[0] or any(len(r) != len(shards[0])
                                          for r in shards):
        raise ValueError(f"{name}: shards must be a non-empty grid [d][l]")
    first = shards[0][0]
    if first.dim() < 2:
        raise ValueError(f"{name}: shards need (..., H, W), got "
                         f"{tuple(first.shape)}")
    kinds = set()
    for row in shards:
        for s in row:
            if s.shape != first.shape or s.dtype != first.dtype:
                raise ValueError(
                    f"{name}: shards differ: {tuple(s.shape)} {s.dtype} vs "
                    f"{tuple(first.shape)} {first.dtype}")
            kinds.add(s.device.type)
    if kinds not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"{name}: shards on {sorted(kinds)}; need all on "
                         "the CPU or all on CUDA")
    return first


def device_groups(shards, name: str):
    """``{device: [(d, l), ...]}`` over CUDA shards; raises if a lat
    neighbour sits on another card."""
    groups: dict[torch.device, list[tuple[int, int]]] = {}
    for d, row in enumerate(shards):
        for l, s in enumerate(row):
            for nb in (l - 1, l + 1):
                if 0 <= nb < len(row) and row[nb].device != s.device:
                    raise NotImplementedError(f"{name}: {PEER_TODO}")
            if not s.is_contiguous():
                raise ValueError(f"{name}: shards must be contiguous")
            groups.setdefault(s.device, []).append((d, l))
    return groups


def neighbour_table(keys):
    """Per-shard indices of the northern and southern neighbour within
    ``keys`` (a list of (d, l)), -1 for none."""
    pos = {k: i for i, k in enumerate(keys)}
    north = [pos.get((d, l - 1), -1) for d, l in keys]
    south = [pos.get((d, l + 1), -1) for d, l in keys]
    return north, south


def _lib():
    lib = _build.load("halo_exchange")
    fn = lib.dlwp_halo_exchange
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dlwp_halo_exchange_max_shards.restype = ctypes.c_int
    return lib


def halo_exchange(shards, halo):
    """``shards[d][l]`` (..., H, W) -> padded blocks (..., top + H + bot, W)."""
    top, bot = (int(h) for h in halo)
    first = check_shards(shards, "halo_exchange")
    H, W = first.shape[-2:]
    if not (0 <= top <= H and 0 <= bot <= H):
        raise ValueError(f"halo_exchange: halo {halo} outside [0, {H}]")
    if first.device.type == "cpu":
        return halo_exchange_plain(shards, (top, bot))
    groups = device_groups(shards, "halo_exchange")
    if top == 0 and bot == 0:
        return [list(row) for row in shards]
    rows = first.numel() // (H * W)
    row_bytes = W * first.element_size()
    if rows * (top + H + bot) >= 2 ** 31 or rows * H * W >= 2 ** 31:
        raise ValueError(f"halo_exchange: shards too large, {first.shape}")
    out_shape = first.shape[:-2] + (top + H + bot, W)
    out = [[None] * len(row) for row in shards]
    lib = _lib()
    for dev, keys in groups.items():
        if len(keys) > lib.dlwp_halo_exchange_max_shards():
            raise ValueError(f"halo_exchange: {len(keys)} shards on {dev}")
        for d, l in keys:
            out[d][l] = torch.empty(out_shape, device=dev, dtype=first.dtype)
        src = [shards[d][l].data_ptr() for d, l in keys]
        dst = [out[d][l].data_ptr() for d, l in keys]
        unit = next(u for u in (16, 8, 4, 2, 1)
                    if row_bytes % u == 0 and all(p % u == 0
                                                  for p in src + dst))
        north, south = neighbour_table(keys)
        n = len(keys)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.dlwp_halo_exchange(
                (ctypes.c_void_p * n)(*src), (ctypes.c_void_p * n)(*dst),
                (ctypes.c_int * n)(*north), (ctypes.c_int * n)(*south), n,
                rows, H, row_bytes, unit, top, bot, stream)
        if err:
            raise RuntimeError(f"halo_exchange launch failed: CUDA error {err}")
        halo_exchange.launches += 1
    return out


halo_exchange.launches = 0

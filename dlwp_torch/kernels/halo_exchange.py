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
import functools
from typing import NamedTuple

import torch

from dlwp_torch.kernels import _build


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


class Group(NamedTuple):
    """One card's launch: its shards, which it writes (``outputs``, (d, l)
    keys); every shard it reads (``sources``: the outputs, then the lat
    neighbours that sit on other cards, source-only entries); each
    output's northern and southern neighbour as an index into
    ``sources`` (-1 for none); and the other cards it reads (``peers``)."""
    outputs: list
    sources: list
    north: list
    south: list
    peers: list


def device_groups(devices) -> dict:
    """``{card: Group}`` for shards on ``devices[d][l]`` (the shards'
    devices, lat-ordered within each data row): a pure function of the
    layout, which needs no card."""
    return _groups(tuple(tuple(row) for row in devices))


@functools.cache  # a launch's plan depends on its layout alone
def _groups(devices) -> dict:
    groups: dict = {}
    for d, row in enumerate(devices):
        for l, dev in enumerate(row):
            groups.setdefault(dev, []).append((d, l))
    out = {}
    for dev, keys in groups.items():
        sources = list(keys)
        pos = {k: i for i, k in enumerate(keys)}
        peers = []

        def index(d, l):
            if not 0 <= l < len(devices[d]):
                return -1
            if (d, l) not in pos:
                pos[(d, l)] = len(sources)
                sources.append((d, l))
                if devices[d][l] not in peers:
                    peers.append(devices[d][l])
            return pos[(d, l)]

        north = [index(d, l - 1) for d, l in keys]
        south = [index(d, l + 1) for d, l in keys]
        out[dev] = Group(keys, sources, north, south, peers)
    return out


def check_contiguous(shards, name: str) -> None:
    for row in shards:
        for s in row:
            if not s.is_contiguous():
                raise ValueError(f"{name}: shards must be contiguous")


_PEERS_ENABLED: set = set()  # (reader, owner) card indices; process state


def enable_peer_access(dev: torch.device, peer: torch.device,
                       name: str) -> None:
    """Let card ``dev`` read card ``peer``'s memory (once per ordered pair
    in the process); raises, naming both cards, where the pair has no peer
    access."""
    pair = (dev.index, peer.index)
    if pair in _PEERS_ENABLED:
        return
    if not torch.cuda.can_device_access_peer(dev.index, peer.index):
        raise RuntimeError(
            f"{name}: {dev} cannot read {peer} (no peer access between the "
            "two cards); put lat neighbours on cards with peer access")
    err = _lib().dlwp_enable_peer_access(dev.index, peer.index)
    if err:
        raise RuntimeError(f"{name}: enabling peer access from {dev} to "
                           f"{peer} failed: CUDA error {err}")
    _PEERS_ENABLED.add(pair)


def wait_for_peers(dev: torch.device, group: Group, name: str) -> None:
    """Before card ``dev``'s launch: peer access to every card it reads,
    and its current stream waits on each such card's current stream,
    where the neighbours' shards were written."""
    if not group.peers:
        return
    stream = torch.cuda.current_stream(dev)
    for peer in group.peers:
        enable_peer_access(dev, peer, name)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(peer))
        stream.wait_event(event)


def release_peers(dev: torch.device, group: Group, shards) -> None:
    """After card ``dev``'s launch: each shard it read on another card is
    marked in use on its stream, so that the caching allocator does not
    reuse that memory while the read may be in flight."""
    if not group.peers:
        return
    stream = torch.cuda.current_stream(dev)
    for d, l in group.sources[len(group.outputs):]:
        shards[d][l].record_stream(stream)


def _lib():
    lib = _build.load("halo_exchange")
    fn = lib.dlwp_halo_exchange
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dlwp_halo_exchange_max_shards.restype = ctypes.c_int
    lib.dlwp_enable_peer_access.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dlwp_enable_peer_access.restype = ctypes.c_int
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
    check_contiguous(shards, "halo_exchange")
    groups = device_groups([[s.device for s in row] for row in shards])
    if top == 0 and bot == 0:
        return [list(row) for row in shards]
    rows = first.numel() // (H * W)
    row_bytes = W * first.element_size()
    if rows * (top + H + bot) >= 2 ** 31 or rows * H * W >= 2 ** 31:
        raise ValueError(f"halo_exchange: shards too large, {first.shape}")
    out_shape = first.shape[:-2] + (top + H + bot, W)
    out = [[None] * len(row) for row in shards]
    lib = _lib()
    for dev, g in groups.items():
        if len(g.sources) > lib.dlwp_halo_exchange_max_shards():
            raise ValueError(f"halo_exchange: {len(g.sources)} shards read "
                             f"on {dev}")
        for d, l in g.outputs:
            out[d][l] = torch.empty(out_shape, device=dev, dtype=first.dtype)
        src = [shards[d][l].data_ptr() for d, l in g.sources]
        dst = [out[d][l].data_ptr() for d, l in g.outputs]
        unit = next(u for u in (16, 8, 4, 2, 1)
                    if row_bytes % u == 0 and all(p % u == 0
                                                  for p in src + dst))
        n, n_src = len(dst), len(src)
        with torch.cuda.device(dev):
            wait_for_peers(dev, g, "halo_exchange")
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.dlwp_halo_exchange(
                (ctypes.c_void_p * n_src)(*src), (ctypes.c_void_p * n)(*dst),
                (ctypes.c_int * n)(*g.north), (ctypes.c_int * n)(*g.south),
                n, n_src, rows, H, row_bytes, unit, top, bot, stream)
        if err:
            raise RuntimeError(f"halo_exchange launch failed: CUDA error {err}")
        release_peers(dev, g, shards)
        halo_exchange.launches += 1
    return out


halo_exchange.launches = 0

"""3x3 cyclic conv of lat-band shards (kernel ``csrc/overlap_conv.cu``).

Port of the two Pallas kernels of ``dlwp_tpu.parallel.pallas_overlap``:
:func:`overlap_conv` of ``_overlap_kernel`` (one tile per block) and
:func:`overlap_conv_db` of ``_overlap_kernel_db`` (a persistent grid
walking the tiles ``chunk`` by ``chunk``). Both compute, for
``shards[d][l]`` (B, C, H, W), ``cyclic_conv2d(x, kernel,
lat_mode='zero')`` of each data row's global field band by band, reading
the neighbouring bands' edge rows, in float32 whatever the input dtype,
and agree bit for bit. For CUDA tensors each launches its kernel once per
card, covering every shard on it, with the tiling of :func:`_plan` (over
the card's own shards); a lat neighbour on another card is read there
through peer access, and one in another process from that process's edge
mailbox, mapped over CUDA IPC, as in
:mod:`dlwp_torch.kernels.halo_exchange` (a ``Remote`` shard comes back as
it is). For CPU tensors both take the plain version,
:func:`overlap_conv_plain`.
``.launches`` counts kernel launches; ``.last_launch`` holds the plan and
grid of the last one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dlwp_torch.kernels import _build
from dlwp_torch.kernels._tiling import (
    MAX_GRID,
    MAX_SMEM,
    N_SM,
    TWO_PER_SM,
    ring,
    sm_count,
)
from dlwp_torch.kernels.halo_exchange import (
    check_contiguous,
    check_shards,
    device_groups,
    halo_exchange_plain,
    is_remote,
    mailbox,
    release_peers,
    source_rows,
    wait_for_peers,
)
from dlwp_torch.ops.padding import pad_latlon
from dlwp_torch.utils.profiling import span


def overlap_conv_plain(shards, kernel):
    """Per shard: neighbour rows, longitude wrap, VALID conv, in float32
    (a ``Remote`` shard stays)."""
    padded = halo_exchange_plain(
        [[s if is_remote(s) else s.float() for s in row] for row in shards],
        (1, 1))
    return [[p if is_remote(p) else
             F.conv2d(pad_latlon(p, (0, 0), (1, 1)),
                      kernel.to(device=p.device, dtype=torch.float32))
             for p in row] for row in padded]


def _check(shards, kernel, name):
    first = check_shards(shards, name)
    if first.dim() != 4:
        raise ValueError(f"{name}: shards must be (B, C, H, W), got "
                         f"{tuple(first.shape)}")
    B, C, H, W = first.shape
    O = kernel.shape[0]
    if kernel.shape != (O, C, 3, 3):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} is not "
                         f"(O, {C}, 3, 3)")
    if H < 2:
        raise ValueError(f"{name}: need at least 2 local rows, got {H}")
    return first


# Tile constants of csrc/overlap_conv.cu.
_CS, _LM, _WR, _MW, _MAX_WARPS = 8, 4, 76, 2, 10
_OG = (64, 32)  # output channels an o-group may have
_MAX_NTW = 4  # n8 tiles a warp: its fp32 sums and chains fit the registers


class Plan(NamedTuple):
    """One launch's tiling (see csrc/overlap_conv.cu): tiles of ``bb``
    samples x ``rb`` output rows of one shard, full width, an o-group of
    ``nt`` n8 tiles of output channels (``n_og`` groups); ``warps``
    warps, each of ``_MW`` 16-pixel fragments x ``ntw`` n8 tiles; a ring of
    ``stages`` buffers of input rows, and of weights unless the weights of
    every slab are ``resident``, ``smem`` bytes in all; ``tiles`` tiles,
    chunk-major."""
    bb: int
    rb: int
    warps: int
    stages: int
    rs: int
    nt: int
    ntw: int
    n_og: int
    smem: int
    tiles: int
    chunk: int
    nfrag: int
    n_rg: int
    resident: bool


def _row_stride(nfrag):
    """Floats per staged row: margin, the fragments' columns and the right
    wrap column, a multiple of 4 that is 8 or 24 mod 32, so the A fragment
    loads (4 channels x 8 columns a warp) hit 32 banks."""
    rs = -(-(_LM + 16 * nfrag + 1) // 4) * 4
    while rs % 32 not in (8, 24):
        rs += 4
    return rs


def _sample_groups(B, chunk, bb):
    """Sample groups of ``bb`` per chunk, summed over the chunks that hold
    samples (a chunk past the batch end has none)."""
    full, last = divmod(B, chunk)
    return full * -(-chunk // bb) + (-(-last // bb) if last else 0)


def _candidates(B, C, H, W, O, chunk, n_shards):
    """Every tiling of at most ``_MAX_WARPS`` warps whose ring fits shared
    memory, with its share of masked (sample, row) slots."""
    persistent = chunk is not None
    chunk = B if chunk is None else min(int(chunk), B)
    nfrag = -(-W // 16)
    rs = _row_stride(nfrag)
    shapes = {(-(-min(O, og) // 8), -(-O // og)) for og in _OG}
    for nt, n_og, ntw in ((nt, n_og, d) for nt, n_og in sorted(shapes)
                          for d in range(1, min(nt, _MAX_NTW) + 1)
                          if nt % d == 0):
        for rb in range(1, H + 1):
            n_rg = -(-H // rb)
            for bb in range(1, chunk + 1):
                warps = -(-bb * rb * nfrag // _MW) * (nt // ntw)
                if warps > _MAX_WARPS:
                    break
                # Weights stay only where a block walks several tiles of
                # one o-group; two blocks an SM.
                layout = ring(4 * bb * (rb + 2) * _CS * rs,
                              4 * nt * 8 * _WR, -(-C // _CS),
                              persistent and n_og == 1, TWO_PER_SM)
                if layout is None:
                    break
                groups = _sample_groups(B, chunk, bb)
                yield (Plan(bb, rb, warps, layout[0], rs, nt, ntw, n_og,
                            layout[1], groups * n_og * n_shards * n_rg,
                            chunk, nfrag, n_rg, layout[2]),
                       1 - B * H / (groups * bb * n_rg * rb))


@functools.cache  # a launch's plan depends on its shapes alone
def _plan(B, C, H, W, O, chunk, n_shards, n_sm=N_SM) -> Plan:
    """The tiling of one launch; ``chunk`` None is the single-shot form
    (one chunk of B). Among the candidates: enough tiles for two per SM
    and enough warps for 16 per SM where the work has them (else as many
    as it has), masked samples and rows at most 1/8 where possible; then
    the widest o-group (fewest input loads), the most n8 tiles a warp
    (fewest fragment loads an mma), the most fragments a tile (fewest
    weight loads)."""
    cands = list(_candidates(B, C, H, W, O, chunk, n_shards))
    if not cands:
        raise ValueError(f"overlap_conv: no tile fits W={W}, C={C}, O={O}")
    want_tiles = min(2 * n_sm, max(p.tiles for p, _ in cands))
    ok = [(p, w) for p, w in cands if p.tiles >= want_tiles]
    want_warps = min(16 * n_sm, max(p.tiles * p.warps for p, _ in ok))
    ok = [(p, w) for p, w in ok if p.tiles * p.warps >= want_warps]
    ok = [(p, w) for p, w in ok if w <= 0.125] or ok
    return max(ok, key=lambda pw: (pw[0].nt, pw[0].ntw, pw[0].bb * pw[0].rb,
                                   -pw[1], pw[0].rb))[0]


def _tile(plan: Plan, B, H, n_shards, t):
    """Tile ``t`` of a plan, as the kernel decodes it: (shard, first
    sample, samples, first row, rows, o-group)."""
    ts = plan.n_og * n_shards * plan.n_rg
    per_chunk = -(-plan.chunk // plan.bb) * ts
    j, r = divmod(t, per_chunk)
    q = r % ts
    b0 = j * plan.chunk + (r // ts) * plan.bb
    nb = min(plan.bb, min((j + 1) * plan.chunk, B) - b0)
    h0 = (q % plan.n_rg) * plan.rb
    return ((q // plan.n_rg) % n_shards, b0, nb, h0, min(plan.rb, H - h0),
            q // (n_shards * plan.n_rg))


@functools.cache
def _lib():
    lib = _build.load("overlap_conv")
    head = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    tail = [ctypes.c_void_p] * 3  # plan, stream, grid_out
    lib.dlwp_overlap_conv.argtypes = head + [ctypes.c_int] * 5 + tail
    lib.dlwp_overlap_conv_db.argtypes = head + [ctypes.c_int] * 6 + tail
    for fn in (lib.dlwp_overlap_conv, lib.dlwp_overlap_conv_db,
               lib.dlwp_overlap_conv_max_shards):
        fn.restype = ctypes.c_int
    return lib


def _launch(shards, kernel, chunk, name):
    """One launch per card; ``chunk`` None selects ``dlwp_overlap_conv``."""
    first = check_shards(shards, name)
    B, C, H, W = first.shape
    O = kernel.shape[0]
    if first.dtype != torch.float32:
        raise ValueError(f"{name}: shards must be float32, got {first.dtype}")
    check_contiguous(shards, name)
    layout = tuple(tuple(s if is_remote(s) else s.device for s in row)
                   for row in shards)
    groups = device_groups(layout)
    lib = _lib()
    out = [[s if is_remote(s) else None for s in row] for row in shards]
    readers = [dev for dev, g in groups.items() if g.slabs]
    box = mailbox(layout, first, (1, 1), name) if readers else None
    if box is not None:
        box.post(shards, readers)
    for dev, g in groups.items():
        n, n_src = len(g.outputs), len(g.sources)
        if n_src > lib.dlwp_overlap_conv_max_shards():
            raise ValueError(f"{name}: {n_src} shards read on {dev}, more "
                             f"than {lib.dlwp_overlap_conv_max_shards()}")
        plan = _plan(B, C, H, W, O, chunk, n, sm_count(dev))
        if plan.tiles > MAX_GRID or max(B * C, B * O) * H * W >= 2 ** 31:
            raise ValueError(f"{name}: {n} shards of {tuple(first.shape)} "
                             "are too large")
        k = kernel.to(device=dev, dtype=torch.float32).contiguous()
        slabs = {i: box.slab(rank, slot) for i, rank, slot in g.slabs}
        xs = [slabs[i] if i in slabs else shards[d][l].data_ptr()
              for i, (d, l) in enumerate(g.sources)]
        for d, l in g.outputs:
            out[d][l] = torch.empty((B, O, H, W), device=dev,
                                    dtype=torch.float32)
        vec_x = W % 4 == 0 and all(p % 16 == 0 for p in xs)
        vec_w = C % 4 == 0 and k.data_ptr() % 16 == 0
        fields = (plan.bb, plan.rb, plan.warps, plan.stages, plan.rs, plan.nt,
                  plan.ntw, plan.n_og, int(vec_x), int(vec_w), plan.smem,
                  plan.tiles, int(plan.resident))
        grid = ctypes.c_int(0)
        args = [
            (ctypes.c_void_p * n_src)(*xs),
            (ctypes.c_int * n_src)(*source_rows(g, H, 2)),
            (ctypes.c_void_p * n)(*[out[d][l].data_ptr()
                                    for d, l in g.outputs]),
            (ctypes.c_int * n)(*g.north), (ctypes.c_int * n)(*g.south), n,
            n_src, k.data_ptr(), B, C, H, W, O,
        ]
        if chunk:
            args.append(plan.chunk)
        args += [(ctypes.c_int * len(fields))(*fields)]
        with torch.cuda.device(dev):
            wait_for_peers(dev, g, name)
            stream = torch.cuda.current_stream().cuda_stream
            fn = lib.dlwp_overlap_conv_db if chunk else lib.dlwp_overlap_conv
            err = fn(*args, stream, ctypes.byref(grid))
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        release_peers(dev, g, shards)
        wrapper = overlap_conv_db if chunk else overlap_conv
        wrapper.launches += 1
        wrapper.last_launch = (plan, grid.value)
    if box is not None:
        box.done(readers)
    return out


@span("kernel.overlap_conv")
def overlap_conv(shards, kernel):
    """``shards[d][l]`` (B, C, H, W), kernel (O, C, 3, 3) -> (B, O, H, W)
    float32 per shard."""
    if _check(shards, kernel, "overlap_conv").device.type == "cpu":
        return overlap_conv_plain(shards, kernel)
    return _launch(shards, kernel, None, "overlap_conv")


@span("kernel.overlap_conv_db")
def overlap_conv_db(shards, kernel, chunk: int):
    """As :func:`overlap_conv`, each block walking the batch in ``chunk``
    samples at a time (the batch need not divide into chunks)."""
    first = _check(shards, kernel, "overlap_conv_db")
    if chunk < 1:
        raise ValueError(f"overlap_conv_db: chunk {chunk} < 1")
    if first.device.type == "cpu":
        return overlap_conv_plain(shards, kernel)
    return _launch(shards, kernel, int(chunk), "overlap_conv_db")


overlap_conv.launches = 0
overlap_conv_db.launches = 0
overlap_conv.last_launch = overlap_conv_db.last_launch = None

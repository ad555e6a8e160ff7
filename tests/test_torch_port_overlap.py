"""The overlap-conv kernels' tile plan and arithmetic, on the CPU.

``csrc/overlap_conv.cu`` runs only on the card; what decides its launches
is the pure-Python plan of ``dlwp_torch.kernels.overlap_conv``. The plan is
held, at every shape the flagship's sharded path and ``chip_smoke.py``
give it and over a sweep of batch sizes and chunks, to four things: every
(shard, sample, output row, output channel group) is one tile's exactly
once; tiles are chunk-major and no tile straddles a chunk, also as the
persistent form's blocks walk them; the ring fits a block's 227 KB of
shared memory; the grid and the block are within CUDA's limits.

The kernel's 3xTF32 products are emulated here in float64 on CPU tensors
(hi rounded to TF32's 10 mantissa bits, lo read as TF32, lo * lo dropped,
each tensor-core sum truncated to fp32, each slab's chain added to fp32
sums): at the depths of the path's convs it stays under 1e-5 of float64
on unit inputs with kernels scaled 1/sqrt(9C), the tolerance the card
checks hold it to.
"""

import itertools

import pytest
import torch

from dlwp_torch.kernels._tiling import MAX_SMEM as _MAX_SMEM
from dlwp_torch.kernels.overlap_conv import _plan, _tile

# (B, C, H of a shard, W, O, chunk, shards on the card); chunk None is
# the single-shot form. The flagship's launches on the lat=2 mesh of one
# card: five a step at B=64, three at B=8.
FLAGSHIP = [
    (64, 12, 18, 144, 48, 5, 2),
    (64, 32, 9, 72, 64, 11, 2),
    (28, 128, 9, 72, 64, 4, 2),
    (28, 128, 9, 72, 64, 4, 2),
    (8, 128, 9, 72, 64, 4, 2),
    (8, 12, 18, 144, 48, None, 2),
    (8, 32, 9, 72, 64, None, 2),
    (8, 128, 9, 72, 64, None, 2),
]
# chip_smoke.py's check cases on its meshes (data, lat) of one card, the
# card test's, and wider O than one o-group of 64.
CHECKS = [
    (b // data, c, h // lat, w, o, chunk, data * lat)
    for (b, c, h, w, o, chunk), (data, lat) in itertools.product(
        [(64, 12, 36, 144, 48, 5), (64, 32, 18, 72, 64, 11),
         (64, 128, 18, 72, 64, 4), (5, 3, 8, 18, 7, 2),
         (6, 12, 8, 72, 48, 4), (4, 128, 8, 144, 7, 3),
         (6, 32, 8, 18, 64, 5)],
        [(1, 1), (1, 2), (1, 4), (2, 2)])
    if h % lat == 0 and h // lat >= 2 and b % data == 0
] + [(5, 3, 4, 18, 7, 2, 2), (3, 5, 6, 40, 130, 2, 3),
     (2, 9, 3, 16, 65, None, 1)]


def check_plan(B, C, H, W, O, chunk, n):
    plan = _plan(B, C, H, W, O, chunk, n)
    assert plan.smem <= _MAX_SMEM
    assert 1 <= plan.tiles <= 2 ** 31 - 1
    assert plan.nt % plan.ntw == 0
    assert plan.warps == -(-plan.bb * plan.rb * plan.nfrag // 2) * (
        plan.nt // plan.ntw) and plan.warps * 32 <= 1024
    assert plan.rs % 4 == 0 and plan.rs % 32 in (8, 24)
    assert plan.rs >= 4 + 16 * plan.nfrag + 1 and plan.nfrag * 16 >= W
    assert plan.nt <= 8 and (plan.n_og - 1) * plan.nt * 8 < O <= (
        plan.n_og * plan.nt * 8)
    # weights stay in shared memory only where a block walks several tiles
    # of one o-group
    assert not plan.resident or (chunk is not None and plan.n_og == 1)
    seen = {}
    tiles = [_tile(plan, B, H, n, t) for t in range(plan.tiles)]
    for s, b0, nb, h0, nr, og in tiles:
        assert 1 <= nb <= plan.bb and 1 <= nr <= plan.rb
        # a tile never straddles a chunk
        assert b0 // plan.chunk == (b0 + nb - 1) // plan.chunk
        for b, h in itertools.product(range(b0, b0 + nb), range(h0, h0 + nr)):
            key = (s, b, h, og)
            assert key not in seen
            seen[key] = True
    assert len(seen) == n * B * H * plan.n_og
    # chunk-major: in the tile order, and in each persistent block's walk
    chunks = [b0 // plan.chunk for _, b0, *_ in tiles]
    assert chunks == sorted(chunks)
    for grid in {1, 7, 132, 264, plan.tiles}:
        for blk in range(min(grid, plan.tiles)):
            walk = chunks[blk::grid]
            assert walk == sorted(walk)
    return plan


@pytest.mark.parametrize("case", FLAGSHIP + CHECKS,
                         ids=lambda c: "-".join(map(str, c)))
def test_plan_covers_every_output_once(case):
    check_plan(*case)


def test_plan_fills_the_card_on_the_flagship_path():
    """The five B=64 launches a step give two tiles per SM or more; the
    B=8 launches at least one (tower conv 2 has 144 (sample, row) pairs)."""
    for case in FLAGSHIP:
        plan = _plan(*case)
        assert plan.tiles >= (264 if case[0] >= 28 else 132), (case, plan)


@pytest.mark.parametrize("chunk", [1, 2, 4, 5, 11])
@pytest.mark.parametrize("shape", [(12, 18, 144, 48, 2), (128, 9, 72, 64, 2),
                                   (3, 4, 18, 7, 4)])
def test_plan_batch_sweep(shape, chunk):
    C, H, W, O, n = shape
    for B in range(1, 71):
        plan = check_plan(B, C, H, W, O, chunk, n)
        assert plan.chunk == min(chunk, B)


def _tf32_round(x):
    """float32 rounded to TF32 (10 mantissa bits), nearest, ties away: the
    kernel's hi part."""
    bits = (x.view(torch.int32).to(torch.int64) + 0x1000) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def _tf32_read(x):
    """float32 as the tensor core reads it in TF32: low 13 bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tc_sum(acc, a, b):
    """One m16n8k8 step: acc + a @ b with exact products, the sum
    truncated to fp32 (toward zero)."""
    exact = acc.double() + a.double() @ b.double()
    f = exact.float()
    over = f.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _emulate(a, b, chain):
    """3xTF32 dot products of the rows of ``a`` with ``b``: hi rounded to
    TF32, lo = v - hi read by the tensor core as TF32, lo * lo dropped;
    lo_a hi_b, hi_a lo_b, hi_a hi_b of each k8 step chained on the tensor
    core for ``chain`` k8 steps, each chain added to fp32 sums."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    acc = torch.zeros(a.shape[0])
    for k0 in range(0, a.shape[1], 8 * chain):
        d = torch.zeros_like(acc)
        for k in range(k0, min(k0 + 8 * chain, a.shape[1]), 8):
            s = slice(k, k + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                d = _tc_sum(d, x[:, s], y[s])
        acc = acc + d
    return acc


@pytest.mark.parametrize("C", [16, 32, 128])
def test_3xtf32_split_meets_fp32_tolerance(C):
    """K = 9 C, as one output of the recurrent conv (C=12 padded to 16),
    tower conv 2 (32) and tower conv 4 (128); 4096 outputs. The kernel
    chains one slab (9 k8 steps) at a time."""
    g = torch.Generator().manual_seed(C)
    K = 9 * C
    a = torch.randn(4096, K, generator=g)
    b = torch.randn(K, generator=g) / K ** 0.5
    ref = a.double() @ b.double()
    err = (_emulate(a, b, chain=9).double() - ref).abs().max().item()
    assert err < 1e-5, err
    # the truncating tensor-core sum is why each slab's chain is added to
    # fp32 sums: one chain over all of K drifts further
    single = (_emulate(a, b, chain=C + 1).double() - ref).abs().max().item()
    assert single > err

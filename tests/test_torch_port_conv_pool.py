"""The conv-pool kernel's tile plan, addressing and arithmetic, on the CPU.

``csrc/fused_conv_pool.cu`` runs only on the card; what decides its
launches is the pure-Python plan of ``dlwp_torch.kernels.fused_conv_pool``.
The plan is held, at the flagship's two encoder stages, the golden 8x16
model's, the card tests' and ``chip_smoke.py``'s odd cases and over a
sweep of batch sizes, to: every (sample, pooled row, column, o-group) is
one tile's exactly once; the ring fits a block's 227 KB of shared memory;
at most 18 warps a block and a grid within CUDA's limits; two tiles per SM
at the flagship stages; a row wider than one block's columns split into
column blocks.

The kernel's shared-memory layout and fragment addressing are emulated in
numpy (float64 products): rows staged as ``stage_x`` stages them, weights
as ``stage_w``, each warp's operands gathered lane by lane with the
kernel's offsets, the pool taken in the accumulator layout; what the
kernel leaves unwritten in shared memory is NaN. The result must equal
the plain version, which holds the index arithmetic of the
kernel to the function it computes. Its 3xTF32 products are emulated as
in ``tests/test_torch_port_overlap.py``, under the max-then-tanh
epilogue.
"""

import itertools
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlwp_tpu.ops.fused_stages import fused_conv_pool as jax_conv_pool

from dlwp_torch.kernels import _build, fused_conv_pool_plain
from dlwp_torch.kernels._tiling import MAX_GRID, MAX_SMEM
from dlwp_torch.kernels.fused_conv_pool import (
    _candidates,
    _plan,
    _steps,
    _tile,
    _variants,
)
from test_torch_port_overlap import _emulate

from tests.torch_port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(2)

# (B, C, H, W, O, dilation). The flagship's encoder stages at B=64.
FLAGSHIP = [(64, 24, 36, 144, 32, 2), (64, 32, 18, 72, 64, 1)]
# The same stages on the 0.5-degree grid (180x720), which take 5 column
# blocks a row.
WIDE = [(64, 24, 180, 720, 32, 2), (64, 32, 90, 360, 64, 1)]
# Dilations that stage their taps' rows, or rows and columns, as three
# groups (chip_smoke.py's and the card tests' large-dilation cases).
LARGE_D = [(3, 5, 10, 18, 7, 9), (2, 3, 8, 16, 65, 15),
           (2, 24, 36, 144, 32, 17), (2, 24, 36, 144, 32, 143)]
# The golden 8x16 model's stages (B=2, as the card test runs it), the
# sharded card test's 16x32 model, chip_smoke.py's and the card tests' odd
# cases: d 1/2/3, C 3/5/11/24/32, O 7/37/64/65, W 8/10/16/18/72/144, H
# 4/8/10; then dilations past a tile's rows or columns, up to W - 1.
CASES = FLAGSHIP + WIDE + [
    (2, 24, 8, 16, 32, 2), (2, 32, 4, 8, 64, 1),
    (4, 24, 16, 32, 32, 2), (4, 32, 8, 16, 64, 1),
    (3, 5, 10, 18, 7, 3), (3, 11, 10, 18, 37, 1), (3, 11, 10, 18, 37, 2),
    (3, 11, 10, 18, 37, 3), (5, 3, 8, 16, 65, 2), (4, 32, 8, 72, 7, 1),
    (2, 24, 10, 144, 64, 3), (70, 11, 8, 18, 65, 2), (1, 24, 36, 144, 32, 2),
    (2, 5, 4, 10, 7, 3),
] + LARGE_D


def entry_accepts(plan, B, C, H, W, O, d):
    """The checks of the kernel's C entry point, dlwp_fused_conv_pool."""
    cw, nslab = 8 * plan.ncg, -(-C // 8)
    rstep, cstep = _steps(d, plan.rb, cw)
    x_floats = plan.bb * (2 * plan.rb + 2 * rstep) * 8 * plan.rs
    w_floats = plan.nm * 16 * 76
    return (plan.nm % plan.mo == 0 and plan.nm <= 4
            and plan.warps == plan.bb * plan.rb * plan.ncg * plan.nm // plan.mo
            and plan.warps <= 18 and plan.stages in (2, 3)
            and (plan.n_cb - 1) * cw < W <= plan.n_cb * cw
            and plan.lm >= cstep and plan.lm % 4 == 0
            and plan.rs >= plan.lm + cw + cstep and plan.rs % 4 == 0
            and plan.n_og * plan.nm * 16 >= O
            and plan.n_rg == -(-(H // 2) // plan.rb)
            and plan.tiles == -(-B // plan.bb) * plan.n_rg * plan.n_cb
            * plan.n_og
            and plan.tiles * nslab <= MAX_GRID
            and (not plan.resident or plan.n_og == 1)
            and plan.smem == 4 * (plan.stages * x_floats + (
                nslab if plan.resident else plan.stages) * w_floats))


def check_plan(B, C, H, W, O, d):
    plan = _plan(B, C, H, W, O, d)
    assert entry_accepts(plan, B, C, H, W, O, d)
    cw = 8 * plan.ncg  # columns of a block
    assert plan.smem <= MAX_SMEM
    assert 1 <= plan.tiles and plan.tiles * -(-C // 8) <= MAX_GRID
    assert 1 <= plan.warps <= 18 and plan.mo in (1, 2) and plan.nm <= 4
    assert plan.nm % plan.mo == 0
    assert plan.warps == plan.bb * plan.rb * plan.ncg * (plan.nm // plan.mo)
    # column blocks cover the row, none empty; staged rows: margin >= the
    # left tap's offset, every column tile's reads inside the row, 16-byte
    # aligned, fragment loads on 32 banks
    assert (plan.n_cb - 1) * cw < W <= plan.n_cb * cw
    cstep = _steps(d, plan.rb, cw)[1]
    assert plan.lm % 4 == 0 and plan.lm >= cstep
    assert plan.rs >= plan.lm + cw + cstep
    assert plan.rs % 4 == 0 and plan.rs % 32 in (8, 24)
    assert (plan.n_og - 1) * plan.nm * 16 < O <= plan.n_og * plan.nm * 16
    assert not plan.resident or plan.n_og == 1
    seen = set()
    for t in range(plan.tiles):
        b0, nb, hp0, nr, w0, og = _tile(plan, B, H, t)
        assert 1 <= nb <= plan.bb and 1 <= nr <= plan.rb and w0 % cw == 0
        for b, hp in itertools.product(range(b0, b0 + nb),
                                       range(hp0, hp0 + nr)):
            assert (b, hp, w0, og) not in seen
            seen.add((b, hp, w0, og))
    assert len(seen) == B * (H // 2) * plan.n_cb * plan.n_og
    return plan


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plan_covers_every_output_once(case):
    check_plan(*case)


@pytest.mark.parametrize("stage", FLAGSHIP, ids=["stage1", "stage2"])
def test_plan_batch_sweep(stage):
    for B in range(1, 71):
        check_plan(B, *stage[1:])


def test_plan_fills_the_card_at_the_flagship_stages():
    """Two tiles per SM or more, one o-group (the input staged once), the
    weights resident, one column block and no masked column: both stages
    take 2 o-fragments a warp, 18 warps a block, one block an SM and so a
    ring of 3 stages."""
    for case in FLAGSHIP:
        plan = check_plan(*case)
        assert plan.tiles >= 264 and plan.n_og == 1 and plan.resident
        assert plan.mo == 2 and plan.warps == 18 and plan.stages == 3
        assert plan.n_cb == 1 and 8 * plan.ncg == case[3]


@pytest.mark.parametrize("stage", WIDE, ids=["stage1", "stage2"])
def test_plan_splits_a_wide_row_into_column_blocks(stage):
    """At 720 and 360 columns the flagship's warps (18 a block) cover a
    fifth of a row: 5 column blocks, none masked, each staging its 2 d
    neighbour columns beside it."""
    plan = check_plan(*stage)
    assert plan.mo == 2 and plan.warps == 18 and plan.n_og == 1
    assert plan.n_cb == 5 and 8 * plan.ncg * plan.n_cb == stage[3]


def test_plan_masks_a_ragged_column_tile():
    """W = 18 is 2.25 column tiles: the last is masked at the store."""
    plan = check_plan(3, 11, 10, 18, 37, 2)
    assert 8 * plan.ncg * plan.n_cb > 18


@pytest.mark.parametrize("stage", FLAGSHIP, ids=["stage1", "stage2"])
def test_plan_variants_are_launches_of_the_same_work(stage):
    """The other plans the card checks launch (chip_smoke.py and the card
    tests hold their results bit-equal to the chosen plan's): both warp
    builds, split and whole rows, both ring depths, resident and streamed
    weights; each one the kernel's entry point accepts."""
    plan = _plan(*stage)
    variants = _variants(plan, *stage)
    assert plan not in variants
    assert {p.mo for p in variants} == {1, 2}
    assert {p.n_cb > 1 for p in variants} == {True, False}
    assert {p.stages for p in variants} == {2, 3}
    assert {p.resident for p in variants} == {True, False}
    for p in variants:
        assert entry_accepts(p, *stage) and p.smem <= MAX_SMEM, p


@pytest.mark.parametrize("bad", [dict(d=0), dict(d=16), dict(H=9),
                                 dict(W=15),
                                 dict(B=2 ** 16, H=2 ** 12, W=2 ** 16, d=1)],
                         ids=["d0", "d=W", "odd H", "odd W", "too wide"])
def test_plan_rejects_what_the_kernel_cannot_take(bad):
    """Dilation 1..W - 1, even H and W, at most 2^31 - 1 (tile, slab)
    units: any width and dilation fit shared memory, in column blocks
    and tap groups."""
    args = dict(B=2, C=5, H=8, W=16, O=32, d=2) | bad
    with pytest.raises(ValueError, match="fused_conv_pool"):
        _plan(**args)


def emulate_kernel(x, k, bias, d, plan):
    """The kernel's staging, operand gathers and epilogue in numpy, with
    exact (float64) products: each lane's offsets as the kernel computes
    them, each mma as the 16x8 product of its gathered fragments. Staged
    rows start as NaN: a stored output that read a value the kernel did
    not stage for its tile comes out NaN."""
    B, C, H, W = x.shape
    O = k.shape[0]
    H2, W2, CS, WR = H // 2, W // 2, 8, 76
    nos, cw = plan.nm // plan.mo, 8 * plan.ncg
    rstep, cstep = _steps(d, plan.rb, cw)
    nrows, nslab = 2 * plan.rb + 2 * rstep, -(-C // CS)
    kf = k.reshape(O, C * 9)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    y = np.full((B, O, H2, W2), np.nan)
    for tile in range(plan.tiles):
        b0, nb, hp0, nr, w0, og = _tile(plan, B, H, tile)
        n = min(cw, W - w0)
        acc = {}
        for slab in range(nslab):
            c0 = slab * CS
            xs = np.full(plan.bb * nrows * CS * plan.rs, np.nan)
            for bl, r, cc in itertools.product(range(plan.bb), range(nrows),
                                               range(CS)):
                dst = ((bl * nrows + r) * CS + cc) * plan.rs + plan.lm
                gr, c = 2 * hp0 - d + r, c0 + cc
                if rstep < d:  # three groups of 2 rb rows
                    grp = r // (2 * plan.rb)
                    gr = 2 * hp0 + (grp - 1) * d + r - grp * 2 * plan.rb
                if bl < nb and c < C and 0 <= gr < H:
                    src = x[b0 + bl, c, gr]
                    xs[dst:dst + n] = src[w0:w0 + n]
                    if cstep < d:  # three groups of cw columns
                        i = np.arange(n)
                        xs[dst - cw:dst - cw + n] = src[(w0 - d + i) % W]
                        xs[dst + cw:dst + cw + n] = src[(w0 + d + i) % W]
                    else:
                        i = np.arange(d)
                        xs[dst - d:dst] = src[(w0 - d + i) % W]
                        xs[dst + n:dst + n + d] = src[(w0 + n + i) % W]
                else:
                    xs[dst - cstep:dst + cw + cstep] = 0
            ws = np.zeros(plan.nm * 16 * WR)
            for ol, j in itertools.product(range(plan.nm * 16), range(72)):
                o = og * plan.nm * 16 + ol
                if o < O and c0 + j // 9 < C:
                    ws[ol * WR + j] = kf[o, c0 * 9 + j]
            k4 = C - c0 <= 4
            for w in range(plan.warps):
                os_, cg = w % nos, (w // nos) % plan.ncg
                rl = (w // (nos * plan.ncg)) % plan.rb
                bl = w // (nos * plan.ncg * plan.rb)
                xbase = (((bl * nrows + 2 * rl) * CS + t) * plan.rs + plan.lm
                         - cstep + 8 * cg + g)
                wbase = (os_ * plan.mo * 16 + g) * WR + t * 9
                for dy, dx, i, rr in itertools.product(
                        range(3), range(3), range(plan.mo), range(2)):
                    tap = dy * 3 + dx
                    b = xbase + (rr + dy * rstep) * CS * plan.rs + dx * cstep
                    Bm = np.zeros((8, 8))
                    Bm[t, g] = xs[b]
                    a = wbase + i * 16 * WR + tap
                    Am = np.zeros((16, 8))
                    Am[g, t], Am[g + 8, t] = ws[a], ws[a + 8 * WR]
                    if not k4:
                        Bm[t + 4, g] = xs[b + 4 * plan.rs]
                        Am[g, t + 4] = ws[a + 36]
                        Am[g + 8, t + 4] = ws[a + 8 * WR + 36]
                    key = (w, i, rr)
                    acc[key] = acc.get(key, 0) + Am @ Bm
        for w in range(plan.warps):
            os_, cg = w % nos, (w // nos) % plan.ncg
            rl = (w // (nos * plan.ncg)) % plan.rb
            bl = w // (nos * plan.ncg * plan.rb)
            if bl >= nb or rl >= nr:
                continue
            for i in range(plan.mo):
                win = np.maximum(acc[w, i, 0], acc[w, i, 1])
                pooled = np.maximum(win[:, 0::2], win[:, 1::2])  # (16, 4)
                for m, tt in itertools.product(range(16), range(4)):
                    o = og * plan.nm * 16 + (os_ * plan.mo + i) * 16 + m
                    wp = w0 // 2 + 4 * cg + tt
                    if o < O and wp < W2:
                        y[b0 + bl, o, hp0 + rl, wp] = np.tanh(
                            pooled[m, tt] + bias[o])
    return y


def _operands(seed, B, C, H, W, O):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, C, H, W), rng.randn(O, C, 3, 3) / np.sqrt(9 * C),
            0.1 * rng.randn(O))


def _distinct_plans(B, C, H, W, O, d):
    """The chosen plan and one candidate of each other warp build, column
    split, weight layout and tile shape (the ring's depth moves no
    address the emulation computes)."""
    seen = {}
    for p, _ in _candidates(B, C, H, W, O, d):
        seen.setdefault((p.mo, p.n_cb > 1, p.resident, p.bb > 1, p.rb > 1),
                        p)
    return [_plan(B, C, H, W, O, d)] + list(seen.values())


EMULATED = [(2, 11, 8, 18, 37, 2), (3, 3, 6, 16, 65, 3), (2, 5, 4, 8, 7, 1),
            (2, 24, 8, 16, 32, 2), (2, 5, 4, 10, 7, 3), (2, 5, 10, 18, 7, 9),
            (2, 3, 8, 16, 7, 15)]


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "-".join(map(str, c)))
def test_kernel_addressing_matches_plain(case):
    B, C, H, W, O, d = case
    x, k, b = _operands(sum(case), B, C, H, W, O)
    want = fused_conv_pool_plain(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(b), d).numpy()
    plans = _distinct_plans(*case)
    assert len(set(plans)) >= 2
    for plan in plans:
        assert entry_accepts(plan, *case), plan
        got = emulate_kernel(x, k, b, d, plan)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=str(plan))


def test_emulated_plans_cover_every_build():
    """Both warp builds, a split and a whole row, a ragged last block,
    resident and streamed weights, tiles of several samples and rows, rows
    and columns of the taps in order and in groups: each runs in the
    emulation above."""
    plans = [p for case in EMULATED for p in _distinct_plans(*case)]
    ragged = [p for case in EMULATED for p in _distinct_plans(*case)
              if 8 * p.ncg * p.n_cb > case[3]]
    assert {p.mo for p in plans} == {1, 2}
    assert {p.n_cb > 1 for p in plans} == {True, False} and ragged
    assert {p.resident for p in plans} == {True, False}
    assert any(p.bb > 1 for p in plans) and any(p.rb > 1 for p in plans)
    steps = {(s < case[5], t < case[5]) for case in EMULATED
             for p in _distinct_plans(*case)
             for s, t in [_steps(case[5], p.rb, 8 * p.ncg)]}
    assert steps == {(False, False), (True, False), (True, True)}


@pytest.mark.parametrize("C", [24, 32])
def test_3xtf32_max_then_tanh_meets_fp32_tolerance(C):
    """K = 9 C, the two flagship stages' depth; 4096 pooled outputs, each
    the max of 4 emulated conv sums (one 9-step chain per slab) plus bias,
    then tanh, against float64."""
    g = torch.Generator().manual_seed(C)
    K = 9 * C
    a = torch.randn(4 * 4096, K, generator=g)
    w = torch.randn(K, generator=g) / K ** 0.5
    bias = 0.1 * torch.randn(1, generator=g)
    ref = torch.tanh((a.double() @ w.double()).view(4096, 4).amax(1)
                     + bias.double())
    emu = torch.tanh(_emulate(a, w, chain=9).view(4096, 4).amax(1) + bias)
    err = (emu.double() - ref).abs().max().item()
    assert err < 1e-5, err


@pytest.mark.parametrize("stage", FLAGSHIP, ids=["stage1", "stage2"])
def test_plain_matches_pallas_at_flagship_stage_shapes(stage):
    """B=2 of each flagship stage; the Pallas kernel in interpret mode."""
    _, C, H, W, O, d = stage
    rng = np.random.RandomState(d)
    x = rng.randn(2, C, H, W).astype(np.float32)
    k = (rng.randn(O, C, 3, 3) / np.sqrt(9 * C)).astype(np.float32)
    b = (0.1 * rng.randn(O)).astype(np.float32)
    want = jax_conv_pool(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                         dilation=d, interpret=True)
    got = fused_conv_pool_plain(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(b), d)
    assert got.shape == (2, O, H // 2, W // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited or added csrc/*.cuh renames every library, so no stale
    build is reused; an edit of another .cu renames only its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = _build.sources()
    assert {"fused_conv_pool", "overlap_conv"} <= set(names)
    before = {n: _build.library_path(n) for n in names}
    header = csrc / "tf32_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: _build.library_path(n) for n in names}
    assert all(edited[n] != before[n] for n in names)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = {n: _build.library_path(n) for n in names}
    assert all(added[n] != edited[n] for n in names)
    src = csrc / "lstm_gates.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path("lstm_gates") != added["lstm_gates"]
    assert _build.library_path("fused_conv_pool") == added["fused_conv_pool"]

"""Fused conv3x3 + bias + tanh + 2x2 max-pool (kernel ``csrc/fused_conv_pool.cu``).

Port of ``dlwp_tpu.ops.fused_stages.fused_conv_pool``, the encoder stages
of the flagship tower. :func:`fused_conv_pool` launches the CUDA kernel for
a CUDA tensor, with the tiling of :func:`_plan`, and takes the plain
PyTorch version, :func:`fused_conv_pool_plain`, for a CPU tensor, through
the torch custom op ``dlwp_torch::fused_conv_pool`` (a fake implementation
gives its shape, so ``torch.export`` traces it into a program, which then
launches the kernel on the card). ``fused_conv_pool.launches`` counts kernel
launches, in the op's CUDA implementation;
``fused_conv_pool.last_launch`` holds the plan and grid of the last one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from dlwp_torch.kernels import _build
from dlwp_torch.kernels._tiling import (
    MAX_GRID,
    MAX_SMEM,
    N_SM,
    TWO_PER_SM,
    ring,
    sm_count,
)
from dlwp_torch.ops.conv import cyclic_conv2d
from dlwp_torch.ops.pooling import max_pool2d
from dlwp_torch.utils.profiling import span


def fused_conv_pool_plain(x, kernel, bias=None, dilation: int = 2):
    """``max_pool2d(tanh(cyclic_conv2d(x, kernel, d) + bias))``, with the max
    taken over the raw conv sums first (exact: tanh is monotone)."""
    y = cyclic_conv2d(x, kernel, dilation=(dilation, dilation))
    y = max_pool2d(y, (2, 2))
    if bias is not None:
        y = y + bias[:, None, None]
    return torch.tanh(y)


# Tile constants of csrc/fused_conv_pool.cu.
_CS, _WR, _MAX_WARPS = 8, 76, 18
_OG = (64, 32)  # output channels an o-group may have
_MO = (2, 1)  # m16 o-fragments a warp may own: the kernel's builds
# The kernel's registers (at most 96 a thread: 18 warps over the SM's four
# register partitions) let two blocks share an SM only at 10 warps or fewer.
_TWO_BLOCK_WARPS = 10


class Plan(NamedTuple):
    """One launch's tiling (see csrc/fused_conv_pool.cu): tiles of ``bb``
    samples x ``rb`` pooled rows x a column block of ``8 ncg`` columns
    (``n_cb`` blocks a row) x an o-group of ``nm`` m16 fragments of output
    channels (``n_og`` groups); ``warps`` warps, each of ``mo``
    o-fragments x one n8 column tile x the 2 rows of a pool window; staged
    rows of ``rs`` floats with a left margin of ``lm``; a ring of
    ``stages`` buffers of input rows, and of weights unless the weights of
    every slab are ``resident``, ``smem`` bytes in all; ``tiles`` tiles,
    o-group fastest, then column block, then row group."""
    bb: int
    rb: int
    warps: int
    stages: int
    rs: int
    lm: int
    nm: int
    mo: int
    n_og: int
    ncg: int
    n_cb: int
    smem: int
    tiles: int
    n_rg: int
    resident: bool


def _steps(d, rb, cw):
    """Rows and columns between a tile's taps in shared memory
    (csrc/fused_conv_pool.cu, header 3.): ``d`` where the rows or columns
    stand in order, else ``2 rb`` rows or ``cw`` columns, a group each
    tap, so that a large dilation stages no more than three taps' worth."""
    return min(d, 2 * rb), min(d, cw)


def _x_floats(bb, rb, rs, rstep):
    """Floats of one ring buffer of input rows: ``bb`` samples of
    ``2 rb + 2 rstep`` rows of ``_CS`` channels of ``rs`` floats."""
    return bb * (2 * rb + 2 * rstep) * _CS * rs


def _row_stride(lm, width, cstep):
    """Floats per staged row: margin, ``width`` columns and the right
    tap's columns, a multiple of 4 that is 8 or 24 mod 32, so the B
    fragment loads (4 channels x 8 columns a warp) hit 32 banks."""
    rs = -(-(lm + width + cstep) // 4) * 4
    while rs % 32 not in (8, 24):
        rs += 4
    return rs


def _candidates(B, C, H, W, O, d):
    """Every tiling of at most ``_MAX_WARPS`` warps whose ring fits shared
    memory, with its share of masked outputs (samples, rows, columns and
    output channels computed and not stored). A column block is the
    narrowest of its count: ``ncg`` column tiles cover the row in
    ``n_cb`` blocks, and no fewer tiles do."""
    H2, ntile, nslab = H // 2, -(-W // 8), -(-C // _CS)
    for nm in sorted({-(-min(O, og) // 16) for og in _OG}):
        n_og = -(-O // (16 * nm))
        for mo in _MO:
            if nm % mo:
                continue
            nos = nm // mo
            for ncg in range(1, min(ntile, _MAX_WARPS // nos) + 1):
                n_cb = -(-ntile // ncg)
                if -(-ntile // n_cb) != ncg:
                    continue
                for rb in range(1, min(H2, _MAX_WARPS // (ncg * nos)) + 1):
                    rstep, cstep = _steps(d, rb, 8 * ncg)
                    lm = -(-cstep // 4) * 4
                    rs = _row_stride(lm, 8 * ncg, cstep)
                    n_rg = -(-H2 // rb)
                    for bb in range(1, B + 1):
                        warps = bb * rb * ncg * nos
                        if warps > _MAX_WARPS:
                            break
                        layout = ring(
                            4 * _x_floats(bb, rb, rs, rstep),
                            4 * nm * 16 * _WR, nslab, n_og == 1,
                            MAX_SMEM if warps > _TWO_BLOCK_WARPS
                            else TWO_PER_SM)
                        if layout is None:
                            break
                        groups = -(-B // bb)
                        done = (groups * bb * n_rg * rb * n_cb * ncg * 8
                                * n_og * nm * 16)
                        yield (Plan(bb, rb, warps, layout[0], rs, lm, nm, mo,
                                    n_og, ncg, n_cb, layout[1],
                                    groups * n_rg * n_cb * n_og, n_rg,
                                    layout[2]),
                               1 - B * H2 * W * O / done)


@functools.cache  # a launch's plan depends on its shapes alone
def _plan(B, C, H, W, O, d, n_sm=N_SM) -> Plan:
    """The tiling of one launch. Among the candidates: enough tiles for two
    per SM and enough warps for 16 per SM where the work has them (else as
    many as it has), masked outputs at most 1/8 where possible; then the
    fewest o-groups and column blocks (fewest input loads), the most
    o-fragments a warp (fewest fragment loads an mma), the fewest masked
    outputs."""
    if H < 2 or W < 2 or H % 2 or W % 2:
        raise ValueError(f"fused_conv_pool: H and W must be even, got "
                         f"{H}x{W}")
    if not 1 <= d < W:
        raise ValueError(f"fused_conv_pool: dilation {d} outside 1.."
                         f"{W - 1} (below W={W})")
    cands = list(_candidates(B, C, H, W, O, d))
    want_tiles = min(2 * n_sm, max(p.tiles for p, _ in cands))
    ok = [(p, w) for p, w in cands if p.tiles >= want_tiles]
    want_warps = min(16 * n_sm, max(p.tiles * p.warps for p, _ in ok))
    ok = [(p, w) for p, w in ok if p.tiles * p.warps >= want_warps]
    ok = [(p, w) for p, w in ok if w <= 0.125] or ok
    plan = max(ok, key=lambda pw: (-pw[0].n_og, -pw[0].n_cb, pw[0].mo,
                                   -pw[1]))[0]
    if plan.tiles * -(-C // _CS) > MAX_GRID:
        raise ValueError(f"fused_conv_pool: ({B}, {C}, {H}, {W}) -> {O} "
                         f"needs {plan.tiles} tiles of {-(-C // _CS)} slabs, "
                         f"more than {MAX_GRID}")
    return plan


def _tile(plan: Plan, B, H, t):
    """Tile ``t`` of a plan, as the kernel decodes it: (first sample,
    samples, first pooled row, pooled rows, first column, o-group)."""
    q, og = divmod(t, plan.n_og)
    q, cb = divmod(q, plan.n_cb)
    hp0 = (q % plan.n_rg) * plan.rb
    b0 = (q // plan.n_rg) * plan.bb
    return (b0, min(plan.bb, B - b0), hp0, min(plan.rb, H // 2 - hp0),
            8 * plan.ncg * cb, og)


def _variants(plan: Plan, B, C, H, W, O, d):
    """Other launches of the same work, for the card's checks that a
    result does not depend on the plan: ``plan`` with the other ring depth,
    then one candidate for each warp build, column split, tile shape,
    weight layout and o-grouping."""
    x_bytes = 4 * _x_floats(plan.bb, plan.rb, plan.rs,
                            _steps(d, plan.rb, 8 * plan.ncg)[0])
    step = x_bytes + (0 if plan.resident else 4 * plan.nm * 16 * _WR)
    stages = 5 - plan.stages  # 3 <-> 2
    out = {plan._replace(stages=stages,
                         smem=plan.smem + (stages - plan.stages) * step): 0}
    seen = set()
    for p, _ in _candidates(B, C, H, W, O, d):
        key = (p.mo, p.n_cb > 1, p.bb * p.rb > 1, p.resident, p.n_og)
        if key not in seen and p != plan:
            seen.add(key)
            out[p] = 0
    return list(out)


@functools.cache
def _lib():
    lib = _build.load("fused_conv_pool")
    lib.dlwp_fused_conv_pool.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    lib.dlwp_fused_conv_pool.restype = ctypes.c_int
    return lib


def _check_shapes(x, kernel, bias):
    """Raise on shapes the kernel and its plain version do not take."""
    B, C, H, W = x.shape
    O = kernel.shape[0]
    if kernel.shape != (O, C, 3, 3) or H % 2 or W % 2:
        raise ValueError(
            f"fused_conv_pool needs a (O, {C}, 3, 3) kernel and even H, W; "
            f"got kernel {tuple(kernel.shape)}, x {tuple(x.shape)}"
        )
    if bias is not None and bias.shape != (O,):
        raise ValueError(f"fused_conv_pool: bias shape {tuple(bias.shape)}")


_FORWARD_ONLY = (
    "fused_conv_pool's kernel is forward only; a backward kernel is queued "
    "as speed work (ROADMAP.md section 2b), and FusedConvPool2D trains "
    "through its composition: run under torch.no_grad() or with operands "
    "that need no gradient")


@torch.library.custom_op("dlwp_torch::fused_conv_pool", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
        dilation: int) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    _check_shapes(x, kernel, bias)
    return fused_conv_pool_plain(x, kernel, bias, dilation)


@_op.register_kernel("cuda")
def _op_cuda(x, kernel, bias, dilation):
    """The op on the card: checks every operand, then launches the kernel
    (``fused_conv_pool.launches`` counts it). Exported programs call the op
    directly, so every check is here; nothing falls back to the plain
    version. An operand that requires grad is refused: the kernel has no
    backward, and :func:`fused_conv_pool` hands the op detached operands
    when no gradient is recorded."""
    _check_shapes(x, kernel, bias)
    if any(t is not None and t.requires_grad for t in (x, kernel, bias)):
        raise NotImplementedError(_FORWARD_ONLY)
    if bias is None:
        bias = x.new_zeros(kernel.shape[0])
    for name, t in (("x", x), ("kernel", kernel), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(
                f"fused_conv_pool: {name} must be float32 on {x.device}, got "
                f"{t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_conv_pool: {name} must be contiguous")
    B, C, H, W = x.shape
    return _launch(x, kernel, bias, dilation,
                   _plan(B, C, H, W, kernel.shape[0], dilation,
                         sm_count(x.device)))


@_op.register_fake
def _op_fake(x, kernel, bias, dilation):
    """Output shape only: the tile plan needs the concrete batch and is
    made in the CUDA implementation."""
    B, C, H, W = x.shape
    return x.new_empty((B, kernel.shape[0], H // 2, W // 2))


@span("kernel.fused_conv_pool")
def fused_conv_pool(x, kernel, bias=None, dilation: int = 2):
    """x (B, C, H, W) with H, W even; kernel (O, C, 3, 3); bias (O,) or None.
    Returns (B, O, H/2, W/2) through the op ``dlwp_torch::fused_conv_pool``
    (the kernel on the card, the plain version on the CPU); forward only."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_conv_pool: unsupported device {x.device}")
    operands = (x, kernel, bias)
    if any(t is not None and t.requires_grad for t in operands):
        if torch.is_grad_enabled():
            raise NotImplementedError(_FORWARD_ONLY)
        x, kernel, bias = (t if t is None else t.detach() for t in operands)
    return _op(x, kernel, bias, int(dilation))


def _launch(x, kernel, bias, d, plan: Plan):
    """One launch of the kernel with ``plan`` on checked tensors. The card
    tests also pass other candidates of ``_candidates``: a sample's result
    does not depend on the plan."""
    B, C, H, W = x.shape
    O = kernel.shape[0]
    vec_x = W % 4 == 0 and x.data_ptr() % 16 == 0
    vec_w = C % 4 == 0 and kernel.data_ptr() % 16 == 0
    fields = (plan.bb, plan.rb, plan.warps, plan.stages, plan.rs, plan.lm,
              plan.nm, plan.mo, plan.n_og, plan.ncg, plan.n_cb, int(vec_x),
              int(vec_w), plan.smem, plan.tiles, int(plan.resident))
    y = torch.empty((B, O, H // 2, W // 2), device=x.device,
                    dtype=torch.float32)
    grid = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlwp_fused_conv_pool(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, C, H, W, O, d, (ctypes.c_int * len(fields))(*fields),
            stream, ctypes.byref(grid),
        )
    if err:
        raise RuntimeError(f"fused_conv_pool launch failed: CUDA error {err}")
    fused_conv_pool.launches += 1
    fused_conv_pool.last_launch = (plan, grid.value)
    return y

fused_conv_pool.launches = 0
fused_conv_pool.last_launch = None

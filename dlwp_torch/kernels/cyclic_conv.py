"""Cyclic conv3x3 + bias + activation in one pass (kernel ``csrc/cyclic_conv.cu``).

The flagship tower's small-grid convs after the peephole fusions: a
``CyclicConv2D`` (3x3, stride 1, dilation 1, zero latitude boundary), an
``UpConv2D`` that keeps its output on the small grid (``emit_small``) and
the parity form of ``conv_after_upsample2`` (an odd square kernel of at
most 5 folded into four 3x3 parity kernels). :func:`cyclic_conv` computes
``act(conv + bias)`` for linear or tanh through the torch custom op
``dlwp_torch::cyclic_conv``: the kernel for CUDA tensors, with the tiling
of :func:`_plan`; the plain version, :func:`cyclic_conv_plain` (the
layers' composition), for CPU tensors; a fake implementation for shapes,
so that ``torch.export`` and CUDA graph captures hold it as one op. With
``upsample`` the op computes ``cyclic_conv2d(upsample2d(x, 2), kernel)``
and the kernel stores each parity channel straight into its place on the
large grid. ``cyclic_conv.launches`` counts kernel launches, in the op's
CUDA implementation; ``cyclic_conv.last_launch`` holds the plan and grid
of the last one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from dlwp_torch.kernels import _build
from dlwp_torch.kernels._tiling import MAX_SMEM, N_SM, TWO_PER_SM, sm_count
from dlwp_torch.ops.conv import _fold_matrix, conv_after_upsample2, cyclic_conv2d
from dlwp_torch.utils.profiling import span

# The activations of the kernel's epilogue, by the code it takes.
ACT_CODES = {"linear": 0, "tanh": 1}


def cyclic_conv_plain(x, kernel, bias=None, activation: str = "linear",
                      upsample: bool = False):
    """``act(cyclic_conv2d(x, kernel) + bias)`` with a zero latitude
    boundary, or with ``upsample`` ``act(conv_after_upsample2(x, kernel)
    + bias)``: the layers' composition (pad, conv, bias, activation and,
    for the parity form, the interleaving permute)."""
    y = conv_after_upsample2(x, kernel) if upsample else cyclic_conv2d(
        x, kernel)
    if bias is not None:
        y = y + bias[:, None, None]
    return torch.tanh(y) if activation == "tanh" else y


# Tile constants of csrc/cyclic_conv.cu: floats a staged position holds
# (8 channels) and a staged weight row.
_PP, _WR = 12, 76
_MAX_THREADS = 256
# The kernel's builds, (m16, n8) fragments a warp, with their rate of
# multiply-adds a warp relative to the 2 x 4 build (more fragments share
# each loaded one), and the resident warps an SM needs to reach it: fitted
# to every candidate's device time at the tower's four convs at B = 1, 8,
# 64 and 256 on an H100 (PERF.md).
_BUILDS = {(2, 4): 1.0, (2, 2): 0.6}
_FULL_WARPS = 16


class Plan(NamedTuple):
    """One launch's tiling (see csrc/cyclic_conv.cu): warps of ``mf`` m16
    x ``nf`` n8 fragments, ``wm`` x ``wn`` of them a block (a tile of 16
    mf wm pixels x 8 nf wn channels); ``nrows`` staged rows of ``rsp``
    positions (and a zero row) a buffer, a ring of ``stages`` buffers of
    input rows and weights, and the bias, ``smem`` bytes in all;
    ``tiles`` tiles, channel tile fastest (``n_nt`` of them)."""
    mf: int
    nf: int
    wm: int
    wn: int
    stages: int
    rsp: int
    nrows: int
    tiles: int
    n_nt: int
    smem: int

    @property
    def bm(self):
        return 16 * self.mf * self.wm

    @property
    def bn(self):
        return 8 * self.nf * self.wn

    @property
    def warps(self):
        return self.wm * self.wn

    @property
    def per_sm(self):
        """Blocks an SM holds by shared memory (registers allow two)."""
        return 2 if self.smem <= TWO_PER_SM else 1


def _layout(bm, bn, W):
    """(staged rows, row length in positions, bytes of one ring buffer):
    the rows a tile of ``bm`` pixels reads, one more on each side, and the
    zero row; rows of ``W + 8`` positions (columns -1 .. W, and a length
    of W mod 8); the slab's weights."""
    nrows = (bm + W - 2) // W + 3
    rsp = W + 8
    return nrows, rsp, 4 * ((nrows + 1) * rsp * _PP + bn * _WR)


def _candidates(B, C, H, W, N):
    """Every tiling of at most ``_MAX_THREADS`` threads whose ring fits:
    per build, warp columns and rows that each hold a channel and a pixel,
    the deepest ring (4 to 2 buffers) that lets two blocks share an SM, or
    else the deepest that fits one."""
    P = B * H * W
    most = _MAX_THREADS // 32
    for mf, nf in _BUILDS:
        for wn in range(1, most + 1):
            if (wn - 1) * 8 * nf >= N:
                break
            for wm in range(1, most // wn + 1):
                if (wm - 1) * 16 * mf >= P:
                    break
                bm, bn = 16 * mf * wm, 8 * nf * wn
                nrows, rsp, step = _layout(bm, bn, W)
                tiles = -(-P // bm) * -(-N // bn)
                fixed = 4 * -(-N // 4) * 4  # the bias, in whole quads
                fits = [s for s in (4, 3, 2)
                        if s * step + fixed <= TWO_PER_SM] or [
                    s for s in (4, 3, 2) if s * step + fixed <= MAX_SMEM]
                if fits:
                    yield Plan(mf, nf, wm, wn, fits[0], rsp, nrows, tiles,
                               -(-N // bn), fits[0] * step + fixed)


def _cost(plan: Plan, C, n_sm):
    """The busiest SM's multiply-adds (its tiles' channels padded to whole
    slabs) over its rate: the build's, scaled down where the SM holds
    fewer than ``_FULL_WARPS`` warps."""
    busiest = -(-plan.tiles // n_sm)
    warps = min(busiest, plan.per_sm) * plan.warps
    rate = _BUILDS[(plan.mf, plan.nf)] * min(1.0, warps / _FULL_WARPS)
    return busiest * plan.bm * plan.bn * 72 * -(-C // 8) / rate


def _staged(plan: Plan, W):
    """Copies a unit stages per output of a tile: 4-byte copies of the
    input rows (8 channels a position) and 16-byte copies of weights."""
    return (plan.nrows * (W + 2) * 8 + plan.bn * 18) / (plan.bm * plan.bn)


@functools.cache  # a launch's plan depends on its shapes alone
def _plan(B, C, H, W, N, n_sm=N_SM) -> Plan:
    """The tiling of one launch: the candidate of least :func:`_cost`, then
    the one of the most warps a block (a block stages its rows whatever
    its width), then the fewest copies an output (:func:`_staged`)."""
    if min(B, C, H, W, N) < 1 or max(B, N) * H * W >= 2 ** 31:
        raise ValueError(f"cyclic_conv: shapes ({B}, {C}, {H}, {W}) -> {N} "
                         "out of range")
    return min(_candidates(B, C, H, W, N),
               key=lambda p: (_cost(p, C, n_sm), -p.warps, _staged(p, W)))


@functools.cache
def _lib():
    lib = _build.load("cyclic_conv")
    lib.dlwp_cyclic_conv.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    lib.dlwp_cyclic_conv.restype = ctypes.c_int
    lib.dlwp_cyclic_conv_occupancy.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.dlwp_cyclic_conv_occupancy.restype = ctypes.c_int
    lib.dlwp_cyclic_conv_init.restype = ctypes.c_int
    lib.dlwp_cyclic_conv_fold.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.dlwp_cyclic_conv_fold.restype = ctypes.c_int
    err = lib.dlwp_cyclic_conv_init()
    if err:
        raise RuntimeError(f"cyclic_conv set-up failed: CUDA error {err}")
    return lib


@functools.cache
def _grid(plan: Plan, n_sm: int) -> int:
    """The persistent grid: SMs x the blocks an SM holds (the occupancy
    query), at most one block a tile."""
    per_sm = ctypes.c_int(0)
    err = _lib().dlwp_cyclic_conv_occupancy(
        plan.mf, plan.nf, 32 * plan.warps, plan.smem, ctypes.byref(per_sm))
    if err or per_sm.value < 1:
        raise RuntimeError(f"cyclic_conv: no block of {plan} fits an SM "
                           f"(CUDA error {err})")
    return min(plan.tiles, n_sm * per_sm.value)


def _check(x, kernel, bias, activation, upsample):
    """Raise on operands the kernel and its plain version do not take."""
    if x.dim() != 4 or kernel.dim() != 4:
        raise ValueError(f"cyclic_conv needs x (B, C, H, W) and a kernel (O, "
                         f"C, k, k); got {tuple(x.shape)}, "
                         f"{tuple(kernel.shape)}")
    O, C, kh, kw = kernel.shape
    sizes = (1, 3, 5) if upsample else (3,)
    if C != x.shape[1] or kh != kw or kh not in sizes:
        raise ValueError(f"cyclic_conv{' (upsample)' if upsample else ''}: "
                         f"kernel {tuple(kernel.shape)} for x "
                         f"{tuple(x.shape)}; square of size {sizes}")
    if bias is not None and bias.shape != (O,):
        raise ValueError(f"cyclic_conv: bias shape {tuple(bias.shape)}")
    if activation not in ACT_CODES:
        raise ValueError(f"cyclic_conv: activation {activation!r} not in "
                         f"{sorted(ACT_CODES)}")


def _fold_plain(kernel):
    """The four parity kernels of ``conv_after_upsample2`` for an odd
    square ``kernel`` of at most 5, (4 O, C, 3, 3), in the channel order
    of the kernel's parity store (row parity, o, column parity), so that
    a lane's channel pair is a pair of neighbouring large-grid columns:
    the plain version of the fold kernel."""
    O, C, k, _ = kernel.shape
    fold = _fold_matrix(k, kernel.dtype, kernel.device)
    return torch.einsum("pja,qkb,ocab->poqcjk", fold, fold,
                        kernel).reshape(4 * O, C, 3, 3).contiguous()


def _fold(kernel):
    """:func:`_fold_plain` on the card, by the library's fold kernel (one
    small launch a call; the einsum takes a few)."""
    O, C, k, _ = kernel.shape
    kw = torch.empty((4 * O, C, 3, 3), device=kernel.device,
                     dtype=torch.float32)
    with torch.cuda.device(kernel.device):
        err = _lib().dlwp_cyclic_conv_fold(
            kernel.data_ptr(), kw.data_ptr(), O, C, k,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cyclic_conv fold failed: CUDA error {err}")
    return kw


_FORWARD_ONLY = (
    "cyclic_conv's kernel is forward only; CyclicConv2D and UpConv2D train "
    "through their composition: run under torch.no_grad() or with operands "
    "that need no gradient")


@torch.library.custom_op("dlwp_torch::cyclic_conv", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
        activation: str, upsample: bool) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    _check(x, kernel, bias, activation, upsample)
    return cyclic_conv_plain(x, kernel, bias, activation, upsample)


@_op.register_kernel("cuda")
def _op_cuda(x, kernel, bias, activation, upsample):
    """The op on the card: checks every operand, then launches the kernel
    (``cyclic_conv.launches`` counts it). Exported programs call the op
    directly, so every check is here; nothing falls back to the plain
    version. An operand that requires grad is refused: the kernel has no
    backward."""
    _check(x, kernel, bias, activation, upsample)
    if any(t is not None and t.requires_grad for t in (x, kernel, bias)):
        raise NotImplementedError(_FORWARD_ONLY)
    if bias is None:
        bias = x.new_zeros(kernel.shape[0])
    for name, t in (("x", x), ("kernel", kernel), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(
                f"cyclic_conv: {name} must be float32 on {x.device}, got "
                f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"cyclic_conv: {name} must be contiguous")
    B, C, H, W = x.shape
    kw = _fold(kernel) if upsample else kernel
    plan = _plan(B, C, H, W, kw.shape[0], sm_count(x.device))
    return _launch(x, kw, bias, ACT_CODES[activation], upsample, plan)


@_op.register_fake
def _op_fake(x, kernel, bias, activation, upsample):
    """Output shape only: the tile plan needs the concrete batch and is
    made in the CUDA implementation."""
    B, _, H, W = x.shape
    f = 2 if upsample else 1
    return x.new_empty((B, kernel.shape[0], f * H, f * W))


@span("kernel.cyclic_conv")
def cyclic_conv(x, kernel, bias=None, activation: str = "linear",
                upsample: bool = False):
    """x (B, C, H, W); kernel (O, C, 3, 3), or with ``upsample`` (O, C, k,
    k) of odd k <= 5; bias (O,) or None; activation 'linear' or 'tanh'.
    Returns ``act(cyclic_conv2d(x, kernel) + bias)`` (B, O, H, W), or with
    ``upsample`` ``act(cyclic_conv2d(upsample2d(x, 2), kernel) + bias)``
    (B, O, 2H, 2W), through the op ``dlwp_torch::cyclic_conv`` (the kernel
    on the card, the plain version on the CPU); forward only."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cyclic_conv: unsupported device {x.device}")
    operands = (x, kernel, bias)
    if any(t is not None and t.requires_grad for t in operands):
        if torch.is_grad_enabled():
            raise NotImplementedError(_FORWARD_ONLY)
        x, kernel, bias = (t if t is None else t.detach() for t in operands)
    return _op(x, kernel, bias, activation, bool(upsample))


def _launch(x, kw, bias, act: int, parity: bool, plan: Plan):
    """One launch of the kernel with ``plan`` on checked tensors: ``kw``
    the kernel, or its parity kernels (:func:`_fold`) where ``parity``.
    The card tests also pass other
    candidates of ``_candidates``: a sample's result does not depend on
    the plan."""
    B, C, H, W = x.shape
    N = kw.shape[0]
    grid = _grid(plan, sm_count(x.device))
    vec_w = C % 4 == 0 and kw.data_ptr() % 16 == 0
    fields = (plan.mf, plan.nf, plan.wm, plan.wn, plan.stages, plan.rsp,
              plan.nrows, plan.tiles, plan.n_nt, plan.smem, grid, int(vec_w))
    f = 2 if parity else 1
    y = torch.empty((B, N // 4 if parity else N, f * H, f * W),
                    device=x.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlwp_cyclic_conv(
            x.data_ptr(), kw.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, C, H, W, N, act, int(parity),
            (ctypes.c_int * len(fields))(*fields), stream)
    if err:
        raise RuntimeError(f"cyclic_conv launch failed: CUDA error {err}")
    cyclic_conv.launches += 1
    cyclic_conv.last_launch = (plan, grid)
    return y


cyclic_conv.launches = 0
cyclic_conv.last_launch = None

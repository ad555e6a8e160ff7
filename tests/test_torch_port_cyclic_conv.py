"""The cyclic conv kernel's op, routing, plan and addressing, on the CPU.

``csrc/cyclic_conv.cu`` runs only on the card. Here:

- the op ``dlwp_torch::cyclic_conv``: its plain version equals the
  layers' composition (``cyclic_conv2d`` + bias + activation, and
  ``conv_after_upsample2``'s permute) in float64 at the tower's four
  small-grid convs, with and without the parity store; ``opcheck``; the
  fake implementation's shapes under ``torch.export`` of the tower (four
  op nodes a model step, a symbolic batch); the CUDA implementation's
  checks refuse what the kernel does not take, before any launch;
- the layers' routing (``uses_kernel``): a recorded gradient, float64,
  a ``spatial`` sharding and shapes the kernel does not take run the
  composition; what it admits goes through the op;
- the plan at the four convs for B = 1 .. 256: the C entry point's
  checks, shared memory, every (pixel, channel) one tile's;
- the kernel's staging, operand loads and epilogue emulated in numpy
  (float64 products): input rows staged as ``stage_x`` stages them (what
  no copy writes is NaN, but the zero row), weights as ``stage_w`` stages
  them (OIHW, or the parity fold of ``_fold_plain``), each lane's 16-byte A
  row and B elements as the kernel names them, the plain and the parity
  stores; the result equals the plain version;
- the 3xTF32 arithmetic chained a slab at a time, against the fp32
  tolerance the card tests hold the kernel to.
"""

import itertools

import numpy as np
import pytest
import torch
from torch.export import Dim

from dlwp_torch.flagship import tower_specs
from dlwp_torch.kernels import (
    cyclic_conv,
    cyclic_conv_plain,
    launch_counts,
    reset_launch_counts,
)
from dlwp_torch.kernels._tiling import MAX_SMEM
from dlwp_torch.kernels.cyclic_conv import (
    ACT_CODES,
    _BUILDS,
    _candidates,
    _op_cuda,
    _plan,
    _fold_plain,
)
from dlwp_torch.models import layers as TL
from dlwp_torch.models.cnn import build_sequential
from dlwp_torch.ops.conv import conv_after_upsample2, cyclic_conv2d
from test_torch_port_overlap import _emulate

torch.set_num_threads(2)
OP = torch.ops.dlwp_torch.cyclic_conv.default

# The tower's four small-grid convs after the peephole fusions, (C, H, W,
# O, kernel size, upsample, activation): CyclicConv2D(128), UpConv2D(64)'s
# parity form, UpConv2D(32, emit_small), UpConv2D(4, 5)'s parity form.
TOWER = [(64, 9, 36, 128, 3, False, "tanh"),
         (128, 9, 36, 64, 3, True, "tanh"),
         (64, 18, 72, 32, 3, False, "tanh"),
         (32, 18, 72, 4, 5, True, "linear")]
TOWER_IDS = ["conv128", "up64", "emit_small32", "up4_5x5"]
BATCHES = (1, 32, 64, 128, 256)


def _operands(seed, B, C, H, W, O, k, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(B, C, H, W).astype(dtype)),
            torch.from_numpy((rng.randn(O, C, k, k) / np.sqrt(k * k * C))
                             .astype(dtype)),
            torch.from_numpy((0.1 * rng.randn(O)).astype(dtype)))


def _composition(x, k, b, act, upsample):
    y = conv_after_upsample2(x, k) if upsample else cyclic_conv2d(x, k)
    y = y + b[:, None, None]
    return torch.tanh(y) if act == "tanh" else y


# ------------------------------------------------------------- the op
@pytest.mark.parametrize("case", TOWER, ids=TOWER_IDS)
def test_plain_is_the_composition(case):
    C, H, W, O, k, up, act = case
    x, kern, b = _operands(0, 2, C, H, W, O, k)
    got = cyclic_conv(x, kern, b, act, up)
    torch.testing.assert_close(got, _composition(x, kern, b, act, up),
                               rtol=0, atol=0)
    f = 2 if up else 1
    assert got.shape == (2, O, f * H, f * W)
    assert torch.equal(cyclic_conv_plain(x, kern, None, act, up),
                       cyclic_conv_plain(x, kern, 0 * b, act, up))


@pytest.mark.parametrize("upsample,k,act", [(False, 3, "tanh"),
                                            (True, 3, "linear"),
                                            (True, 5, "tanh")])
def test_opcheck(upsample, k, act):
    x, kern, b = _operands(1, 2, 5, 4, 6, 3, k, np.float32)
    torch.library.opcheck(OP, (x, kern, b, act, upsample))
    torch.library.opcheck(OP, (x, kern, None, act, upsample))


class _Tower(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.model = build_sequential(tower_specs(4), device="cpu")

    def forward(self, x):
        return self.model(x)


def test_fake_implementation_under_export_of_the_tower():
    torch.manual_seed(0)
    tower = _Tower()
    x = torch.randn(3, 6, 12, 16)
    tower.model.init(x)
    b = Dim("b")
    with torch.no_grad():
        program = torch.export.export(tower, (x,), dynamic_shapes=({0: b},))
    ops = [n for n in program.graph.nodes
           if n.op == "call_function" and n.target is OP]
    assert len(ops) == 4
    assert [n.args[4] for n in ops] == [False, True, False, True]
    module = program.module()
    for B in (1, 2, 5):
        xb = torch.randn(B, 6, 12, 16)
        with torch.no_grad():
            want = tower(xb)
        got = module(xb)
        assert got.shape == (B, 4, 12, 16)
        assert torch.equal(got, want)


def _refused(case):
    x, k, b = _operands(2, 2, 5, 4, 6, 3, 3, np.float32)
    args = dict(x=x, kernel=k, bias=b, activation="tanh", upsample=False)
    if case == "float64":
        args.update(x=x.double(), kernel=k.double(), bias=b.double())
    elif case == "strided":
        args["x"] = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "bias_shape":
        args["bias"] = b[:-1].contiguous()
    elif case == "kernel_5x5":
        args["kernel"] = torch.zeros(3, 5, 5, 5)
    elif case == "kernel_4x4_up":
        args.update(kernel=torch.zeros(3, 5, 4, 4), upsample=True)
    elif case == "channels":
        args["kernel"] = torch.zeros(3, 4, 3, 3)
    elif case == "activation":
        args["activation"] = "relu"
    elif case == "five_d":
        args["x"] = x[None]
    else:  # requires_grad
        args["kernel"] = k.requires_grad_(True)
    return args


@pytest.mark.parametrize("case", ["float64", "strided", "bias_shape",
                                  "kernel_5x5", "kernel_4x4_up", "channels",
                                  "activation", "five_d", "requires_grad"])
def test_cuda_implementation_refuses(case):
    """The op's CUDA implementation, which an exported program calls
    without the wrapper, checks before it launches."""
    reset_launch_counts()
    err = NotImplementedError if case == "requires_grad" else ValueError
    with pytest.raises(err):
        _op_cuda(**_refused(case))
    assert launch_counts()["cyclic_conv"] == 0


def test_wrapper_refuses_grad_and_detaches_without():
    x, k, b = _operands(3, 2, 5, 4, 6, 3, 3, np.float32)
    k.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        cyclic_conv(x, k, b, "tanh")
    with torch.no_grad():
        y = cyclic_conv(x, k, b, "tanh")
    assert not y.requires_grad
    assert torch.equal(y, cyclic_conv_plain(x, k.detach(), b, "tanh"))


# -------------------------------------------------------------- routing
def _layer(kind, **kw):
    if kind == "cyclic":
        return TL.CyclicConv2D(kw.pop("features", 6), kw.pop("k", 3), **kw)
    return TL.UpConv2D(kw.pop("features", 6), kw.pop("k", 3), **kw)


ADMITTED = [("cyclic", {}), ("cyclic", {"impl": "edgefix"}),
            ("cyclic", {"activation": "tanh", "use_bias": False}),
            ("up", {}), ("up", {"k": 5, "activation": "tanh"}),
            ("up", {"k": 1}), ("up", {"dilation": 2, "emit_small": True})]
REFUSED = [("cyclic", {"k": 5}), ("cyclic", {"dilation": 2}),
           ("cyclic", {"strides": 2}), ("cyclic", {"lat_mode": "edge"}),
           ("cyclic", {"activation": "relu"}), ("up", {"dilation": 2}),
           ("up", {"k": 4}), ("up", {"activation": "sigmoid"})]


def _spy(monkeypatch):
    calls = []
    real = TL.cyclic_conv

    def spy(*args):
        calls.append(args[3:])
        return real(*args)

    monkeypatch.setattr(TL, "cyclic_conv", spy)
    return calls


def _forced_composition(layer, x, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(type(layer), "uses_kernel", lambda self, x: False)
        return layer(x)


@pytest.mark.parametrize("kind,kw", ADMITTED,
                         ids=lambda v: v if isinstance(v, str) else str(v))
def test_admitted_layers_take_the_op(kind, kw, monkeypatch):
    layer = _layer(kind, **kw)
    x = torch.randn(2, 5, 6, 8)
    with TL.initializing(torch.Generator().manual_seed(0)):
        layer(x)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        assert layer.uses_kernel(x)
        got = layer(x)
        want = _forced_composition(layer, x, monkeypatch)
    assert len(calls) == 1
    assert calls[0] == (layer.activation or "linear",
                        kind == "up" and not layer.emit_small)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,kw", REFUSED,
                         ids=lambda v: v if isinstance(v, str) else str(v))
def test_refused_layers_run_the_composition(kind, kw, monkeypatch):
    layer = _layer(kind, **kw)
    x = torch.randn(2, 5, 6, 8)
    with TL.initializing(torch.Generator().manual_seed(0)):
        layer(x)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        assert not layer.uses_kernel(x)
        layer(x)
    assert calls == []


@pytest.mark.parametrize("why", ["grad", "float64", "spatial", "five_d"])
def test_routing_falls_back_to_the_composition(why, monkeypatch):
    layer = _layer("cyclic", activation="tanh")
    x = torch.randn(2, 5, 6, 8)
    with TL.initializing(torch.Generator().manual_seed(0)):
        layer(x)
    if why == "grad":
        layer.kernel.requires_grad_(True)
    elif why == "float64":
        layer.double()
        x = x.double()
    elif why == "spatial":
        layer.spatial = object()  # any sharding sends the conv elsewhere
    else:
        x = x[None]
    assert not layer.uses_kernel(x)
    if why in ("grad", "float64"):
        calls = _spy(monkeypatch)
        y = layer(x)
        assert calls == []
        assert y.requires_grad == (why == "grad")


def test_tower_takes_the_op_four_times_a_step(monkeypatch):
    torch.manual_seed(0)
    model = build_sequential(tower_specs(4), device="cpu")
    x = torch.randn(2, 6, 12, 16)
    model.init(x)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        model(x)
    assert [c[1] for c in calls] == [False, True, False, True]
    assert [c[0] for c in calls] == ["tanh", "tanh", "tanh", "linear"]


# ----------------------------------------------------------------- plan
SHAPES = [(B, C, H, W, 4 * O if up else O)
          for B in BATCHES for C, H, W, O, _, up, _ in TOWER]


def entry_accepts(plan, B, C, H, W, N):
    """The checks of the kernel's C entry point, dlwp_cyclic_conv."""
    bm, bn = plan.bm, plan.bn
    xs = (plan.nrows + 1) * plan.rsp * 12
    ws = bn * 76
    P = B * H * W
    return (plan.warps * 32 <= 256 and plan.n_nt == -(-N // bn)
            and plan.tiles == -(-P // bm) * plan.n_nt
            and 2 <= plan.stages <= 4
            and plan.nrows >= (bm + W - 2) // W + 3
            and plan.rsp >= W + 2 and (plan.rsp - W) % 8 == 0
            and plan.smem <= MAX_SMEM
            and plan.smem == (plan.stages * (xs + ws) + -(-N // 4) * 4) * 4)


def _rows_read(plan, B, H, W, p0):
    """Staged row indices that the lanes of a tile read (header, 2.)."""
    P = B * H * W
    px = np.arange(p0, min(p0 + plan.bm, P))
    fr = px // W
    j = fr - p0 // W + 1
    r = fr % H
    return np.concatenate([np.where(r == 0, plan.nrows, j - 1), j,
                           np.where(r == H - 1, plan.nrows, j + 1)])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plan_is_a_launch_the_kernel_takes(shape):
    B, C, H, W, N = shape
    plan = _plan(*shape)
    assert entry_accepts(plan, *shape)
    assert (plan.mf, plan.nf) in _BUILDS
    # every staged row a lane reads exists, at every tile alignment
    for p0 in range(0, B * H * W, plan.bm):
        rows = _rows_read(plan, B, H, W, p0)
        assert rows.min() >= 0 and rows.max() <= plan.nrows
    # channel tiles hold a channel each; no all-masked warp column
    assert (plan.wn - 1) * 8 * plan.nf < N


def test_plan_fills_the_card_at_b64():
    """At B=64 each conv has at least two tiles an SM's worth."""
    for C, H, W, O, _, up, _ in TOWER:
        plan = _plan(64, C, H, W, 4 * O if up else O)
        assert plan.tiles >= 132


def test_candidates_all_pass_the_entry_checks():
    for shape in [(1, 64, 9, 36, 128), (3, 5, 4, 6, 12), (64, 32, 18, 72, 16)]:
        cands = list(_candidates(*shape))
        assert cands and all(entry_accepts(p, *shape) for p in cands)


def test_plan_rejects_out_of_range_shapes():
    with pytest.raises(ValueError):
        _plan(0, 4, 4, 4, 4)
    with pytest.raises(ValueError):
        _plan(2 ** 20, 4, 2 ** 6, 2 ** 6, 4)


# ----------------------------------------------------------- emulation
def emulate_kernel(x, kw, bias, act, parity, plan):
    """The kernel's staging, operand loads and epilogue in numpy with
    exact (float64) products: each lane's 16-byte A row (ldmatrix) and B
    elements as the kernel names them, each mma as the 16x8 product of
    the fragments they make. Staged buffers start NaN but for the zero
    row: a stored output that read what its unit did not stage comes out
    NaN."""
    B, C, H, W = x.shape
    N = kw.shape[0]
    PP, WR, CS = 12, 76, 8
    P, HW = B * H * W, H * W
    O = N // 4 if parity else N
    nslab = -(-C // CS)
    kf = kw.reshape(N, C * 9)
    f = 2 if parity else 1
    y = np.full((B, O, f * H, f * W), np.nan)
    lane = np.arange(32)
    g, tt = lane >> 2, lane & 3
    xs_floats = (plan.nrows + 1) * plan.rsp * PP
    zrow = plan.nrows * plan.rsp
    for t in range(plan.tiles):
        pt, nt = divmod(t, plan.n_nt)
        p0, n0 = pt * plan.bm, nt * plan.bn
        fr0 = p0 // W
        acc = np.zeros((plan.warps, plan.mf * 16, plan.nf * 8))
        for s in range(nslab):
            c0 = s * CS
            xs = np.full(xs_floats, np.nan)
            xs[zrow * PP:] = 0
            for j, c, pos in itertools.product(range(plan.nrows), range(CS),
                                               range(W + 2)):
                fr = fr0 - 1 + j
                dst = (j * plan.rsp + pos) * PP + c
                if 0 <= fr < B * H and c0 + c < C:
                    col = W - 1 if pos == 0 else (0 if pos > W else pos - 1)
                    xs[dst] = x[fr // H, c0 + c, fr % H, col]
                else:
                    xs[dst] = 0
            ws = np.full(plan.bn * WR, np.nan)
            for n, j in itertools.product(range(plan.bn), range(72)):
                ok = n0 + n < N and c0 + j // 9 < C
                ws[n * WR + j] = kf[n0 + n, c0 * 9 + j] if ok else 0
            for warp in range(plan.warps):
                wmi, wni = divmod(warp, plan.wn)
                pw, nw = wmi * plan.mf * 16, wni * plan.nf * 8
                q = []
                for i in range(plan.mf):
                    px = p0 + pw + 16 * i + (lane & 15)
                    fr, col = px // W, px % W
                    r, j = fr % H, fr - fr0 + 1
                    ok = px < P
                    q.append([np.where(ok, np.where(r == 0, plan.nrows, j - 1)
                                       * plan.rsp + col, zrow),
                              np.where(ok, j * plan.rsp + col, zrow),
                              np.where(ok, np.where(r == H - 1, plan.nrows,
                                                    j + 1) * plan.rsp + col,
                                       zrow)])
                wlane = (nw + g) * WR + tt * 9
                for dy, dx in itertools.product(range(3), range(3)):
                    tap = dy * 3 + dx
                    bmat = np.zeros((8, plan.nf * 8))  # (k, n)
                    for j in range(plan.nf):
                        bmat[tt, 8 * j + g] = ws[wlane + j * 8 * WR + tap]
                        bmat[tt + 4, 8 * j + g] = ws[wlane + j * 8 * WR + 36
                                                     + tap]
                    for i in range(plan.mf):
                        rows = xs[((q[i][dy] + dx) * PP
                                   + (lane >> 4) * 4)[:, None]
                                  + np.arange(4)]
                        amat = np.zeros((16, 8))  # (pixel, k)
                        amat[0:8, 0:4], amat[8:16, 0:4] = rows[0:8], rows[8:16]
                        amat[0:8, 4:8] = rows[16:24]
                        amat[8:16, 4:8] = rows[24:32]
                        acc[warp, 16 * i:16 * i + 16] += amat @ bmat
        for warp in range(plan.warps):
            wmi, wni = divmod(warp, plan.wn)
            pw, nw = wmi * plan.mf * 16, wni * plan.nf * 8
            for m, nn in itertools.product(range(plan.mf * 16),
                                           range(plan.nf * 8)):
                px, n = p0 + pw + m, n0 + nw + nn
                if px >= P or n >= N:
                    continue
                b, rem = divmod(px, HW)
                r, u = divmod(rem, W)
                v = acc[warp, m, nn]
                if parity:
                    pr = n // (2 * O)
                    o, pc = (n - pr * 2 * O) >> 1, n & 1
                    v = v + bias[o]
                    y[b, o, 2 * r + pr, 2 * u + pc] = np.tanh(v) if act else v
                else:
                    v = v + bias[n]
                    y[b, n, r, u] = np.tanh(v) if act else v
    return y


# (B, C, H, W, O, k, upsample, activation): the tower's four shapes cut
# to a few channels, and odd cases: C not a multiple of 8, W of 8, H = 1
# and 2, a batch that leaves a ragged last tile.
EMULATED = [(2, 16, 3, 12, 16, 3, False, "tanh"),
            (2, 8, 3, 12, 8, 3, True, "tanh"),
            (3, 5, 4, 10, 7, 3, False, "linear"),
            (2, 11, 2, 7, 3, 5, True, "linear"),
            (3, 3, 1, 9, 12, 3, False, "tanh"),
            (1, 9, 5, 6, 5, 1, True, "tanh")]


def _plans_of(B, C, H, W, N):
    seen = {}
    for p in _candidates(B, C, H, W, N):
        seen.setdefault((p.mf, p.nf, p.wm > 1, p.wn > 1, p.n_nt > 1), p)
    return [_plan(B, C, H, W, N)] + list(seen.values())[:6]


@pytest.mark.parametrize("case", EMULATED,
                         ids=lambda c: "-".join(map(str, c)))
def test_kernel_addressing_matches_plain(case):
    B, C, H, W, O, k, up, act = case
    x, kern, b = _operands(4, B, C, H, W, O, k)
    want = cyclic_conv_plain(x, kern, b, act, up).numpy()
    kw = (_fold_plain(kern) if up else kern).numpy()
    assert kw.shape == (4 * O if up else O, C, 3, 3)
    for plan in _plans_of(B, C, H, W, kw.shape[0]):
        got = emulate_kernel(x.numpy(), kw, b.numpy(), ACT_CODES[act], up,
                             plan)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=str(plan))


@pytest.mark.parametrize("C", [32, 64, 128])
def test_3xtf32_slab_chains_meet_fp32_tolerance(C):
    """K = 9 C, the tower convs' depths; each slab's 9 k8 steps chained,
    as the kernel chains them; the card tests hold the kernel to 1e-5 of
    outputs of unit scale."""
    g = torch.Generator().manual_seed(C)
    K = 9 * C
    a = torch.randn(2048, K, generator=g)
    b = torch.randn(K, generator=g) / K ** 0.5
    ref = a.double() @ b.double()
    err = (_emulate(a, b, chain=9).double() - ref).abs().max().item()
    assert err < 1e-5, err

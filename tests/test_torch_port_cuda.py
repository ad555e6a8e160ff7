"""The port's CUDA kernels on the card (skipped without one).

This file imports no JAX, so it also runs on a machine that has only
PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs
(fp32 1e-5: only the summation order differs; bf16 gates 5e-2, a few bf16
rounding steps near 1; the barotropic step 1e-5 relative in height after
20 steps, the JAX package's bar for its Pallas step; the halo exchange bit
for bit; the two overlap convs bit for bit with each other; a conv-pool
sample bit for bit whatever the batch; the cyclic conv at the tower's four
small-grid convs at B = 1, 32, 64 and 256 within 1e-5, a sample bit for
bit whatever the batch and the plan), the fused
flagship on the card against the same model on the
CPU, and the lat-band sharded flagship on two virtual shards of the card
against the unsharded one. The layers' routing on the card: a float64
model runs the compositions and matches the CPU (1e-10, float64 rounding);
a ConvLSTM2D with 'relu' runs the plain gate chain; the gradient of a
ConvLSTM2D through the ``lstm_gates`` kernel (plain VJP) matches the same
layer's through the plain gate chain within 1e-5 of its scale (the
kernel's and the plain forward differ by float32 rounding); and
``fused_conv_pool`` refuses operands that require grad. Training: one
full-width flagship train step against the CPU (loss 1e-5 relative,
gradient 2e-5 and parameters 2e-4 relative RMS, the limits of
``chip_smoke.py``'s training phase), a FusedConvPool2D's composition
under a gradient against its kernel under no_grad (1e-5), and the
kernels launched by ``fit_generator`` and the forecast after it. The
spectral side: ``fold=True`` against the unfolded engine, an S2Convolution
at the reference stack's width against the CPU, a two-truth archive
against the CPU's, and the sharded barotropic model on two virtual shards
against the unsharded one. The host data path: the native batch gather
(bit-equal to its numpy version) feeding a full-width train step. The
forecast's CUDA graphs: the graph path bit-equal to the eager loop (the
flagship at B=1 and 64, the tower at B=8, after weight swaps), with the
eager path's launch counts, one capture and a replay a step, an earlier
forecast left as it was, and one ``rollout.step`` and ``rollout.model``
span a replayed step.
"""

import numpy as np
import pytest
import torch

from dlwp_torch import (
    BarotropicModel,
    BarotropicModelPsi,
    DLWPNeuralNet,
    LatLonGrid,
    build_sequential,
)
from dlwp_torch.flagship import convlstm_specs
from dlwp_torch.kernels import (
    barotropic_step,
    barotropic_step_plain,
    fused_conv_pool,
    fused_conv_pool_plain,
    halo_exchange,
    halo_exchange_plain,
    launch_counts,
    lstm_gates,
    lstm_gates_plain,
    overlap_conv,
    overlap_conv_db,
    overlap_conv_plain,
    reset_launch_counts,
)
from dlwp_torch.models import layers as TL
from dlwp_torch.models.cnn import SequentialModel
from dlwp_torch.parallel import MeshConfig, SpatialSharding, build_mesh
from dlwp_torch.parallel.mesh import split_shards

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from dlwp_torch.device import resolve_device

    return resolve_device("cuda")


def _conv_pool_operands(seed, B, C, H, W, O):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, C, H, W).astype(np.float32),
            (rng.randn(O, C, 3, 3) / np.sqrt(9 * C)).astype(np.float32),
            (0.1 * rng.randn(O)).astype(np.float32))


def _gate_operands(seed, B=3, F=5, H=9, W=17):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 4 * F, H, W).astype(np.float32),
            rng.randn(B, 4 * F, H, W).astype(np.float32),
            rng.randn(B, F, H, W).astype(np.float32))


def test_kernels_match_plain_on_card(dev):
    reset_launch_counts()
    for dil in (1, 2, 3):
        x, k, b = (torch.from_numpy(a).to(dev) for a in _conv_pool_operands(
            dil, B=3, C=11, H=10, W=18, O=37))
        torch.testing.assert_close(fused_conv_pool(x, k, b, dil),
                                   fused_conv_pool_plain(x, k, b, dil),
                                   rtol=0, atol=1e-5)
    zx, zh, c = (torch.from_numpy(a).to(dev) for a in _gate_operands(7))
    for ra in ("hard_sigmoid", "sigmoid"):
        for gd in (None, "bfloat16"):
            tol = 1e-5 if gd is None else 5e-2
            for got, want in zip(lstm_gates(zx, zh, c, "tanh", ra, gd),
                                 lstm_gates_plain(zx, zh, c, "tanh", ra, gd)):
                torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert launch_counts() == {"fused_conv_pool": 3, "lstm_gates": 4,
                               "barotropic_step": 0, "halo_exchange": 0,
                               "overlap_conv": 0, "overlap_conv_db": 0,
                               "cube_pad": 0, "cyclic_conv": 0}


# (B, C, H, W, O, dilation): the flagship's encoder stages at B=64, then
# odd cases: d 1/2/3, C 3/5/11/24/32, O 7/37/64/65, W 10/16/18/72/144, H
# 4/8/10; then the two stages on the 0.5-degree grid (180x720), 5 column
# blocks a row; then dilations that stage their taps' rows, or rows and
# columns, in three groups (up to W - 1).
LARGE_D = [(3, 5, 10, 18, 7, 9), (2, 3, 8, 16, 65, 15),
           (2, 24, 36, 144, 32, 17), (2, 24, 36, 144, 32, 143)]
CONV_POOL_CASES = [(64, 24, 36, 144, 32, 2), (64, 32, 18, 72, 64, 1),
                   (3, 5, 10, 18, 7, 3), (3, 11, 10, 18, 37, 1),
                   (2, 3, 8, 16, 65, 2), (4, 32, 8, 72, 7, 1),
                   (2, 24, 10, 144, 64, 3), (5, 11, 8, 16, 37, 2),
                   (2, 5, 4, 10, 7, 3), (2, 24, 180, 720, 32, 2),
                   (2, 32, 90, 360, 64, 1)] + LARGE_D


@pytest.mark.parametrize("case", CONV_POOL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_conv_pool_matches_plain_on_card(dev, case):
    """The tensor-core conv-pool against its plain version (1e-5: 3xTF32
    products and the summation order), with the plan it launched."""
    from dlwp_torch.kernels.fused_conv_pool import _plan

    B, C, H, W, O, d = case
    x, k, b = (torch.from_numpy(a).to(dev) for a in _conv_pool_operands(
        sum(case), B, C, H, W, O))
    got = fused_conv_pool(x, k, b, d)
    torch.testing.assert_close(got, fused_conv_pool_plain(x, k, b, d),
                               rtol=0, atol=1e-5)
    plan, grid = fused_conv_pool.last_launch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan == _plan(B, C, H, W, O, d, sms)
    assert 1 <= grid <= plan.tiles


@pytest.mark.parametrize("stage", CONV_POOL_CASES[:2], ids=["stage1", "stage2"])
def test_conv_pool_sample_does_not_depend_on_batch(dev, stage):
    """Samples 0..2 of a B=64 call equal a B=3 call of the same samples bit
    for bit (another plan, another grid, the same sums)."""
    _, C, H, W, O, d = stage
    x, k, b = (torch.from_numpy(a).to(dev) for a in _conv_pool_operands(
        5, 64, C, H, W, O))
    full = fused_conv_pool(x, k, b, d)
    big = fused_conv_pool.last_launch
    small = fused_conv_pool(x[:3].contiguous(), k, b, d)
    assert fused_conv_pool.last_launch != big
    assert torch.equal(full[:3], small)


@pytest.mark.parametrize("stage", CONV_POOL_CASES[:2], ids=["stage1", "stage2"])
def test_conv_pool_does_not_depend_on_plan(dev, stage):
    """Other warp builds, column blocks, tile shapes and ring depths give
    the chosen plan's result bit for bit."""
    from dlwp_torch.kernels.fused_conv_pool import _launch, _variants

    B, C, H, W, O, d = stage
    x, k, b = (torch.from_numpy(a).to(dev) for a in _conv_pool_operands(
        7, B, C, H, W, O))
    want = fused_conv_pool(x, k, b, d)
    plan, _ = fused_conv_pool.last_launch
    others = _variants(plan, *stage)
    assert {p.mo for p in others} == {1, 2}
    assert any(p.n_cb > 1 for p in others)
    assert {p.stages for p in others} != {plan.stages}
    for other in others:
        assert torch.equal(_launch(x, k, b, d, other), want), other


@pytest.mark.parametrize("case", LARGE_D, ids=lambda c: "-".join(map(str, c)))
def test_conv_pool_large_dilation_does_not_depend_on_plan(dev, case):
    """At a dilation past a tile's rows or columns, plans that stage the
    taps in order and in groups give the chosen plan's result bit for
    bit."""
    from dlwp_torch.kernels.fused_conv_pool import _launch, _variants

    B, C, H, W, O, d = case
    x, k, b = (torch.from_numpy(a).to(dev) for a in _conv_pool_operands(
        9, B, C, H, W, O))
    want = fused_conv_pool(x, k, b, d)
    plan, _ = fused_conv_pool.last_launch
    for other in _variants(plan, *case):
        assert torch.equal(_launch(x, k, b, d, other), want), other


# cyclic_conv: the tower's four small-grid convs after the peephole
# fusions, (C, H, W, O, kernel size, upsample, activation).
CYCLIC_CONVS = [(64, 9, 36, 128, 3, False, "tanh"),
                (128, 9, 36, 64, 3, True, "tanh"),
                (64, 18, 72, 32, 3, False, "tanh"),
                (32, 18, 72, 4, 5, True, "linear")]
CYCLIC_IDS = ["conv128", "up64", "emit_small32", "up4_5x5"]


def _cyclic_operands(seed, B, C, H, W, O, k, dev):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)).to(dev),
            torch.from_numpy((rng.randn(O, C, k, k) / np.sqrt(k * k * C))
                             .astype(np.float32)).to(dev),
            torch.from_numpy((0.1 * rng.randn(O)).astype(np.float32)).to(dev))


@pytest.mark.parametrize("B", [1, 32, 64, 256])
@pytest.mark.parametrize("case", CYCLIC_CONVS, ids=CYCLIC_IDS)
def test_cyclic_conv_matches_plain_on_card(dev, case, B):
    """The tensor-core cyclic conv against its plain version (cuDNN, TF32
    off, and its passes) within 1e-5 (3xTF32 products and the summation
    order; outputs of unit scale), with the plan it launched."""
    from dlwp_torch.kernels import cyclic_conv, cyclic_conv_plain
    from dlwp_torch.kernels.cyclic_conv import _plan

    C, H, W, O, k, up, act = case
    x, kern, b = _cyclic_operands(B + C, B, C, H, W, O, k, dev)
    reset_launch_counts()
    got = cyclic_conv(x, kern, b, act, up)
    assert launch_counts()["cyclic_conv"] == 1
    torch.testing.assert_close(got, cyclic_conv_plain(x, kern, b, act, up),
                               rtol=0, atol=1e-5)
    plan, grid = cyclic_conv.last_launch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan == _plan(B, C, H, W, 4 * O if up else O, sms)
    assert 1 <= grid <= plan.tiles


@pytest.mark.parametrize("case", CYCLIC_CONVS, ids=CYCLIC_IDS)
def test_cyclic_conv_does_not_depend_on_batch_or_plan(dev, case):
    """Samples 0..2 of a B=64 call equal a B=3 call bit for bit, and every
    other build and warp layout gives the plan's result bit for bit (each
    output sums in one order)."""
    from dlwp_torch.kernels import cyclic_conv
    from dlwp_torch.kernels.cyclic_conv import (ACT_CODES, _candidates,
                                                _fold, _launch)

    C, H, W, O, k, up, act = case
    x, kern, b = _cyclic_operands(3, 64, C, H, W, O, k, dev)
    full = cyclic_conv(x, kern, b, act, up)
    plan, _ = cyclic_conv.last_launch
    assert torch.equal(cyclic_conv(x[:3].contiguous(), kern, b, act, up),
                       full[:3])
    kt = _fold(kern) if up else kern
    seen = {}
    for p in _candidates(64, C, H, W, kt.shape[0]):
        seen.setdefault((p.mf, p.nf, p.wm > 1, p.wn > 1, p.stages), p)
    assert len(seen) > 1
    for other in seen.values():
        assert torch.equal(_launch(x, kt, b, ACT_CODES[act], up, other),
                           full), other


@pytest.mark.parametrize("k", [1, 3, 5])
def test_cyclic_conv_fold_matches_einsum_on_card(dev, k):
    """The parity fold kernel against the wrapper's einsum: sums of at
    most 9 weights in another order (1e-6)."""
    from dlwp_torch.kernels.cyclic_conv import _fold, _fold_plain

    _, kern, _ = _cyclic_operands(6, 1, 24, 4, 8, 16, k, dev)
    torch.testing.assert_close(_fold(kern), _fold_plain(kern), rtol=0,
                               atol=1e-6)


def test_cyclic_conv_refuses_operands_that_require_grad(dev):
    from dlwp_torch.kernels import cyclic_conv, cyclic_conv_plain

    x, k, b = _cyclic_operands(4, 2, 8, 4, 12, 6, 3, dev)
    with pytest.raises(NotImplementedError, match="forward only"):
        cyclic_conv(x, k.requires_grad_(True), b, "tanh")
    with torch.no_grad():
        torch.testing.assert_close(cyclic_conv(x, k, b, "tanh"),
                                   cyclic_conv_plain(x, k, b, "tanh"),
                                   rtol=0, atol=1e-5)


def test_flagship_on_card_matches_cpu(dev):
    """Three autoregressive steps of the fused flagship at 8x16 through the
    kernels, against the CPU model (plain versions) with the same weights;
    fp32 on both sides, so 1e-4 covers the summation order."""
    specs = convlstm_specs(8, 16)
    x = torch.from_numpy(
        np.random.RandomState(0).randn(2, 2, 3, 8, 16).astype(np.float32))
    cpu = build_sequential(specs, device="cpu").init(x, seed=1)
    card = build_sequential(specs, device=dev)
    card.init(x, seed=1)
    reset_launch_counts()
    xs = {"cpu": x, "cuda": x.to(dev)}
    with torch.inference_mode():
        for _ in range(3):
            for name, model in (("cpu", cpu), ("cuda", card)):
                v = xs[name]
                xs[name] = torch.cat([model(v), v[:, :, 2:3]], dim=2)
    assert launch_counts() == {"fused_conv_pool": 6, "lstm_gates": 3,
                               "barotropic_step": 0, "halo_exchange": 0,
                               "overlap_conv": 0, "overlap_conv_db": 0,
                               "cube_pad": 0, "cyclic_conv": 12}
    torch.testing.assert_close(xs["cuda"].cpu(), xs["cpu"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("form", ["psi", "psi_no_sh", "vrt"])
def test_barotropic_kernel_matches_plain_on_card(dev, form):
    """20 steps at T24 on 37x72 through the kernel and through its plain
    version on the same tables and state; then 7 + 13 == 20 bit for bit,
    and run() is one launch."""
    grid = LatLonGrid.regular(37, 72)
    kw = dict(dt=1800.0, step_impl="kernel", device=dev)
    if form == "vrt":
        m = BarotropicModel(grid, 24, **kw)
    else:
        m = BarotropicModelPsi(grid, 24, correct_sh=form == "psi", **kw)
    z0 = 100.0 * np.random.RandomState(1).randn(37, 72)
    s0 = m.from_z(z0)
    parts = [x.contiguous() for x in (s0.vrt_spec.real, s0.vrt_spec.imag,
                                      s0.vrt_spec_prev.real,
                                      s0.vrt_spec_prev.imag)]
    args = (m._kernel_form, m._kernel_tables, *parts, 0, 20, m.dt,
            m.robert_coefficient)
    got = barotropic_step(*args)
    want = barotropic_step_plain(*args)
    torch.cuda.synchronize()
    as_state = type(s0)
    zk = m.z_grid(as_state(torch.complex(got[0], got[1]), s0.vrt_spec, 20, s0.t))
    zp = m.z_grid(as_state(torch.complex(want[0], want[1]), s0.vrt_spec, 20,
                           s0.t))
    rel = ((zk - zp).abs().max() / zp.abs().max()).item()
    assert rel <= 1e-5, rel

    reset_launch_counts()
    s20 = m.run(s0, 20)
    s2 = m.run(m.run(s0, 7), 13)
    torch.cuda.synchronize()
    assert launch_counts()["barotropic_step"] == 3
    assert torch.equal(s2.vrt_spec, s20.vrt_spec)
    assert torch.equal(s2.vrt_spec_prev, s20.vrt_spec_prev)
    assert torch.equal(s20.vrt_spec, torch.complex(got[0], got[1]))


def test_barotropic_kernel_refuses_unpacked_tables(dev):
    """A launch reads the tables packed once: a plain dict of the same
    tables is refused, not packed again."""
    m = BarotropicModel(LatLonGrid.regular(37, 72), 24, dt=1800.0,
                        step_impl="kernel", device=dev)
    s0 = m.from_z(100.0 * np.random.RandomState(2).randn(37, 72))
    parts = [x.contiguous() for x in (s0.vrt_spec.real, s0.vrt_spec.imag,
                                      s0.vrt_spec_prev.real,
                                      s0.vrt_spec_prev.imag)]
    with pytest.raises(ValueError, match="StepTables"):
        barotropic_step(m._kernel_form, dict(m._kernel_tables), *parts, 0, 1,
                        m.dt, m.robert_coefficient)


def _lat2(dev):
    return build_mesh(MeshConfig(data=1, lat=2), devices=[dev] * 2)


def _unaligned(shards):
    """Contiguous copies starting one float past a 16-byte boundary."""
    out = []
    for row in shards:
        out.append([])
        for s in row:
            buf = torch.empty(s.numel() + 4, device=s.device, dtype=s.dtype)
            out[-1].append(buf[1:1 + s.numel()].view(s.shape).copy_(s))
    return out


# (B, C, H, W, O, chunk): widths 18, 72, 144; channels 3, 12, 32, 128;
# outputs 7, 48, 64; chunks that pad the batch.
CONV_CASES = [(5, 3, 8, 18, 7, 2), (6, 12, 8, 72, 48, 4),
              (4, 128, 8, 144, 7, 3), (6, 32, 8, 18, 64, 5),
              (3, 12, 8, 144, 64, 2)]


def test_parallel_kernels_match_plain_on_card(dev):
    """The lat-band kernels on two virtual shards of the card: the halo
    exchange bit for bit (with a 0-sided halo); both conv kernels within
    1e-5 of the plain version, bit-equal to each other and to themselves
    on shards whose base is not 16-byte aligned (B=5 with chunk 2 pads the
    pipelined kernel's batch)."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(5, 3, 8, 18).astype(np.float32)).to(dev)
    shards = split_shards(x, _lat2(dev), "data", "lat")
    reset_launch_counts()
    for halo in ((2, 2), (0, 1)):
        for got, want in zip(halo_exchange(shards, halo)[0],
                             halo_exchange_plain(shards, halo)[0]):
            assert torch.equal(got, want)
    for B, C, H, W, O, chunk in CONV_CASES:
        x = torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)).to(dev)
        k = torch.from_numpy((rng.randn(O, C, 3, 3) / np.sqrt(9 * C)).astype(
            np.float32)).to(dev)
        shards = split_shards(x, _lat2(dev), "data", "lat")
        want = overlap_conv_plain(shards, k)[0]
        single = overlap_conv(shards, k)[0]
        for got in (single, overlap_conv_db(shards, k, chunk)[0],
                    overlap_conv(_unaligned(shards), k)[0],
                    overlap_conv_db(_unaligned(shards), k, chunk)[0]):
            for a, b, c in zip(got, want, single):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
                assert torch.equal(a, c)
    n = len(CONV_CASES)
    assert launch_counts() == {"fused_conv_pool": 0, "lstm_gates": 0,
                               "barotropic_step": 0, "halo_exchange": 2,
                               "overlap_conv": 2 * n, "overlap_conv_db": 2 * n,
                               "cube_pad": 0, "cyclic_conv": 0}


def test_sharded_flagship_on_card_matches_unsharded(dev):
    """Three autoregressive steps of the flagship at 16x32 on two virtual
    lat shards of the card (impl 'overlap': every level shards) against the
    unsharded fused model on the card, same weights; fp32 on both sides."""
    specs = convlstm_specs(16, 32)
    x = torch.from_numpy(
        np.random.RandomState(9).randn(4, 2, 3, 16, 32).astype(np.float32))
    plain = build_sequential(specs, device=dev)
    plain.init(x, seed=2)
    sharded = build_sequential(
        specs, spatial=SpatialSharding(_lat2(dev), impl="overlap"),
        device=dev)
    sharded.share_params_from(plain)
    reset_launch_counts()
    xs = {"plain": x.to(dev), "sharded": x.to(dev)}
    with torch.inference_mode():
        for _ in range(3):
            for name, model in (("plain", plain), ("sharded", sharded)):
                v = xs[name]
                xs[name] = torch.cat([model(v), v[:, :, 2:3]], dim=2)
    counts = launch_counts()
    assert counts["overlap_conv"] == 3 * 4 and counts["halo_exchange"] == 3 * 4
    assert counts["lstm_gates"] == 6 and counts["fused_conv_pool"] == 6
    assert counts["cyclic_conv"] == 3 * 4  # the unsharded model's alone
    torch.testing.assert_close(xs["sharded"], xs["plain"], rtol=0, atol=1e-4)


def _params_tree(model):
    return {"params": {
        f"layers_{i}": {k: p.detach().cpu().numpy()
                        for k, p in layer.named_parameters()}
        for i, layer in enumerate(model.layers)
        if any(True for _ in layer.parameters())
    }}


def test_float64_predict_on_card_matches_cpu(dev):
    """A float64 flagship (8x16) on the card runs the compositions (no
    kernel launch) and predicts what the CPU predicts."""
    x = np.random.RandomState(3).randn(2, 2, 3, 8, 16)
    nets = {}
    for name in ("cpu", dev):
        net = DLWPNeuralNet(is_recurrent=True, time_dim=2, scaler_type=None,
                            device=name)
        net.build_model(convlstm_specs(8, 16))
        nets[name] = net
    nets["cpu"].init(x, seed=4)
    tree = _params_tree(nets["cpu"].base_model)
    for net in nets.values():
        net.load_flax_params(tree, dtype=torch.float64)
    reset_launch_counts()
    got = nets[dev].predict(x)
    assert set(launch_counts().values()) == {0}
    np.testing.assert_allclose(got, nets["cpu"].predict(x), rtol=0,
                               atol=1e-10)


def test_convlstm_relu_on_card_matches_cpu(dev):
    x = np.random.RandomState(5).randn(2, 3, 3, 8, 16).astype(np.float32)
    models = {}
    for name in ("cpu", dev):
        models[name] = SequentialModel(
            [TL.ConvLSTM2D(4, 3, dilation=2, activation="relu")], device=name)
    models["cpu"].init(torch.from_numpy(x), seed=6)
    models[dev].init(torch.from_numpy(x), seed=6)
    reset_launch_counts()
    with torch.inference_mode():
        got = models[dev](torch.from_numpy(x).to(dev)).cpu()
        want = models["cpu"](torch.from_numpy(x))
    assert launch_counts()["lstm_gates"] == 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_convlstm_gradient_on_card_matches_plain_path(dev, monkeypatch):
    """Gradients of a ConvLSTM2D on the card through the gate kernel
    (forward) and the plain version's VJP (backward), against the same
    layer with the plain gate chain, for every parameter and the input."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 3, 8, 16).astype(np.float32)
    w = torch.from_numpy(rng.randn(2, 3, 4, 8, 16).astype(np.float32)).to(dev)
    grads = []
    for gates, launched in ((lstm_gates, 2), (lstm_gates_plain, 0)):
        monkeypatch.setattr(TL, "lstm_gates", gates)
        model = SequentialModel([TL.ConvLSTM2D(4, 3, dilation=2)], device=dev)
        model.init(torch.from_numpy(x), seed=8)
        layer = model.layers[0]
        params = [getattr(layer, n) for n in ("input_kernel",
                                              "recurrent_kernel", "bias")]
        for p in params:
            p.requires_grad_(True)
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        reset_launch_counts()
        (layer(xt) * w).sum().backward()
        assert launch_counts()["lstm_gates"] == launched
        grads.append([t.grad for t in params + [xt]])
    for got, want in zip(*grads):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def test_conv_pool_refuses_operands_that_require_grad(dev):
    x, k, b = (torch.from_numpy(a).to(dev) for a in _conv_pool_operands(
        2, B=2, C=5, H=8, W=16, O=7))
    with pytest.raises(NotImplementedError, match="forward only"):
        fused_conv_pool(x, k.requires_grad_(True), b, 1)
    with torch.no_grad():
        torch.testing.assert_close(fused_conv_pool(x, k, b, 1),
                                   fused_conv_pool_plain(x, k, b, 1),
                                   rtol=0, atol=1e-5)


def _rel_rms(got, want):
    num = sum(float(((got[k].double().cpu() - want[k].double().cpu()) ** 2)
                    .sum()) for k in want)
    return (num / sum(float((want[k].double().cpu() ** 2).sum())
                      for k in want)) ** 0.5


def test_flagship_train_step_on_card_matches_cpu(dev):
    """One train step of the full-width flagship (36x144, B=4, adam, a
    latitude-weighted MSE) on the card and on the CPU from the same
    weights and batch, with chip_smoke.py's limits: loss 1e-5 relative,
    gradient 2e-5 and parameters 2e-4 relative RMS. The step launches the
    gate kernel once and the conv-pool kernel not at all."""
    from dlwp_torch.ops.losses import latitude_weighted_loss, mse
    from dlwp_torch.train import TrainConfig, Trainer

    rng = np.random.RandomState(4)
    x = rng.randn(4, 2, 3, 36, 144).astype(np.float32)
    y = rng.randn(4, 2, 2, 36, 144).astype(np.float32)
    loss = latitude_weighted_loss(mse, np.linspace(87.5, 0.0, 36))
    runs = {}
    for name in ("cpu", dev):
        model = build_sequential(convlstm_specs(), device=name)
        model.init(torch.from_numpy(x), seed=3)
        tr = Trainer(model, TrainConfig(loss=loss))
        tr.init(x)
        reset_launch_counts()
        got = tr.train_step(x, y)["loss"].item()
        counts = launch_counts()
        runs[name] = (got, {n: p.grad for n, p in model.named_parameters()},
                      model.state_dict(), counts)
    (l_cpu, g_cpu, p_cpu, _), (l_card, g_card, p_card, counts) = (
        runs["cpu"], runs[dev])
    assert counts["lstm_gates"] == 1 and counts["fused_conv_pool"] == 0
    assert counts["cyclic_conv"] == 0  # a train step runs the composition
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    assert _rel_rms(g_card, g_cpu) <= 2e-5
    assert _rel_rms(p_card, p_cpu) <= 2e-4


def test_conv_pool_composition_under_grad_matches_kernel(dev):
    """A FusedConvPool2D at a flagship stage: with a gradient recorded it
    runs its composition (no launch), under no_grad the kernel (one
    launch); the two forwards agree within 1e-5."""
    x = torch.from_numpy(_conv_pool_operands(5, B=4, C=24, H=36, W=144,
                                             O=32)[0]).to(dev)
    layer = SequentialModel([TL.FusedConvPool2D(32, 3, dilation=2)],
                            device=dev).init(x, seed=2).layers[0]
    layer.kernel.requires_grad_(True)
    reset_launch_counts()
    composed = layer(x)
    assert composed.requires_grad and launch_counts()["fused_conv_pool"] == 0
    with torch.no_grad():
        fused = layer(x)
    assert launch_counts()["fused_conv_pool"] == 1
    torch.testing.assert_close(composed.detach(), fused, rtol=0, atol=1e-5)


def test_fit_then_predict_launches_both_kernels(dev, tmp_path):
    """fit_generator with validation on the card: the train steps launch
    the gate kernel, the validation both kernels; the forecast after fit
    (parameters that require grad) launches both."""
    from dlwp_torch import PredictorDataset, SeriesSampler, TimeSeriesEstimator

    n = 24
    data = PredictorDataset(
        predictors=np.random.RandomState(6).randn(n, 2, 8, 16)
        .astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, 8), lon=np.arange(16) * 22.5)
    net = DLWPNeuralNet(time_dim=2, is_recurrent=True, scaler_type=None,
                        device=dev)
    net.build_model(convlstm_specs(8, 16))
    kw = dict(input_time_steps=2, output_time_steps=2, add_insolation=True,
              batch_size=8)
    train = SeriesSampler(data, model=net, shuffle=True, **kw)
    val = SeriesSampler(data, model=net, **kw)
    net.init(train[0][0], seed=0)
    reset_launch_counts()
    net.fit_generator(train, validation_data=val, epochs=1, verbose=False,
                      checkpoint_dir=str(tmp_path))
    counts = launch_counts()
    assert counts["lstm_gates"] == len(train) + len(val)
    assert counts["fused_conv_pool"] == 2 * len(val)
    assert all(p.requires_grad for p in net.base_model.parameters())
    reset_launch_counts()
    fc = TimeSeriesEstimator(net, val).predict(3, samples=np.arange(4))
    assert np.isfinite(fc.values).all()
    assert launch_counts()["fused_conv_pool"] == 6
    assert launch_counts()["lstm_gates"] == 3


def test_device_prefetch_on_card(dev):
    """Batches copied on a side stream equal the sampler's."""
    from dlwp_torch import PredictorDataset, SeriesSampler, device_prefetch

    n = 20
    data = PredictorDataset(
        predictors=np.random.RandomState(7).randn(n, 2, 8, 16)
        .astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, 8), lon=np.arange(16) * 22.5)
    kw = dict(input_time_steps=2, output_time_steps=2, add_insolation=True,
              batch_size=4, shuffle=True, seed=2, is_recurrent=True)
    want = list(SeriesSampler(data, **kw))
    got = list(device_prefetch(SeriesSampler(data, **kw), device=dev))
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.device == torch.empty(0, device=dev).device
        np.testing.assert_array_equal(gx.cpu().numpy(), wx)
        np.testing.assert_array_equal(gy.cpu().numpy(), wy)


# ------------------------------------------- device-resident training
def _series_data(n, seed=8):
    from dlwp_torch import PredictorDataset

    return PredictorDataset(
        predictors=np.random.RandomState(seed).randn(n, 2, 8, 16)
        .astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, 8), lon=np.arange(16) * 22.5)


def test_device_sampler_on_card_equals_host(dev):
    """Two shuffled epochs of sequence batches gathered on the card equal
    the host sampler's bit for bit."""
    from dlwp_torch import DeviceSeriesSampler, SeriesSampler

    data = _series_data(30)
    kw = dict(input_time_steps=2, output_time_steps=2, sequence=2,
              add_insolation=True, batch_size=4, shuffle=True, seed=3,
              is_recurrent=True)
    host = SeriesSampler(data, **kw)
    dsam = DeviceSeriesSampler(SeriesSampler(data, **kw), device=dev)
    for _ in range(2):
        for i, (x, y) in enumerate(dsam):
            xh, yh = host[i]
            assert x.device == torch.empty(0, device=dev).device
            assert torch.equal(x.cpu(), torch.from_numpy(xh))
            assert torch.equal(y.cpu(), torch.from_numpy(yh))
        host.on_epoch_end()


def test_fit_device_on_card_reads_nothing_back(dev):
    """fit_device of the flagship at 8x16, S=2 with the insolation splice
    and the example's chain: every epoch's step loop runs under
    torch.cuda.set_sync_debug_mode('error'); the gate kernel launches in
    every train step (forward and checkpoint's recompute), the conv-pool
    kernel only in validation."""
    from dlwp_torch import DeviceSeriesSampler, SeriesSampler
    from dlwp_torch.train import chain, clip_by_global_norm
    from dlwp_torch.train import cosine_decay_schedule
    from dlwp_torch.train.optim import adam

    data = _series_data(40)
    net = DLWPNeuralNet(time_dim=2, is_recurrent=True, scaler_type=None,
                        device=dev)
    kw = dict(input_time_steps=2, output_time_steps=2, sequence=2,
              add_insolation=True, batch_size=4)
    host = SeriesSampler(data, model=net, shuffle=True, **kw)
    train = DeviceSeriesSampler(host, device=dev)
    val = DeviceSeriesSampler(SeriesSampler(data, model=net, **kw),
                              device=dev)
    net.build_model(
        convlstm_specs(8, 16), sequence_steps=2,
        splice_fn=lambda inp, pred, k: torch.cat([pred, inp[:, :, 2:]], 2),
        optimizer=chain(clip_by_global_norm(1.0),
                        adam(cosine_decay_schedule(1e-3, 2 * len(train),
                                                   0.05))))
    net.init(host.generate(np.arange(1))[0], seed=0)
    real, steps = net.trainer._device_epoch, []

    def guarded(sampler, idx):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(sampler, idx)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        steps.append(len(out))
        return out

    net.trainer._device_epoch = guarded
    reset_launch_counts()
    hist = net.fit_generator(train, validation_data=val, epochs=2,
                             verbose=False)
    assert steps == [len(train)] * 2
    assert np.isfinite(hist.history["loss"]).all()
    assert launch_counts()["lstm_gates"] == 2 * (4 * len(train)
                                                 + 2 * len(val))
    assert launch_counts()["fused_conv_pool"] == 2 * 4 * len(val)


# Newly registered layers, at 8x16 (chip_smoke.py's phase at 36x144).
NEW_LAYER_SPECS = [
    ("slice_layer", (0, 2, 1), None),
    ("CyclicConv2D", (8, 3), {"impl": "edgefix", "dilation": 2,
                              "activation": "tanh"}),
    ("PeriodicPadding2D", ((0, 2),), None),
    ("ZeroPadding2D", ((1, 0),), None),
    ("Conv2D", (8, 5), {"activation": "tanh"}),
    ("TFPadding2D", (((1, 1), (0, 0)),), {"mode": "SYMMETRIC"}),
    ("Conv2D", (8, 4), {"strides": (2, 2), "padding": "same"}),
    ("RowConv2D", (8, 3), {"activation": "tanh"}),
    ("FillPadding2D", (1,), None),
    ("AveragePooling2D", (2,), None),
    ("Reshape", ((-1,),), None),
    ("Dense", (16,), {"activation": "tanh"}),
    ("Linear", (16, 6), None),
]


def test_new_layers_on_card_match_cpu(dev):
    from dlwp_torch import flax_tree, load_flax_params

    x = np.random.RandomState(9).randn(4, 3, 8, 16).astype(np.float32)
    card = build_sequential(NEW_LAYER_SPECS, device=dev)
    card.init(torch.from_numpy(x), seed=1)
    cpu = build_sequential(NEW_LAYER_SPECS, device="cpu")
    load_flax_params(cpu, flax_tree(card))
    with torch.inference_mode():
        got = card(torch.from_numpy(x).to(dev)).cpu()
        want = cpu(torch.from_numpy(x))
    assert got.shape == (4, 6)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_skip_tower_on_card_matches_cpu(dev):
    """SkipTower with the ConvLSTM front end: forward (one gate launch) and
    one train step's parameters on the card against the CPU."""
    from dlwp_torch import SkipTower, flax_tree, load_flax_params
    from dlwp_torch.train import TrainConfig, Trainer

    rng = np.random.RandomState(10)
    x = rng.randn(4, 2, 3, 16, 32).astype(np.float32)
    y = rng.randn(4, 4, 16, 32).astype(np.float32)
    card = build_sequential([SkipTower(4, width=16, time_steps=2,
                                       lstm_features=8)], device=dev)
    card.init(torch.from_numpy(x), seed=2)
    cpu = build_sequential([SkipTower(4, width=16, time_steps=2,
                                      lstm_features=8)], device="cpu")
    load_flax_params(cpu, flax_tree(card))
    reset_launch_counts()
    with torch.inference_mode():
        got = card(torch.from_numpy(x).to(dev)).cpu()
    assert launch_counts()["lstm_gates"] == 1
    torch.testing.assert_close(got, cpu(torch.from_numpy(x)).detach(),
                               rtol=0, atol=1e-5)
    params = {}
    for name, model in (("card", card), ("cpu", cpu)):
        tr = Trainer(model, TrainConfig())
        tr.init(x)
        tr.train_step(x, y)
        params[name] = {k: v.detach().cpu()
                        for k, v in model.state_dict().items()}
    assert _rel_rms(params["card"], params["cpu"]) <= 2e-4


def _scaled(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


def test_fold_on_card_matches_unfolded(dev):
    """fold=True on the card against the unfolded engine: fp32, 1e-5 of
    the output's scale (chip_smoke.py's fold limit)."""
    from dlwp_torch import SphericalHarmonics

    grid = LatLonGrid.regular(73, 144)
    fold = SphericalHarmonics.build(grid, 72, fold=True, device=dev)
    flat = SphericalHarmonics.build(grid, 72, device="cpu")
    x = torch.from_numpy(np.random.RandomState(11).randn(2, 73, 144)
                         .astype(np.float32))
    spec = flat.analyze(x)
    assert _scaled(fold.analyze(x.to(dev)), spec) <= 1e-5
    assert _scaled(fold.synthesize(spec.to(dev)), flat.synthesize(spec)) <= 1e-5
    for got, want in zip(fold.uv_from_vrtdiv(spec.to(dev), spec.to(dev)),
                         flat.uv_from_vrtdiv(spec, spec)):
        assert _scaled(got, want) <= 1e-5


def test_spherical_layer_on_card_matches_cpu(dev):
    from dlwp_torch import flax_tree, load_flax_params
    from dlwp_torch.models import S2Convolution

    x = np.random.RandomState(12).randn(4, 3, 73, 144).astype(np.float32)
    card = build_sequential([S2Convolution(3, 8, 36, 12, None,
                                           activation="tanh")], device=dev)
    card.init(torch.from_numpy(x), seed=3)
    cpu = build_sequential([S2Convolution(3, 8, 36, 12, None,
                                          activation="tanh")], device="cpu")
    load_flax_params(cpu, flax_tree(card))
    reset_launch_counts()
    with torch.inference_mode():
        got = card(torch.from_numpy(x).to(dev))
        want = cpu(torch.from_numpy(x))
    assert got.shape == (4, 8, 24, 24)
    assert _scaled(got, want) <= 1e-5
    assert sum(launch_counts().values()) == 0  # no hand kernel on this path


def test_archive_on_card_matches_cpu(dev):
    """A two-truth archive of 2 segments of 2 days: NaN rows in the same
    places, fields within 1e-3 of the anomaly RMS (chip_smoke.py's
    paper-run limit)."""
    from dlwp_torch.data import BarotropicArchiveSource

    kw = dict(n_samples=17, nlat=37, nlon=72, truncation=20,
              truth_truncation=30, truth_nlat=37, truth_nlon=72,
              segment_days=2, spinup_days=0.5)
    got = BarotropicArchiveSource(device=dev, **kw).field("HGT", 500)
    want = BarotropicArchiveSource(device="cpu", **kw).field("HGT", 500)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all() and nan.all(axis=(1, 2))[8]
    ok = want[~nan]
    assert (np.sqrt(np.mean((got[~nan] - ok) ** 2))
            <= 1e-3 * np.sqrt(np.mean((ok - ok.mean()) ** 2)))


def test_sharded_barotropic_on_card_matches_unsharded(dev):
    from dlwp_torch.parallel import ShardedBarotropicModel

    grid = LatLonGrid.gaussian(32, 64)
    mesh = build_mesh(MeshConfig(data=1, lat=2), devices=[dev] * 2)
    ref = BarotropicModel(grid, 15, dt=1800.0, device=dev)
    shd = ShardedBarotropicModel(grid, 15, dt=1800.0, device=dev, mesh=mesh)
    lat = np.radians(grid.lat)[:, None]
    z = (5500.0 - 300.0 * np.sin(lat) ** 2 + 0.0 * grid.lon[None, :])
    state = ref.from_z(z.astype(np.float32))
    want = ref.run(state, 20).vrt_spec
    got = shd.run_sharded(state, 20).vrt_spec
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_servable_exported_on_cpu_runs_the_kernels_on_card(dev, batch):
    """The 8x16 flagship's rollout exported on the CPU, serialized and
    loaded on the card: every constant there, both kernels launched per
    call as the eager model launches them, and the output within 1e-6
    relative RMS of the eager rollout on the card (the same ops)."""
    from dlwp_torch import flax_tree
    from dlwp_torch.serve import Servable, export_rollout

    specs = convlstm_specs(8, 16, 2, 2)
    x = np.random.RandomState(0).randn(4, 2, 2, 8, 16).astype(np.float32)
    cpu = DLWPNeuralNet(is_recurrent=True, time_dim=2, scaler_type=None,
                        device="cpu")
    cpu.build_model(specs)
    cpu.init(x, seed=1)
    card = DLWPNeuralNet(is_recurrent=True, time_dim=2, scaler_type=None,
                         device=dev)
    card.build_model(specs)
    card.load_flax_params(flax_tree(cpu.base_model))
    servable = Servable.load(export_rollout(cpu, x, 6).serialize())
    program = servable.program
    assert {t.device.type for t in (*program.state_dict.values(),
                                    *program.constants.values())} == {"cuda"}
    xb = np.random.RandomState(batch).randn(batch, *x.shape[1:]).astype(
        np.float32)
    reset_launch_counts()
    got = servable.predict_timeseries(xb)
    assert launch_counts()["fused_conv_pool"] == 6
    assert launch_counts()["lstm_gates"] == 3
    assert launch_counts()["cyclic_conv"] == 3 * 4
    want = card.predict_timeseries(xb, 6)
    assert (np.sqrt(np.mean((got - want) ** 2))
            <= 1e-6 * np.sqrt(np.mean(want ** 2)))


def test_custom_ops_opcheck_on_card(dev):
    """The ops' schema, fake implementation, autograd registration and
    AOT dispatch with CUDA tensors (the gates with operands that require
    grad, through the registered backward)."""
    x, k, b = (torch.from_numpy(a).to(dev)
               for a in _conv_pool_operands(4, 3, 24, 12, 32, 32))
    res = torch.library.opcheck(
        torch.ops.dlwp_torch.fused_conv_pool.default, (x, k, b, 2))
    assert set(res.values()) == {"SUCCESS"}
    ops = [torch.from_numpy(a).to(dev).requires_grad_()
           for a in _gate_operands(6)]
    for gd in (None, "bfloat16"):
        res = torch.library.opcheck(
            torch.ops.dlwp_torch.lstm_gates.default,
            (*ops, "tanh", "hard_sigmoid", gd))
        assert set(res.values()) == {"SUCCESS"}
    x, k, b = _cyclic_operands(5, 3, 12, 6, 16, 8, 3, dev)
    for up in (False, True):
        res = torch.library.opcheck(torch.ops.dlwp_torch.cyclic_conv.default,
                                    (x, k, b, "tanh", up))
        assert set(res.values()) == {"SUCCESS"}


def test_native_gather_feeds_a_train_step_on_card(dev):
    """The flagship's sampler at full width (36x144, B=8) gathers its batch
    with the native gather (one call for the inputs, one for the targets),
    bit-equal to the numpy version, and that batch trains one step on the
    card: the gate kernel once, a finite loss."""
    from dlwp_torch import PredictorDataset, SeriesSampler
    from dlwp_torch.data import native
    from dlwp_torch.ops.losses import latitude_weighted_loss, mse
    from dlwp_torch.train import TrainConfig, Trainer

    n = 40
    data = PredictorDataset(
        predictors=np.random.RandomState(8).randn(n, 2, 36, 144)
        .astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, 36), lon=np.arange(144) * 2.5)
    sampler = SeriesSampler(data, input_time_steps=2, output_time_steps=2,
                            add_insolation=True, batch_size=8, shuffle=True,
                            is_recurrent=True)
    samples = sampler._indices[:8]
    before = native.assemble.launches
    x, y = sampler.generate(samples)
    assert native.assemble.launches == before + 2
    series = data.predictors
    np.testing.assert_array_equal(
        x[:, :, :2], native.assemble_plain(series, samples, [0, 1], [0, 1]))
    np.testing.assert_array_equal(
        y, native.assemble_plain(series, samples, [2, 3], [0, 1]))
    model = build_sequential(convlstm_specs(), device=dev)
    model.init(torch.from_numpy(x), seed=3)
    tr = Trainer(model, TrainConfig(loss=latitude_weighted_loss(
        mse, data.lat)))
    tr.init(x)
    reset_launch_counts()
    loss = tr.train_step(x, y)["loss"].item()
    assert launch_counts()["lstm_gates"] == 1
    assert np.isfinite(loss)


def _forecast_estimator(dev, recurrent: bool, B: int, seed=0):
    """The flagship (ConvLSTM front end) or the tower at full width (36 x
    144, 2 fields, insolation) with seeded weights, its estimator and
    seeded forecast inputs of ``B`` init times."""
    from dlwp_torch import PredictorDataset, SeriesSampler, TimeSeriesEstimator
    from dlwp_torch.flagship import tower_specs

    n = B + 6
    rng = np.random.RandomState(seed)
    data = PredictorDataset(
        predictors=rng.randn(n, 2, 36, 144).astype(np.float32),
        sample=(np.datetime64("2007-01-01")
                + np.arange(n) * np.timedelta64(6, "h")),
        varlev=["HGT/500", "THICK/300-700"],
        lat=np.linspace(87.5, 0.0, 36), lon=np.arange(144) * 2.5)
    net = DLWPNeuralNet(time_dim=2, is_recurrent=recurrent, scaler_type=None,
                        device=dev)
    net.build_model(convlstm_specs() if recurrent else tower_specs(4))
    sampler = SeriesSampler(data, model=net, input_time_steps=2,
                            output_time_steps=2, add_insolation=True,
                            batch_size=B)
    net.init(sampler.generate(np.arange(1))[0], seed=seed + 1)
    est = TimeSeriesEstimator(net, sampler)
    x0, days, mean_state, _ = est.prepare_inputs(np.arange(B))
    return net, sampler, est, (x0, days, mean_state)


def _eager(monkeypatch, fn, *args):
    """``fn(*args)`` with the rollout's graph rule forced off."""
    from dlwp_torch.forecast import rollout as port_rollout

    with monkeypatch.context() as m:
        m.setattr(port_rollout, "_replays_graphs", lambda *a: False)
        return fn(*args)


@pytest.mark.parametrize("recurrent, B", [(True, 1), (True, 64), (False, 8)],
                         ids=["flagship-b1", "flagship-b64", "tower-b8"])
def test_graph_rollout_equals_eager_on_card(dev, monkeypatch, recurrent, B):
    """The graph path's forecast is bit-equal to the eager loop's, on the
    call that captures (its first step eager) and on later calls of other
    lengths (both turns of the windows); it counts the eager path's kernel
    launches, one capture, and a replay a step; a later call leaves an
    earlier call's forecast as it was."""
    from dlwp_torch.forecast import graph_counts, reset_graph_counts

    _, _, est, (x0, days, ms) = _forecast_estimator(dev, recurrent, B)
    reset_graph_counts()
    counts = {}
    for steps in (5, 4, 5):
        roll = est.rollout_fn(steps)
        reset_launch_counts()
        got = roll(x0, days, ms)
        torch.cuda.synchronize()
        counts["graph"] = launch_counts()
        reset_launch_counts()
        want = _eager(monkeypatch, roll, x0, days, ms)
        torch.cuda.synchronize()
        counts["eager"] = launch_counts()
        assert torch.equal(got, want), steps
        assert counts["graph"] == counts["eager"], steps
    assert counts["eager"]["fused_conv_pool"] == 5 * 2
    assert counts["eager"]["cyclic_conv"] == 5 * 4
    assert counts["eager"]["lstm_gates"] == (5 if recurrent else 0)
    assert graph_counts() == {"captures": 1, "replays": 5 - 1 + 4 + 5,
                              "eager_steps": 1 + 5 + 4 + 5}
    kept = got.clone()
    reset_graph_counts()
    again = roll(x0.flip(0) + 0.5, days, ms)
    torch.cuda.synchronize()
    assert graph_counts() == {"captures": 0, "replays": 5, "eager_steps": 0}
    assert torch.equal(got, kept) and not torch.equal(again, kept)


def test_graph_rollout_follows_swapped_weights_on_card(dev, monkeypatch):
    """Weights swapped after a capture, by ``share_params_from`` and by
    ``load_flax_params``, are captured anew and forecast as the eager loop
    does with them."""
    from dlwp_torch.forecast import graph_counts, reset_graph_counts
    from dlwp_torch.weights import flax_tree

    net, _, est, (x0, days, ms) = _forecast_estimator(dev, True, 2)
    other, *_ = _forecast_estimator(dev, True, 2, seed=7)
    third, *_ = _forecast_estimator(dev, True, 2, seed=11)
    roll = est.rollout_fn(3)
    before = roll(x0, days, ms).clone()
    reset_graph_counts()
    net.base_model.share_params_from(other.base_model)
    shared = roll(x0, days, ms)
    assert torch.equal(shared, _eager(monkeypatch, roll, x0, days, ms))
    assert not torch.equal(shared, before)
    net.load_flax_params(flax_tree(third.base_model))
    loaded = roll(x0, days, ms)
    assert torch.equal(loaded, _eager(monkeypatch, roll, x0, days, ms))
    assert not torch.equal(loaded, shared)
    assert graph_counts()["captures"] == 2


def test_graph_rollout_spans_a_step_each_on_card(dev):
    """Inside a profiler window the graph path records one ``rollout.step``
    and one ``rollout.model`` a step, and no eager step's spans."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from dlwp_torch.utils import profiling

    _, _, est, (x0, days, ms) = _forecast_estimator(dev, True, 1)
    steps = 6
    roll = est.rollout_fn(steps)
    roll(x0, days, ms)  # captures outside the window
    torch.cuda.synchronize()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        roll(x0, days, ms)
        torch.cuda.synchronize()
    got = Counter(r.name for r in profiling.spans())
    profiling.clear_spans()
    assert got["rollout"] == 1
    assert got["rollout.step"] == got["rollout.model"] == steps
    assert not {"rollout.build_next", "rollout.capture"} & set(got)
    assert not any(name.startswith("layer.") for name in got)

"""The frozen FLOP and byte counts against hand-worked numbers."""

from __future__ import annotations

import pytest

from h100bench import counts, specs


def cfg(name):
    return specs.load_json("configs", name)


def test_conv_pool_stages_of_the_flagship_at_b64():
    s1, s2 = counts.conv_pool_stages(cfg("flagship"))
    # Stage 1: (64, 24, 36, 144) -> 32, dilation 2; read 31.85 MB, write
    # 10.62 MB, weights 27.8 KB; 2 x 64 x 5184 x 32 x 24 x 9 FLOPs.
    b, f = counts.conv_pool_cost(s1, 64)
    assert b == 4 * (64 * (24 * 36 * 144 + 32 * 18 * 72) + 32 * 24 * 9 + 32)
    assert round(b / 1e6, 1) == 42.5
    assert f == 4_586_471_424 and round(f / 1e9, 2) == 4.59
    b, f = counts.conv_pool_cost(s2, 64)
    assert round(b / 1e6, 1) == 16.0 and round(f / 1e9, 2) == 3.06
    # The least time of stage 1 is its FLOPs at 3xTF32: 0.0278 ms.
    assert round(counts.bound_s(*counts.conv_pool_cost(s1, 64)) * 1e3, 4) \
        == 0.0278


def test_gate_cost_at_b64():
    (layer,) = counts.gate_layers(cfg("flagship"))
    b, f = counts.gate_cost(layer, 64)
    assert round(b / 1e6, 1) == 175.2  # zx, zh 48 ch; c in, h and c out 12
    assert f == 16 * 64 * 12 * 36 * 144
    assert counts.gate_launches_per_step(cfg("flagship")) == 1
    assert counts.gate_launches_per_step(cfg("tower")) == 0


@pytest.mark.parametrize("name,batch,gflop", [("flagship", 64, 42.446),
                                              ("tower", 256, 135.386)])
def test_forward_flops_a_step(name, batch, gflop):
    # Flagship: ConvLSTM 5.16 (input conv of both steps, recurrent conv of
    # the second) + tower 37.29; tower-only: 4x the batch, 6 input channels.
    assert round(counts.forward_flops(cfg(name)) * batch / 1e9, 3) == gflop


def test_flagship_flops_by_layer():
    rows = counts.flops_by_layer(cfg("flagship"))
    got = [round(r["gflop"] * 64, 2) for r in rows]
    assert got == [5.16, 4.59, 3.06, 3.06, 12.23, 12.23, 2.12]


def test_peaks():
    assert counts.PEAK_FLOPS == 165e12
    assert counts.PEAK_BYTES == 3.35e12

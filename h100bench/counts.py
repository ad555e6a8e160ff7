"""Frozen counts: the chip's peaks, model FLOPs and the hand kernels' bytes
and operations, all from a configuration's shapes (never from a kernel).

Each input is counted as read once and each output as written once; the
model's FLOPs are 2 x the multiply-adds of its convolutions at their
nominal resolutions (no recompute, no fused rewrites).
"""

from __future__ import annotations

from h100bench import specs

# One NVIDIA H100 SXM (data sheet, dense). The FLOP peak is the fastest
# fp32-accurate product the card has: 3xTF32 on the tensor cores, 495 / 3
# TFLOP/s, the form the port's conv kernels use.
PEAK_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
F32 = 4
# Elementwise operations of one gate-chain element (B, F, H, W): 4 adds
# of zx + zh, three hard sigmoids (mul, add), c' = f c + i g (3), h' = o
# tanh(c') (1), two tanh (1 each).
GATE_FLOPS_PER_ELEMENT = 16


def forward_flops(cfg: dict) -> int:
    """FLOPs of one model application to one sample."""
    return 2 * sum(s.macs for s in specs.walk(cfg))


def flops_by_layer(cfg: dict) -> list[dict]:
    """The table a configuration file records: each conv layer's shape and
    GFLOP for one sample and one model step."""
    rows = []
    for s in specs.walk(cfg):
        if s.macs:
            rows.append({"layer": s.index, "kind": s.kind,
                         "in": list(s.in_shape), "out": list(s.out_shape),
                         "gflop": 2 * s.macs / 1e9})
    return rows


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def conv_pool_stages(cfg: dict) -> list[specs.LayerShape]:
    """The conv + 2x2 max-pool pairs that the port fuses into its
    ``fused_conv_pool`` kernel: a 3x3 tanh CyclicConv2D followed by
    MaxPooling2D(2)."""
    shapes = specs.walk(cfg)
    return [a for a, b in zip(shapes, shapes[1:])
            if a.kind == "CyclicConv2D" and _k(a) == 3
            and a.kwargs.get("activation") == "tanh"
            and b.kind == "MaxPooling2D" and tuple(b.args) in ((2,), ((2,),))]


def _k(s: specs.LayerShape) -> int:
    return s.params["kernel"][-1]


def conv_pool_cost(stage: specs.LayerShape, batch: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one conv-pool launch over ``batch`` samples: the
    input, the weights and bias read, the pooled output written; the conv
    at full resolution."""
    C, H, W = stage.in_shape
    O = stage.out_shape[0]
    nbytes = F32 * (batch * (C * H * W + O * (H // 2) * (W // 2))
                    + O * C * 9 + O)
    return nbytes, 2 * batch * H * W * O * C * 9


def gate_layers(cfg: dict) -> list[specs.LayerShape]:
    return [s for s in specs.walk(cfg) if s.kind == "ConvLSTM2D"]


def gate_cost(layer: specs.LayerShape, batch: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one ``lstm_gates`` launch: zx, zh (4F) and c (F)
    read, h and c (F) written."""
    T, _, H, W = layer.in_shape
    F = layer.params["bias"][0] // 4
    n = batch * F * H * W
    return F32 * 11 * n, GATE_FLOPS_PER_ELEMENT * n


def gate_launches_per_step(cfg: dict) -> int:
    """Gate-chain launches of one model application: steps t >= 1 of each
    ConvLSTM2D (step 0 starts from a zero state)."""
    return sum(s.in_shape[0] - 1 for s in gate_layers(cfg))

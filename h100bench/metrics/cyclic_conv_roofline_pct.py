"""The ``cyclic_conv`` kernel's share of its roofline: the summed least
times of its traced launches over their device time.

The launches of one model step and their shapes come from the
configuration, counted as the kernel computes them: the tower's convs as
the port's peephole fusions leave them, each a 3x3 conv on the grid it
runs on. A conv after a 2x upsampling runs on the small grid, a
dilation-2 one that a conv follows keeps its output there, and one of
dilation 1 runs as four parity kernels (4 O channels; a 5x5 folded to
3x3). The configuration's nominal layers would count the upsampled grids
(2.8x too high at the last two convs). Where the trace holds no launch
(a program without the kernel) there is nothing to read.
"""

from h100bench import counts, specs
from h100bench.readers import roofline_pct

F32 = 4


def _act(s):
    return s.kwargs.get("activation", "linear") or "linear"


def _conv(s, kind):
    """(kernel size, dilation, stride 1 and zero latitude boundary) of a
    conv layer ``s`` of ``kind``, or None for another layer."""
    if s.kind != kind:
        return None
    d = s.kwargs.get("dilation", s.kwargs.get("dilation_rate", 1))
    plain = (s.kwargs.get("strides", 1) in (1, (1, 1))
             and s.kwargs.get("lat_mode", "zero") == "zero")
    return s.params["kernel"][-1], d if isinstance(d, int) else d[0], plain


def launches(cfg: dict) -> list[tuple[int, int, int, int]]:
    """(C, H, W, N) of each launch of one model step: input channels, the
    grid the kernel runs on, output channels as it computes them."""
    shapes = specs.walk(cfg)
    out, i = [], 0
    while i < len(shapes):
        s = shapes[i]
        nxt = shapes[i + 1] if i + 1 < len(shapes) else None
        conv = _conv(s, "CyclicConv2D")
        if conv and nxt is not None and nxt.kind == "MaxPooling2D":
            i += 2  # the conv-pool kernel's stage
            continue
        if conv:
            k, d, plain = conv
            if k == 3 and d == 1 and plain and _act(s) in ("linear", "tanh"):
                out.append((s.in_shape[0],) + tuple(s.in_shape[1:])
                           + (s.out_shape[0],))
            i += 1
            continue
        up = _conv(nxt, "CyclicConv2D") if nxt is not None else None
        if s.kind == "UpSampling2D" and up and up[2]:
            k, d, _ = up
            C, H, W = nxt.in_shape
            O = nxt.out_shape[0]
            after = shapes[i + 2] if i + 2 < len(shapes) else None
            follow = _conv(after, "CyclicConv2D") if after is not None else None
            act_ok = _act(nxt) in ("linear", "tanh")
            if d == 2 and follow and follow[2] and follow[0] <= 5 \
                    and follow[1] in (1, 2):
                # emit_small: the conv on the small grid; the next conv
                # reads the small grid and runs as an upsampling conv.
                if k == 3 and act_ok:
                    out.append((C, H // 2, W // 2, O))
                fk, fd, _ = follow
                if fd == 1 and fk % 2 and _act(after) in ("linear", "tanh"):
                    C2, H2, W2 = after.in_shape
                    out.append((C2, H2 // 2, W2 // 2,
                                4 * after.out_shape[0]))
                i += 3
                continue
            if d == 1 and k % 2 and k <= 5 and act_ok:
                out.append((C, H // 2, W // 2, 4 * O))
            i += 2
            continue
        i += 1
    return out


def cost(C, H, W, N, batch):
    """(bytes, FLOPs) of one launch over ``batch`` samples: the input, the
    weights and bias read, the output written."""
    nbytes = F32 * (batch * (C + N) * H * W + N * C * 9 + N)
    return nbytes, 2 * batch * H * W * N * C * 9


def read(ctx):
    convs = launches(ctx["cfg"])
    if not convs:
        return None
    batch = ctx["traffic"]["batch"]
    units = dict(ctx["units"], cyclic_conv_per_step=len(convs),
                 cyclic_conv_bound_s_per_step=sum(
                     counts.bound_s(*cost(*c, batch)) for c in convs))
    return roofline_pct(dict(ctx, units=units), "cyclic_conv_kernel",
                        "cyclic_conv_per_step", "cyclic_conv_bound_s_per_step")

"""ConvLSTM gate chain in one pass (kernel ``csrc/lstm_gates.cu``).

Port of ``dlwp_tpu.ops.lstm_gates.fused_lstm_gates`` (forward).
:func:`lstm_gates` launches the CUDA kernel for CUDA tensors and takes the
plain PyTorch version, :func:`lstm_gates_plain`, for CPU tensors.
``lstm_gates.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from dlwp_torch.kernels import _build

# Runtime activation codes of the kernel (enum Act in csrc/lstm_gates.cu).
ACT_CODES = {"linear": 0, "tanh": 1, "sigmoid": 2, "hard_sigmoid": 3}


def hard_sigmoid(t):
    """Keras ``hard_sigmoid``, ``clip(0.2 t + 0.5, 0, 1)``; not
    ``torch.nn.functional.hardsigmoid`` (slope 1/6)."""
    return torch.clamp(0.2 * t + 0.5, 0.0, 1.0)


_ACTS = {
    "linear": lambda t: t,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": hard_sigmoid,
}


def _act(name):
    try:
        return _ACTS[name]
    except KeyError:
        raise ValueError(
            f"lstm gates support activations {sorted(_ACTS)}, got {name!r}"
        ) from None


def _gate_dtype(gate_dtype):
    if gate_dtype is None:
        return None
    gd = getattr(torch, gate_dtype) if isinstance(gate_dtype, str) else gate_dtype
    if gd != torch.bfloat16:
        raise ValueError(f"gate_dtype must be None or bfloat16, got {gate_dtype!r}")
    return gd


def lstm_gates_plain(zx, zh, c, activation="tanh",
                     recurrent_activation="hard_sigmoid", gate_dtype=None):
    """``(h', c')`` with the op order and rounding points of the JAX
    ``lstm_gates_reference``; ``zx`` carries the bias."""
    act, r_act = _act(activation), _act(recurrent_activation)
    gd = _gate_dtype(gate_dtype)
    z = zx + zh
    if gd is not None:
        z = z.to(gd)
    i, f, g, o = torch.chunk(z, 4, dim=-3)
    if gd is None:
        c_new = r_act(f) * c + r_act(i) * act(g)
        return r_act(o) * act(c_new), c_new
    c_new = (r_act(f) * c.to(gd) + r_act(i) * act(g)).to(c.dtype)
    h_new = (r_act(o) * act(c_new.to(gd))).to(c.dtype)
    return h_new, c_new


def _lib():
    lib = _build.load("lstm_gates")
    fn = lib.dlwp_lstm_gates
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def lstm_gates(zx, zh, c, activation="tanh",
               recurrent_activation="hard_sigmoid", gate_dtype=None):
    """zx, zh (B, 4F, H, W) and carry c (B, F, H, W) -> (h', c')."""
    B, C4, H, W = zx.shape
    if C4 % 4 or zh.shape != zx.shape or c.shape != (B, C4 // 4, H, W):
        raise ValueError(
            f"lstm_gates shapes: zx {tuple(zx.shape)}, zh {tuple(zh.shape)}, "
            f"c {tuple(c.shape)}"
        )
    if zx.device.type == "cpu":
        return lstm_gates_plain(zx, zh, c, activation, recurrent_activation,
                                gate_dtype)
    if zx.device.type != "cuda":
        raise ValueError(f"lstm_gates: unsupported device {zx.device}")
    _act(activation), _act(recurrent_activation)  # raise on unknown names
    a_code = ACT_CODES[activation]
    r_code = ACT_CODES[recurrent_activation]
    use_bf16 = int(_gate_dtype(gate_dtype) is not None)
    for name, t in (("zx", zx), ("zh", zh), ("c", c)):
        if t.device != zx.device or t.dtype != torch.float32:
            raise ValueError(
                f"lstm_gates: {name} must be float32 on {zx.device}, got "
                f"{t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"lstm_gates: {name} must be contiguous")
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    lib = _lib()
    with torch.cuda.device(zx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlwp_lstm_gates(
            zx.data_ptr(), zh.data_ptr(), c.data_ptr(), h_out.data_ptr(),
            c_out.data_ptr(), c.numel(), (C4 // 4) * H * W, a_code, r_code,
            use_bf16, stream,
        )
    if err:
        raise RuntimeError(f"lstm_gates launch failed: CUDA error {err}")
    lstm_gates.launches += 1
    return h_out, c_out


lstm_gates.launches = 0

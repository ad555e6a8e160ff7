"""ConvLSTM gate chain in one pass (kernel ``csrc/lstm_gates.cu``).

Port of ``dlwp_tpu.ops.lstm_gates.fused_lstm_gates``.
:func:`lstm_gates` launches the CUDA kernel for CUDA tensors and takes the
plain PyTorch version, :func:`lstm_gates_plain`, for CPU tensors, through
the torch custom op ``dlwp_torch::lstm_gates`` (a fake implementation gives
its shapes, so ``torch.export`` traces it into a program, which then
launches the kernel on the card). ``lstm_gates.launches`` counts kernel
launches, in the op's CUDA implementation.

It is differentiable as the JAX ``custom_vjp`` is: the op's registered
backward recomputes the gate chain through :func:`lstm_gates_plain` and
takes that version's vector-Jacobian product (the JAX backward is not a
Pallas kernel either).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dlwp_torch.kernels import _build
from dlwp_torch.utils.profiling import span

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


def gate_chain(zx, zh, c, act, r_act, gate_dtype=None):
    """``(h', c')`` for activation callables ``act`` and ``r_act``, with
    the op order and rounding points of the JAX ``lstm_gates_reference``;
    ``zx`` carries the bias. ``ConvLSTM2D`` runs it for activations the
    kernel does not have."""
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


def lstm_gates_plain(zx, zh, c, activation="tanh",
                     recurrent_activation="hard_sigmoid", gate_dtype=None):
    """The kernel's plain version: :func:`gate_chain` for the activations
    the kernel has (raises on any other name)."""
    return gate_chain(zx, zh, c, _act(activation), _act(recurrent_activation),
                      gate_dtype)


def _lib():
    lib = _build.load("lstm_gates")
    fn = lib.dlwp_lstm_gates
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _launch(zx, zh, c, activation, recurrent_activation, gate_dtype):
    """One kernel launch on checked CUDA tensors."""
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    lib = _lib()
    with torch.cuda.device(zx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlwp_lstm_gates(
            zx.data_ptr(), zh.data_ptr(), c.data_ptr(), h_out.data_ptr(),
            c_out.data_ptr(), c.numel(), c[0].numel(),
            ACT_CODES[activation], ACT_CODES[recurrent_activation],
            int(_gate_dtype(gate_dtype) is not None), stream,
        )
    if err:
        raise RuntimeError(f"lstm_gates launch failed: CUDA error {err}")
    lstm_gates.launches += 1
    return h_out, c_out


def _check_args(zx, zh, c, activation, recurrent_activation, gate_dtype):
    """Raise on shapes, activation names and gate dtypes the kernel and its
    plain version do not take."""
    B, C4, H, W = zx.shape
    if C4 % 4 or zh.shape != zx.shape or c.shape != (B, C4 // 4, H, W):
        raise ValueError(
            f"lstm_gates shapes: zx {tuple(zx.shape)}, zh {tuple(zh.shape)}, "
            f"c {tuple(c.shape)}"
        )
    _act(activation), _act(recurrent_activation), _gate_dtype(gate_dtype)


@torch.library.custom_op("dlwp_torch::lstm_gates", mutates_args=(),
                         device_types="cpu")
def _op(zx: torch.Tensor, zh: torch.Tensor, c: torch.Tensor, activation: str,
        recurrent_activation: str, gate_dtype: Optional[str]
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The op on the CPU: the plain version."""
    _check_args(zx, zh, c, activation, recurrent_activation, gate_dtype)
    return lstm_gates_plain(zx, zh, c, activation, recurrent_activation,
                            gate_dtype)


@_op.register_kernel("cuda")
def _op_cuda(zx, zh, c, activation, recurrent_activation, gate_dtype):
    """The op on the card: checks every operand, then launches the kernel
    (``lstm_gates.launches`` counts it). Exported programs call the op
    directly, so every check is here; nothing falls back to the plain
    version."""
    _check_args(zx, zh, c, activation, recurrent_activation, gate_dtype)
    for name, t in (("zx", zx), ("zh", zh), ("c", c)):
        if t.device != zx.device or t.dtype != torch.float32:
            raise ValueError(
                f"lstm_gates: {name} must be float32 on {zx.device}, got "
                f"{t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"lstm_gates: {name} must be contiguous")
    return _launch(zx, zh, c, activation, recurrent_activation, gate_dtype)


@_op.register_fake
def _op_fake(zx, zh, c, activation, recurrent_activation, gate_dtype):
    return torch.empty_like(c), torch.empty_like(c)


def _setup_context(ctx, inputs, output):
    zx, zh, c, *acts = inputs
    ctx.save_for_backward(zx, zh, c)
    ctx.acts = acts


def _backward(ctx, grad_h, grad_c):
    """The plain version's VJP, recomputed from the saved operands, as the
    JAX ``custom_vjp`` (whose backward is not a Pallas kernel either)."""
    operands = [t.detach().requires_grad_(need) for t, need in
                zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
    wrt = [t for t in operands if t.requires_grad]
    grads = iter(())
    if wrt:
        with torch.enable_grad():
            h, c_new = lstm_gates_plain(*operands, *ctx.acts)
            grads = iter(torch.autograd.grad((h, c_new), wrt,
                                             (grad_h, grad_c)))
    return tuple(next(grads) if t.requires_grad else None
                 for t in operands) + (None, None, None)


_op.register_autograd(_backward, setup_context=_setup_context)


@span("kernel.lstm_gates")
def lstm_gates(zx, zh, c, activation="tanh",
               recurrent_activation="hard_sigmoid", gate_dtype=None):
    """zx, zh (B, 4F, H, W) and carry c (B, F, H, W) -> (h', c') through
    the op ``dlwp_torch::lstm_gates`` (the kernel on the card, the plain
    version on the CPU); differentiable in zx, zh and c. ``gate_dtype``:
    None, ``torch.bfloat16`` or its name."""
    if isinstance(gate_dtype, torch.dtype):
        gate_dtype = str(gate_dtype).removeprefix("torch.")
    if zx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_gates: unsupported device {zx.device}")
    return _op(zx, zh, c, activation, recurrent_activation, gate_dtype)


lstm_gates.launches = 0

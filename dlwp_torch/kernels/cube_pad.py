"""The cubed sphere's halo in one pass (kernel ``csrc/cube_pad.cu``).

New with the cube models: the JAX package has no cubed sphere, so its
plain version, :func:`~dlwp_torch.ops.padding.cube_pad_plain`, is the
reference. :func:`cube_pad` goes through the torch custom op
``dlwp_torch::cube_pad``: the kernel for CUDA tensors, the plain version
for CPU tensors, and a fake implementation for shapes, so a CUDA graph
capture and ``torch.export`` hold it as one op. ``cube_pad.launches``
counts kernel launches, in the op's CUDA implementation.

The op's registered backward is the plain vector-Jacobian product
(:func:`~dlwp_torch.ops.padding.cube_pad_vjp`): each halo cell's gradient
added back to its source cell, a fixed-order sum of gathers, on every
device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dlwp_torch.device import tensor_cache
from dlwp_torch.grid import cubed_sphere
from dlwp_torch.kernels import _build
from dlwp_torch.ops.padding import cube_pad_plain, cube_pad_vjp, cube_shape
from dlwp_torch.utils.profiling import span


def _lib():
    lib = _build.load("cube_pad")
    fn = lib.dlwp_cube_pad
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


# The kernel's table entry: the source face above this bit, the cell of
# the face below it (FACE_SHIFT in csrc/cube_pad.cu).
FACE_SHIFT = 28


@tensor_cache(maxsize=64)
def _table(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """:func:`~dlwp_torch.grid.cubed_sphere.pad_table` as the kernel reads
    it, on ``device``: ``(face << FACE_SHIFT) | cell`` in int32."""
    flat = cubed_sphere.pad_table(n, pad).reshape(-1)
    t = ((flat // (n * n)) << FACE_SHIFT | flat % (n * n)).astype(np.int32)
    with torch.inference_mode(False):
        return torch.from_numpy(t).to(device, non_blocking=True)


@torch.library.custom_op("dlwp_torch::cube_pad", mutates_args=(),
                         device_types="cpu")
def _op(eq: torch.Tensor, pol: torch.Tensor, pad: int) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    return cube_pad_plain(eq, pol, pad)


@_op.register_kernel("cuda")
def _op_cuda(eq, pol, pad):
    """The op on the card: checks every operand, then launches the kernel
    (``cube_pad.launches`` counts it)."""
    B, C, n = cube_shape(eq, pol)
    for name, t in (("eq", eq), ("pol", pol)):
        if t.device != eq.device or t.dtype != torch.float32:
            raise ValueError(f"cube_pad: {name} must be float32 on "
                             f"{eq.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"cube_pad: {name} must be contiguous")
    if not 0 <= pad <= n or B * C >= 2 ** 31:
        raise ValueError(f"cube_pad: pad {pad} on faces of {n}, {B * C} "
                         "planes: out of range")
    m = n + 2 * pad
    out = torch.empty((6 * B, C, m, m), dtype=eq.dtype, device=eq.device)
    table = _table(n, pad, eq.device)
    lib = _lib()
    with torch.cuda.device(eq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlwp_cube_pad(eq.data_ptr(), pol.data_ptr(),
                                table.data_ptr(), out.data_ptr(), B * C, n,
                                pad, stream)
    if err:
        raise RuntimeError(f"cube_pad launch failed: CUDA error {err}")
    cube_pad.launches += 1
    return out


@_op.register_fake
def _op_fake(eq, pol, pad):
    B, C, n = eq.shape[0] // 4, eq.shape[1], eq.shape[-1]
    m = n + 2 * pad
    return eq.new_empty((6 * B, C, m, m))


def _setup_context(ctx, inputs, output):
    ctx.pad = inputs[2]


def _backward(ctx, grad):
    g_eq, g_pol = cube_pad_vjp(grad.contiguous(), ctx.pad)
    return g_eq, g_pol, None


_op.register_autograd(_backward, setup_context=_setup_context)


@span("kernel.cube_pad")
def cube_pad(eq: torch.Tensor, pol: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Equatorial (4B, C, n, n) and polar (2B, C, n, n) faces -> the padded
    field (6B, C, n + 2 pad, n + 2 pad) through the op
    ``dlwp_torch::cube_pad`` (the kernel on the card, the plain version on
    the CPU); differentiable in both inputs."""
    if eq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cube_pad: unsupported device {eq.device}")
    return _op(eq, pol, int(pad))


cube_pad.launches = 0

"""Fused conv3x3 + bias + tanh + 2x2 max-pool (kernel ``csrc/fused_conv_pool.cu``).

Port of ``dlwp_tpu.ops.fused_stages.fused_conv_pool``, the encoder stages
of the flagship tower. :func:`fused_conv_pool` launches the CUDA kernel for
a CUDA tensor and takes the plain PyTorch version,
:func:`fused_conv_pool_plain`, for a CPU tensor. ``fused_conv_pool.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from dlwp_torch.kernels import _build
from dlwp_torch.ops.conv import cyclic_conv2d
from dlwp_torch.ops.pooling import max_pool2d

_MAX_SMEM = 227 * 1024


def fused_conv_pool_plain(x, kernel, bias=None, dilation: int = 2):
    """``max_pool2d(tanh(cyclic_conv2d(x, kernel, d) + bias))``, with the max
    taken over the raw conv sums first (exact: tanh is monotone)."""
    y = cyclic_conv2d(x, kernel, dilation=(dilation, dilation))
    y = max_pool2d(y, (2, 2))
    if bias is not None:
        y = y + bias[:, None, None]
    return torch.tanh(y)


def _lib():
    lib = _build.load("fused_conv_pool")
    fn = lib.dlwp_fused_conv_pool
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dlwp_fused_conv_pool_smem_bytes.argtypes = [ctypes.c_int]
    lib.dlwp_fused_conv_pool_smem_bytes.restype = ctypes.c_int
    return lib


def fused_conv_pool(x, kernel, bias=None, dilation: int = 2):
    """x (B, C, H, W) with H, W even; kernel (O, C, 3, 3); bias (O,) or None.
    Returns (B, O, H/2, W/2)."""
    B, C, H, W = x.shape
    O = kernel.shape[0]
    if kernel.shape != (O, C, 3, 3) or H % 2 or W % 2:
        raise ValueError(
            f"fused_conv_pool needs a (O, {C}, 3, 3) kernel and even H, W; "
            f"got kernel {tuple(kernel.shape)}, x {tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        return fused_conv_pool_plain(x, kernel, bias, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pool: unsupported device {x.device}")
    if bias is None:
        bias = x.new_zeros(O)
    for name, t in (("x", x), ("kernel", kernel), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(
                f"fused_conv_pool: {name} must be float32 on {x.device}, got "
                f"{t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_conv_pool: {name} must be contiguous")
    if bias.shape != (O,):
        raise ValueError(f"fused_conv_pool: bias shape {tuple(bias.shape)}")
    if not 1 <= dilation < W:
        raise ValueError(f"fused_conv_pool: dilation {dilation} out of range")
    lib = _lib()
    if lib.dlwp_fused_conv_pool_smem_bytes(dilation) > _MAX_SMEM:
        raise ValueError(f"fused_conv_pool: dilation {dilation} too large")
    if B * -(-O // 32) > 65535 or H // 2 > 65535:
        raise ValueError(f"fused_conv_pool: grid too large for {x.shape}")
    y = torch.empty((B, O, H // 2, W // 2), device=x.device,
                    dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlwp_fused_conv_pool(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, C, H, W, O, dilation, stream,
        )
    if err:
        raise RuntimeError(f"fused_conv_pool launch failed: CUDA error {err}")
    fused_conv_pool.launches += 1
    return y


fused_conv_pool.launches = 0

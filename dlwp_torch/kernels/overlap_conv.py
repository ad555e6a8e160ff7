"""3x3 cyclic conv of lat-band shards (kernel ``csrc/overlap_conv.cu``).

Port of the two Pallas kernels of ``dlwp_tpu.parallel.pallas_overlap``:
:func:`overlap_conv` of ``_overlap_kernel`` (the whole batch at once) and
:func:`overlap_conv_db` of ``_overlap_kernel_db`` (the batch walked in
``chunk``-sized pieces through a double-buffered ring). Both compute, for
``shards[d][l]`` (B, C, H, W), ``cyclic_conv2d(x, kernel,
lat_mode='zero')`` of each data row's global field band by band, reading
the neighbouring bands' edge rows, in float32 whatever the input dtype.
For CUDA tensors each launches its kernel once per card, covering every
shard on it; for CPU tensors both take the plain version,
:func:`overlap_conv_plain`. ``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dlwp_torch.kernels import _build
from dlwp_torch.kernels.halo_exchange import (
    check_shards,
    device_groups,
    halo_rows_plain,
    neighbour_table,
)
from dlwp_torch.ops.padding import pad_latlon


def overlap_conv_plain(shards, kernel):
    """Per shard: neighbour rows, longitude wrap, VALID conv, in float32."""
    out = []
    for row in shards:
        row = [s.float() for s in row]
        out.append([
            F.conv2d(pad_latlon(p, (0, 0), (1, 1)),
                     kernel.to(device=p.device, dtype=torch.float32))
            for p in halo_rows_plain(row, (1, 1))
        ])
    return out


def _check(shards, kernel, name):
    first = check_shards(shards, name)
    if first.dim() != 4:
        raise ValueError(f"{name}: shards must be (B, C, H, W), got "
                         f"{tuple(first.shape)}")
    B, C, H, W = first.shape
    O = kernel.shape[0]
    if kernel.shape != (O, C, 3, 3):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} is not "
                         f"(O, {C}, 3, 3)")
    if H < 2:
        raise ValueError(f"{name}: need at least 2 local rows, got {H}")
    return first


def _lib():
    lib = _build.load("overlap_conv")
    head = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.dlwp_overlap_conv.argtypes = head + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.dlwp_overlap_conv_db.argtypes = head + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    for fn in (lib.dlwp_overlap_conv, lib.dlwp_overlap_conv_db):
        fn.restype = ctypes.c_int
    lib.dlwp_overlap_conv_smem_bytes.argtypes = [ctypes.c_int] * 2
    for fn in (lib.dlwp_overlap_conv_smem_bytes,
               lib.dlwp_overlap_conv_max_shards):
        fn.restype = ctypes.c_int
    return lib


_MAX_SMEM = 227 * 1024


def _launch(shards, kernel, chunk, name):
    """One launch per card; ``chunk`` None selects ``dlwp_overlap_conv``."""
    first = shards[0][0]
    B, C, H, W = first.shape
    O = kernel.shape[0]
    if first.dtype != torch.float32:
        raise ValueError(f"{name}: shards must be float32, got {first.dtype}")
    groups = device_groups(shards, name)
    lib = _lib()
    if lib.dlwp_overlap_conv_smem_bytes(B, chunk or 0) > _MAX_SMEM:
        raise ValueError(f"{name}: chunk {chunk} too large")
    out = [[None] * len(row) for row in shards]
    for dev, keys in groups.items():
        n = len(keys)
        groups_z = 1 if chunk else -(-B // 16)
        if n > lib.dlwp_overlap_conv_max_shards() or n * H * groups_z > 65535:
            raise ValueError(f"{name}: grid too large for {n} shards of "
                             f"{tuple(first.shape)}")
        kt = kernel.to(device=dev, dtype=torch.float32).permute(
            1, 2, 3, 0).contiguous()
        for d, l in keys:
            out[d][l] = torch.empty((B, O, H, W), device=dev,
                                    dtype=torch.float32)
        north, south = neighbour_table(keys)
        args = [
            (ctypes.c_void_p * n)(*[shards[d][l].data_ptr() for d, l in keys]),
            (ctypes.c_void_p * n)(*[out[d][l].data_ptr() for d, l in keys]),
            (ctypes.c_int * n)(*north), (ctypes.c_int * n)(*south), n,
            kt.data_ptr(), B, C, H, W, O,
        ]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if chunk:
                err = lib.dlwp_overlap_conv_db(*args, chunk, stream)
            else:
                err = lib.dlwp_overlap_conv(*args, stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        wrapper = overlap_conv_db if chunk else overlap_conv
        wrapper.launches += 1
    return out


def overlap_conv(shards, kernel):
    """``shards[d][l]`` (B, C, H, W), kernel (O, C, 3, 3) -> (B, O, H, W)
    float32 per shard."""
    _check(shards, kernel, "overlap_conv")
    if shards[0][0].device.type == "cpu":
        return overlap_conv_plain(shards, kernel)
    return _launch(shards, kernel, None, "overlap_conv")


def overlap_conv_db(shards, kernel, chunk: int):
    """As :func:`overlap_conv`, each block walking the batch in ``chunk``
    samples at a time (the batch need not divide into chunks)."""
    _check(shards, kernel, "overlap_conv_db")
    if chunk < 1:
        raise ValueError(f"overlap_conv_db: chunk {chunk} < 1")
    if shards[0][0].device.type == "cpu":
        return overlap_conv_plain(shards, kernel)
    return _launch(shards, kernel, int(chunk), "overlap_conv_db")


overlap_conv.launches = 0
overlap_conv_db.launches = 0

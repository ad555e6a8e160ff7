"""Overlapped halo exchange + 3x3 stencil through the ``overlap_conv``
kernels (port of ``dlwp_tpu.parallel.pallas_overlap``).

:func:`overlapped_cyclic_conv2d` takes the global (B, C, H, W) activation,
as the JAX function does under ``shard_map``, and returns the global
float32 result of ``cyclic_conv2d(x, kernel, lat_mode='zero')``.
:func:`_overlap_local` picks the kernel and the batch chunk per shard
shape rule for rule as the JAX ``_overlap_local`` does, so the same shapes
take the same kernel and chunk in both packages.
"""

from __future__ import annotations

import torch

from dlwp_torch.kernels.overlap_conv import overlap_conv, overlap_conv_db
from dlwp_torch.parallel.mesh import Mesh, Remote, join_shards, split_shards

# The dispatch constants are the TPU's (the JAX module's, unchanged): the
# 16 MiB scoped-VMEM stack with headroom, the VMEM size, and the cap on the
# python-unrolled pipeline. They decide only which kernel and chunk a shape
# takes; a rule for this card's shared memory is still to be derived.
_SCOPED_VMEM_BUDGET = 14 * 1024 * 1024
_VMEM_BUDGET_BYTES = 96 * 1024 * 1024
_MAX_PIPELINE_CHUNKS = 32


def _first(shards) -> torch.Tensor:
    """The first band this process holds."""
    return next(s for row in shards for s in row if not isinstance(s, Remote))


def _pieces(shards, size):
    """The shards cut along the batch into pieces of ``size`` samples
    (contiguous views; a ``Remote`` band stays)."""
    B = _first(shards).shape[0]
    return [[[s if isinstance(s, Remote) else s[i:i + size] for s in row]
             for row in shards] for i in range(0, B, size)]


def _concat(outs):
    """Inverse of :func:`_pieces` on the per-piece results."""
    return [[outs[0][d][l] if isinstance(outs[0][d][l], Remote) else
             torch.cat([o[d][l] for o in outs], dim=0)
             for l in range(len(outs[0][d]))] for d in range(len(outs[0]))]


def _overlap_local_db(shards, kernel, chunk):
    """The double-buffered kernel over one piece of the batch."""
    return overlap_conv_db(shards, kernel, chunk)


def _overlap_local(shards, kernel):
    """Per-shard overlapped stencil; ``shards[d][l]`` is (B, C, H, W)
    float32. The rule of the JAX ``_overlap_local``: a batch that fits one
    VMEM mirror takes the single-shot kernel, a larger one the pipelined
    kernel with the largest chunk that fits, in pieces where the halo
    buffers of the whole batch would not fit."""
    B, C, H, W = _first(shards).shape
    O = kernel.shape[0]
    if kernel.shape[-2:] != (3, 3):
        raise ValueError("overlap kernel supports 3x3 only")
    if H < 2:
        raise ValueError("need at least 2 local rows")
    w_pad = -(-W // 128) * 128
    scratch_per_sample = (H * (C + O) + 4 * C) * w_pad * 4
    max_b = max(1, min(
        _SCOPED_VMEM_BUDGET // max(scratch_per_sample, 1),
        _VMEM_BUDGET_BYTES // max(scratch_per_sample, 1),
    ))
    if B > max_b:
        halo_per_sample = 4 * C * w_pad * 4
        per_chunk = 2 * H * (C + O) * w_pad * 4
        size = min(
            B,
            (_SCOPED_VMEM_BUDGET // 2) // max(halo_per_sample, 1),
            max(0, _SCOPED_VMEM_BUDGET - per_chunk)
            // max(halo_per_sample, 1),
        )
        chunk = 0
        if size > max_b:
            chunk = min(
                size,
                (_SCOPED_VMEM_BUDGET - halo_per_sample * size) // per_chunk,
            )
            size = min(size, _MAX_PIPELINE_CHUNKS * chunk)
            while chunk > 1:
                nck = -(-size // chunk)
                if (per_chunk * chunk
                        + halo_per_sample * nck * chunk) <= _SCOPED_VMEM_BUDGET:
                    break
                chunk -= 1
        if size > max_b and chunk >= 1:
            if size >= B:
                return _overlap_local_db(shards, kernel, min(chunk, B))
            return _concat([
                _overlap_local_db(p, kernel, min(chunk, _first(p).shape[0]))
                for p in _pieces(shards, size)
            ])
        n_chunks = -(-B // max_b)
        size = -(-B // n_chunks)
        return _concat([_overlap_local(p, kernel)
                        for p in _pieces(shards, size)])
    return overlap_conv(shards, kernel)


def overlapped_cyclic_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                             mesh: Mesh, data_axis: str | None = "data",
                             lat_axis_name: str = "lat") -> torch.Tensor:
    """3x3 cyclic conv of the lat bands of ``x`` with the neighbours' edge
    rows read inside the kernel; ``cyclic_conv2d(x, kernel,
    lat_mode='zero')`` in float32."""
    shards = split_shards(x.float(), mesh, data_axis, lat_axis_name)
    return join_shards(_overlap_local(shards, kernel.float()), x.device)

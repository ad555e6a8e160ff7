"""Plan helpers shared by the tensor-core kernels' wrappers
(``overlap_conv``, ``fused_conv_pool``): Hopper's limits, the card's SM
count and the ring of staging buffers a block keeps in shared memory."""

from __future__ import annotations

import functools

import torch

MAX_SMEM = 227 * 1024  # a block's shared memory on Hopper
TWO_PER_SM = 113 * 1024  # two blocks of this fit on one SM
MAX_GRID = 2 ** 31 - 1
N_SM = 132  # H100 SXM; the wrappers read the card's own count


@functools.cache
def sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def ring(x_bytes, w_bytes, nslab, keep_weights, budget):
    """(stages, shared-memory bytes, resident) of the first layout within
    ``budget``, the bytes a block may take beside the blocks that share its
    SM: weights of every slab resident (where ``keep_weights``) with 3 or 2
    stages of input rows, else 3 or 2 stages of both; else 2 stages of both
    if one block fits an SM; else None."""
    for resident in (True, False) if keep_weights else (False,):
        for stages in (3, 2):
            smem = stages * x_bytes + (nslab if resident else stages) * w_bytes
            if smem <= budget:
                return stages, smem, resident
    smem = 2 * (x_bytes + w_bytes)
    return (2, smem, False) if smem <= MAX_SMEM else None

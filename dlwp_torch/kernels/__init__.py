"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors (building it at first
use, see :mod:`dlwp_torch.kernels._build`) and takes the plain version for
CPU tensors. Each keeps a ``launches`` count of kernel launches, and each
call is a span ``kernel.<name>`` (:func:`dlwp_torch.utils.profiling.span`)
around its host work: checks, the launch plan and the launch. The
kernels of the forecast path, ``fused_conv_pool``, ``cyclic_conv`` and
``lstm_gates``, and the cube models' ``cube_pad`` are torch custom ops
(``torch.ops.dlwp_torch.*``), registered when this package is imported,
so that ``torch.export`` programs hold them.
"""

from dlwp_torch.kernels.barotropic_step import (
    barotropic_step,
    barotropic_step_plain,
)
from dlwp_torch.kernels.cube_pad import cube_pad
from dlwp_torch.kernels.cyclic_conv import cyclic_conv, cyclic_conv_plain
from dlwp_torch.kernels.fused_conv_pool import (
    fused_conv_pool,
    fused_conv_pool_plain,
)
from dlwp_torch.kernels.halo_exchange import halo_exchange, halo_exchange_plain
from dlwp_torch.kernels.lstm_gates import lstm_gates, lstm_gates_plain
from dlwp_torch.kernels.overlap_conv import (
    overlap_conv,
    overlap_conv_db,
    overlap_conv_plain,
)

WRAPPERS = {
    "fused_conv_pool": fused_conv_pool,
    "lstm_gates": lstm_gates,
    "barotropic_step": barotropic_step,
    "halo_exchange": halo_exchange,
    "overlap_conv": overlap_conv,
    "overlap_conv_db": overlap_conv_db,
    "cube_pad": cube_pad,
    "cyclic_conv": cyclic_conv,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = [
    "WRAPPERS",
    "barotropic_step",
    "barotropic_step_plain",
    "cube_pad",
    "cyclic_conv",
    "cyclic_conv_plain",
    "fused_conv_pool",
    "fused_conv_pool_plain",
    "halo_exchange",
    "halo_exchange_plain",
    "launch_counts",
    "lstm_gates",
    "lstm_gates_plain",
    "overlap_conv",
    "overlap_conv_db",
    "overlap_conv_plain",
    "reset_launch_counts",
]

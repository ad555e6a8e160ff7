"""Device milliseconds a train step in the traced window's NCCL kernels
(the gradient all-reduce of data parallelism) on rank 0's card."""

from h100bench import tracing


def read(ctx):
    steps = ctx["units"].get("steps")
    n, secs = tracing.kernel_time(ctx["trace"], "nccl")
    if not n or not steps:
        return None
    return 1e3 * secs / steps

"""Device resolution for the port's entry points.

Entry points (``DLWPNeuralNet``, ``TimeSeriesEstimator``,
``build_sequential``) run on ``cuda`` unless the caller passes
``device="cpu"``. Without a card they raise rather than carry on quietly on
the CPU. Putting work on the card also turns TF32 off for convolutions and
matrix products: the JAX reference is full fp32, and cuDNN would otherwise
run fp32 convolutions in TF32 (about three decimal digits).
"""

from __future__ import annotations

import contextlib
import functools

import torch

# The list :func:`keep_cached` fills, while one is open.
_kept: list | None = None


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dlwp_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def tensor_cache(maxsize: int):
    """``functools.lru_cache`` for functions that build tensors (index
    tables, spectral engines), which a trace bypasses: while
    ``torch.export`` or ``torch.compile`` traces, the function builds a new
    one, so a traced (fake) tensor never reaches the cache and no later
    eager call gets it back. Inside :func:`keep_cached` every value it
    returns is also kept in that block's list."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if torch.compiler.is_compiling():
                return fn(*args)
            out = cached(*args)
            if _kept is not None:
                _kept.append(out)
            return out

        call.cache_clear = cached.cache_clear
        return call

    return wrap


@contextlib.contextmanager
def keep_cached(into: list):
    """Append to ``into`` every value that a :func:`tensor_cache` function
    returns inside the block. A CUDA graph captured inside reads those
    tensors by address, so its owner keeps them past their eviction from
    the cache."""
    global _kept
    outer, _kept = _kept, into
    try:
        yield into
    finally:
        _kept = outer

"""Device resolution for the port's entry points.

Entry points (``DLWPNeuralNet``, ``TimeSeriesEstimator``,
``build_sequential``) run on ``cuda`` unless the caller passes
``device="cpu"``. Without a card they raise rather than carry on quietly on
the CPU. Putting work on the card also turns TF32 off for convolutions and
matrix products: the JAX reference is full fp32, and cuDNN would otherwise
run fp32 convolutions in TF32 (about three decimal digits).
"""

from __future__ import annotations

import functools

import torch


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
    eager call gets it back."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if torch.compiler.is_compiling():
                return fn(*args)
            return cached(*args)

        call.cache_clear = cached.cache_clear
        return call

    return wrap

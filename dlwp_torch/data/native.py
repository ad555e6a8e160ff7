"""The native (C) batch gather of the series sampler (port of
``dlwp_tpu.data.native``).

``out[b, t, c] = series[samples[b] + offsets[t], chan_idx[c]]`` is the
host's hot loop in ``fit_generator``: :func:`assemble` runs it as row
``memcpy``s over a pthread pool (``dlwp_torch/csrc/batch_assembler.c``, a
plain C interface called through ``ctypes``, which releases the GIL for
the call). The library is built at first use by the host C compiler into
``dlwp_torch/kernels/_build/`` (:mod:`dlwp_torch.kernels._build`).

Routing is by applicability, as in the JAX package: a 4-D, C-contiguous,
float32 numpy series takes the native gather, anything else
:func:`assemble_plain`. Where no C compiler exists, :func:`have_native` is
False and every call takes :func:`assemble_plain` (the JAX package does
the same where its extension cannot be built). A compiler that is found
but fails raises with its log. ``assemble.launches`` counts the native
calls.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dlwp_torch.kernels import _build

_NAME = "batch_assembler"
_ERRORS = {1: (IndexError, "sample index out of range"),
           2: (IndexError, "channel index out of range"),
           3: (RuntimeError, "could not start a gather thread")}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _lib() -> ctypes.CDLL:
    """The loaded gather library, built first if needed (raises with the
    compiler's log if the build fails)."""
    lib = _build.load(_NAME)
    if lib.dlwp_assemble.argtypes is None:
        lib.dlwp_assemble.argtypes = [_P, _I64, _I64, _I64, _P, _I64, _P,
                                      _I64, _P, _I64, _P, ctypes.c_int]
        lib.dlwp_assemble.restype = ctypes.c_int
    return lib


def have_native() -> bool:
    """Whether the native gather can run here: its library is loaded or
    built, or a C compiler exists to build it."""
    return (_NAME in _build._LOADED or _build.library_path(_NAME).exists()
            or _build.cc_path() is not None)


def assemble_plain(series, samples, offsets, chan_idx) -> np.ndarray:
    """The numpy version: fancy-index the rows, then the channels."""
    idx = (np.asarray(samples, dtype=np.int64)[:, None]
           + np.asarray(offsets, dtype=np.int64)[None, :])
    return np.asarray(series)[idx][:, :, np.asarray(chan_idx, dtype=np.int64)]


def assemble(series, samples, offsets, chan_idx,
             n_threads: int = 4) -> np.ndarray:
    """``out[b, t, c] = series[samples[b] + offsets[t], chan_idx[c]]``,
    (B, T, C, H, W): the native threaded gather for a contiguous float32
    (N, V, H, W) numpy series where :func:`have_native`, else
    :func:`assemble_plain`."""
    samples = np.ascontiguousarray(samples, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    chan_idx = np.ascontiguousarray(chan_idx, dtype=np.int64)
    if not (isinstance(series, np.ndarray) and series.dtype == np.float32
            and series.flags.c_contiguous and series.ndim == 4
            and have_native()):
        return assemble_plain(series, samples, offsets, chan_idx)
    N, V, H, W = series.shape
    rows = samples[:, None] + offsets[None, :]
    if rows.size and (rows.min() < 0 or rows.max() >= N):
        raise IndexError(f"sample index out of range [0, {N})")
    if chan_idx.size and (chan_idx.min() < 0 or chan_idx.max() >= V):
        raise IndexError(f"channel index out of range [0, {V})")
    out = np.empty((len(samples), len(offsets), len(chan_idx), H, W),
                   dtype=np.float32)
    err = _lib().dlwp_assemble(
        series.ctypes.data, N, V, H * W, samples.ctypes.data, len(samples),
        offsets.ctypes.data, len(offsets), chan_idx.ctypes.data,
        len(chan_idx), out.ctypes.data, int(n_threads))
    if err:
        kind, what = _ERRORS.get(err, (RuntimeError, f"error {err}"))
        raise kind(f"native gather: {what}")
    assemble.launches += 1
    return out


assemble.launches = 0

__all__ = ["assemble", "assemble_plain", "have_native"]

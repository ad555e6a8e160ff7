"""Exported programs for serving (port of ``dlwp_tpu.serve``).

The deployable unit is the exported program, not the weight file: this
module exports a model's autoregressive rollout with ``torch.export`` --
weights and tables baked in as constants, the batch axis symbolic (one
artifact serves any batch size) -- plus the host-side scaler / imputer
state, in one self-contained file. A program exported on a CPU host runs
on the card once loaded there: the hand kernels are torch custom ops
(``dlwp_torch::fused_conv_pool``, ``dlwp_torch::lstm_gates``), so the
program holds their nodes, and loading moves every weight, constant and
device argument to the serving device.

Typical flow::

    net.fit(...)                                          # build host
    servable = export_rollout(net, x, 24, path="fc.dlwpserve")
    ...
    servable = Servable.load("fc.dlwpserve")              # serving card
    forecast = servable.predict_timeseries(predictors)    # no model code

``Servable.call`` runs the raw exported program; ``predict_timeseries``
also applies the saved imputer / scaler and the reference's output
shaping, as :meth:`dlwp_torch.models.DLWPNeuralNet.predict_timeseries`
does.

The container is the JAX package's layout (magic, then three
length-prefixed parts: JSON metadata, the program, the pickled host state)
under this package's own magic: a ``jax.export`` artifact is refused.

Security note: the container embeds the scaler / imputer via pickle, and
``torch.export.load`` reads the program with pickle too: load artifacts
only from trusted sources.
"""

from __future__ import annotations

import functools
import inspect
import io
import json
import math
import pickle
import struct

import numpy as np
import torch
from torch.export import Dim
from torch.export.passes import move_to_device_pass

# Registers the custom ops an exported program calls.
import dlwp_torch.kernels  # noqa: F401
from dlwp_torch.device import resolve_device
from dlwp_torch.models.api import shape_series

_MAGIC = b"DLWPTORCH\x01"
# The JAX package's container (StableHLO programs): refused by name.
_JAX_MAGIC = b"DLWPSERVE\x01"
_FORMAT_VERSION = 1


def _pack(meta: dict, blob: bytes, state: bytes) -> bytes:
    head = json.dumps(meta).encode("utf-8")
    out = io.BytesIO()
    out.write(_MAGIC)
    for part in (head, blob, state):
        out.write(struct.pack("<Q", len(part)))
        out.write(part)
    return out.getvalue()


def _unpack(data: bytes) -> tuple[dict, bytes, bytes]:
    if data.startswith(_JAX_MAGIC):
        raise ValueError(
            "a dlwp_tpu servable artifact (jax.export StableHLO; its magic "
            "is not dlwp_torch's): export the model with dlwp_torch.serve")
    if not data.startswith(_MAGIC):
        raise ValueError("not a dlwp_torch servable artifact (bad magic)")
    off = len(_MAGIC)
    parts = []
    for _ in range(3):
        if off + 8 > len(data):
            raise ValueError("truncated servable artifact")
        (n,) = struct.unpack_from("<Q", data, off)
        off += 8
        if off + n > len(data):
            raise ValueError("truncated servable artifact")
        parts.append(data[off:off + n])
        off += n
    meta = json.loads(parts[0].decode("utf-8"))
    if meta.get("format_version", 0) > _FORMAT_VERSION:
        raise ValueError(
            f"servable format v{meta['format_version']} is newer than this "
            f"dlwp_torch (v{_FORMAT_VERSION})"
        )
    return meta, parts[1], parts[2]


def _bake(program) -> None:
    """Give an exported program its own copies of its weights and
    constants (export shares the model's storage, which later training
    would change), one copy for entries that view the same data, none of
    them requiring grad: a servable records no gradient, and the
    conv-pool op refuses operands that require one."""
    copies = {}
    for table in (program.state_dict, program.constants):
        for key, value in table.items():
            if not isinstance(value, torch.Tensor):
                continue
            view = (value.untyped_storage().data_ptr(),
                    value.storage_offset(), tuple(value.shape),
                    value.stride(), value.dtype, value.device)
            if view not in copies:
                copies[view] = value.detach().clone()
            table[key] = (torch.nn.Parameter(copies[view], requires_grad=False)
                          if isinstance(value, torch.nn.Parameter)
                          else copies[view])


class Servable:
    """A deserialized exported program plus its host-side metadata.

    ``call`` runs the program (a ``torch.export`` ``ExportedProgram``'s
    module) on :attr:`device`, after checking the inputs against
    :attr:`in_specs`. Rollout servables also give
    :meth:`predict_timeseries` with the host pre- and post-processing.
    """

    def __init__(self, program, meta: dict, host_state: dict | None = None,
                 device=None):
        self._program = program
        self._module = program.module()
        self.meta = dict(meta)
        self._host = host_state or {}
        self.device = torch.device(device or self.meta["device"])
        self.meta["device"] = str(self.device)

    # ------------------------------------------------------------ execution
    def call(self, *args):
        """Run the raw exported program on :attr:`device`; raises
        ``ValueError`` on inputs that do not fit :attr:`in_specs`."""
        specs = self.in_specs
        if len(args) != len(specs):
            raise ValueError(f"servable takes {len(specs)} inputs, got "
                             f"{len(args)}")
        tensors, batch = [], {}
        lo, hi = self.meta["batch_range"]
        for i, (a, (shape, dtype)) in enumerate(zip(args, specs)):
            t = torch.as_tensor(a, device=self.device)
            if str(t.dtype).removeprefix("torch.") != dtype or (
                    t.dim() != len(shape)):
                raise ValueError(
                    f"input {i}: expected {dtype} of shape {shape}, got "
                    f"{t.dtype} of shape {tuple(t.shape)}")
            for axis, (want, got) in enumerate(zip(shape, t.shape)):
                if isinstance(want, str):
                    batch.setdefault(want, got)
                    ok = (batch[want] == got and got >= lo
                          and (hi is None or got <= hi))
                else:
                    ok = want == got
                if not ok:
                    raise ValueError(
                        f"input {i}: axis {axis} is {got}, the program "
                        f"takes {want} ({self.meta['batch']!r} in "
                        f"[{lo}, {hi}], the same for every batched input)")
            tensors.append(t)
        with torch.no_grad():
            return self._module(*tensors)

    def predict_timeseries(self, predictors, keep_time_dim: bool = False):
        """Scaled-and-shaped rollout, as
        ``DLWPNeuralNet.predict_timeseries``: imputer, scaler, the program,
        the target scaler's inverse, then :func:`shape_series`."""
        if self.meta.get("kind") != "rollout":
            raise ValueError(
                "this servable was not exported with export_rollout()"
            )
        x = np.asarray(predictors)
        imputer = self._host.get("imputer")
        if imputer is not None:
            x = imputer.transform(x)
        scaler = self._host.get("scaler")
        if scaler is not None:
            x = scaler.transform(x)
        dtype = getattr(torch, self.meta.get("dtype", "float32"))
        ts = self.call(torch.as_tensor(np.asarray(x), dtype=dtype))
        ts = ts.cpu().numpy()
        scaler_y = self._host.get("scaler_y")
        if scaler_y is not None and self.meta.get("scale_targets", True):
            ts = scaler_y.inverse_transform(ts)
        return shape_series(
            ts,
            self.meta["time_dim"],
            tuple(self.meta["feature_shape"]),
            step_sequence=self.meta["step_sequence"],
            keep_time_dim=keep_time_dim,
        )

    # ---------------------------------------------------------- inspection
    @property
    def in_specs(self) -> tuple:
        """``((shape, dtype), ...)`` of the inputs; a batch axis appears as
        its name (``meta['batch']``), within ``meta['batch_range']``."""
        return tuple((tuple(shape), dtype)
                     for shape, dtype in self.meta["inputs"])

    @property
    def program(self):
        """The ``torch.export`` ``ExportedProgram``."""
        return self._program

    def __repr__(self):
        return (
            f"Servable(kind={self.meta.get('kind')!r}, "
            f"device={str(self.device)!r}, in={self.in_specs})"
        )

    # --------------------------------------------------------- persistence
    def serialize(self) -> bytes:
        meta = dict(self.meta)
        meta["format_version"] = _FORMAT_VERSION
        blob = io.BytesIO()
        torch.export.save(self._program, blob)
        return _pack(meta, blob.getvalue(), pickle.dumps(self._host))

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())

    @classmethod
    def load(cls, path_or_bytes, device=None) -> "Servable":
        """Read an artifact and put its program on ``device`` (default
        ``cuda``: raises without a card unless ``device='cpu'``): every
        weight, constant and device argument moves there, so a program
        exported on a CPU host runs on the card."""
        dev = resolve_device(device)
        if isinstance(path_or_bytes, (bytes, bytearray)):
            data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()
        meta, blob, state = _unpack(data)
        program = torch.export.load(io.BytesIO(blob))
        if torch.device(meta["device"]) != dev:
            program = move_to_device_pass(program, dev)
        return cls(program, meta, pickle.loads(state), device=dev)


def _closure_modules(fn) -> list:
    """The modules a function holds in its closure (a rollout's model)."""
    fn = inspect.unwrap(fn)
    if isinstance(fn, functools.partial):
        return _closure_modules(fn.func)
    cells = getattr(fn, "__closure__", None) or ()
    return [c.cell_contents for c in cells
            if isinstance(c.cell_contents, torch.nn.Module)]


class _Program(torch.nn.Module):
    """A function as a module to export; its ``forward`` runs the function
    undecorated (the rollouts' ``inference_mode``, which export does not
    trace, is taken off) under ``torch.no_grad()``. The modules in the
    function's closure are submodules, so their parameters enter the
    program once, as parameters, and not once a use, as constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn
        for i, module in enumerate(_closure_modules(fn)):
            self.add_module(f"closure_{i}", module)

    def forward(self, *args):
        with torch.no_grad():
            return inspect.unwrap(self.fn)(*args)


def export_program(
    fn_or_module,
    example_args,
    *,
    batch="b",
    batched=(0,),
    meta: dict | None = None,
    host_state: dict | None = None,
) -> Servable:
    """Export a function or module of tensors as a :class:`Servable`.

    ``example_args``: tensors on the device the program is exported on.
    ``batched``: the positions of the inputs whose axis 0 is the batch
    (default: the first input alone); every other input keeps its
    example's shape. No input is taken as batched from its length.
    ``batch``: a name (default ``"b"``: a ``torch.export.Dim`` of that name
    on axis 0 of every batched input, so the program takes any batch
    size), a ``Dim`` (for bounds), an int (the batch the examples must
    have) or ``None`` (the examples' shapes). A symbolic batch is traced
    at 2 or more: export would specialise a size of 0 or 1, so a smaller
    example is refused.
    """
    args = tuple(example_args)
    if not args or not all(isinstance(a, torch.Tensor) for a in args):
        raise TypeError("export_program takes a non-empty tuple of tensors")
    dim = Dim(batch) if isinstance(batch, str) else batch
    positions = [] if dim is None else sorted(set(batched))
    if dim is not None and not (
            positions and all(0 <= i < len(args) and args[i].dim() > 0
                              for i in positions)):
        raise ValueError(f"batched={tuple(batched)}: positions of inputs "
                         f"with an axis 0 among the {len(args)}, at least one")
    is_batched = [i in positions for i in range(len(args))]
    sizes = {int(args[i].shape[0]) for i in positions}
    if len(sizes) > 1:
        raise ValueError(f"the batched inputs' axis 0 differ: {sorted(sizes)}")
    n = sizes.pop() if sizes else None
    if isinstance(dim, int) and n != dim:
        raise ValueError(f"example batch {n} differs from batch={dim}")
    dynamic = isinstance(dim, Dim)
    if dynamic and n < 2:
        raise ValueError(f"example batch {n}: trace a symbolic batch at 2 or "
                         f"more (export specialises a size of 0 or 1), or "
                         f"pin it with batch={n}")
    shapes = tuple({0: dim} if b and dynamic else None for b in is_batched)
    module = _Program(fn_or_module)
    with torch.no_grad():
        program = torch.export.export(module, args, dynamic_shapes=(shapes,))
    _bake(program)
    name = dim.__name__ if dynamic else None
    lo = hi = None
    if dynamic:
        # The range export gave the batch symbol (a bound may come from a
        # guard of the traced code).
        user = program.graph_signature.user_inputs[positions[0]]
        node = next(n for n in program.graph.nodes if n.name == user)
        vr = program.range_constraints[node.meta["val"].shape[0].node.expr]
        lo, hi = (float(v) for v in (vr.lower, vr.upper))
        lo, hi = int(lo), (int(hi) if math.isfinite(hi) else None)
    inputs = [[[name if b and dynamic and i == 0 else int(s)
                for i, s in enumerate(a.shape)],
               str(a.dtype).removeprefix("torch.")]
              for a, b in zip(args, is_batched)]
    meta = dict(meta or {"kind": "custom"})
    meta.update(inputs=inputs, batch=name if dynamic else dim,
                batch_range=[lo, hi], device=str(args[0].device))
    return Servable(program, meta, host_state, device=args[0].device)


def export_rollout(
    dlwp,
    example_predictors,
    time_steps: int,
    *,
    step_sequence: bool = False,
    batch="b",
    path: str | None = None,
) -> Servable:
    """Export a trained model's autoregressive rollout as a servable.

    Args:
        dlwp: a ``DLWPNeuralNet`` / ``DLWPFunctional`` with parameters.
        example_predictors: an example (unscaled) predictor batch; only its
            shape is used. The program runs in float32 on the model's
            device.
        time_steps: forecast steps, as in ``predict_timeseries``.
        step_sequence: sliding-window feedback.
        batch: the exported batch axis: a name (default ``"b"``: any batch
            size), an int to pin it, or ``None`` to keep the example's.
        path: if given, also write the artifact to this file.
    """
    fn, n_iter = dlwp.rollout_fn(time_steps, step_sequence)
    x = np.asarray(example_predictors)
    feature_shape = x.shape[2:] if dlwp.is_recurrent else x.shape[1:]
    lead = x.shape[1:2] if dlwp.is_recurrent else ()
    if batch is None:
        b = x.shape[0]
    elif isinstance(batch, int):
        b = batch
    else:
        # A symbolic axis is traced at 2 or more: export would specialise
        # a size of 0 or 1.
        b = max(2, x.shape[0])
    example = torch.zeros((b,) + lead + tuple(feature_shape),
                          dtype=torch.float32, device=dlwp.device)
    meta = {
        "kind": "rollout",
        "time_dim": dlwp.time_dim,
        "is_recurrent": dlwp.is_recurrent,
        "n_iter": n_iter,
        "time_steps": int(time_steps),
        "step_sequence": bool(step_sequence),
        "feature_shape": list(feature_shape),
        "scale_targets": bool(dlwp.scale_targets),
        "dtype": "float32",
    }
    host_state = {
        "scaler": dlwp.scaler,
        "scaler_y": dlwp.scaler_y if dlwp.scale_targets else None,
        "imputer": dlwp.imputer if dlwp.impute else None,
    }
    servable = export_program(fn, (example,), batch=batch, meta=meta,
                              host_state=host_state)
    if path is not None:
        servable.save(path)
    return servable


def export_barotropic(
    model,
    n_snapshots: int,
    snapshot_every: int,
    *,
    batch=None,
    path: str | None = None,
) -> Servable:
    """Export a barotropic integration (z0 -> height snapshots).

    The servable maps an initial height field ``(..., nlat, nlon)`` to
    ``(n_snapshots, ..., nlat, nlon)`` snapshots with the plain engine's
    steps and spectral tables in the program. ``batch``: ``None`` exports
    the single-member shape, a name (e.g. ``"b"``) makes the member axis
    symbolic, an int pins it. Requires ``step_impl='plain'``: the fused
    step kernel's wrapper is not an exportable op.
    """
    if getattr(model, "step_impl", "plain") != "plain":
        raise ValueError(
            "export_barotropic requires step_impl='plain' (the fused step "
            "kernel is not registered as an op a program can hold)"
        )
    J, L = model.grid.nlat, model.grid.nlon

    def fn(z0):
        state = model.from_z(z0)
        _, _, zs = model.run_with_snapshots(state, n_snapshots,
                                            snapshot_every)
        return zs

    if batch is None:
        shape = (J, L)
    elif isinstance(batch, int):
        shape = (batch, J, L)
    else:
        shape = (2, J, L)  # traced at 2: export would specialise 0 or 1
    meta = {
        "kind": "barotropic",
        "n_snapshots": int(n_snapshots),
        "snapshot_every": int(snapshot_every),
        "dt": float(model.dt),
        "truncation": int(model.truncation),
        "grid": [int(J), int(L)],
        "spectral_mode": model.spectral_mode,
    }
    example = torch.zeros(shape, dtype=torch.float32, device=model.device)
    servable = export_program(fn, (example,), batch=batch, meta=meta)
    if path is not None:
        servable.save(path)
    return servable


__all__ = ["Servable", "export_barotropic", "export_program",
           "export_rollout"]

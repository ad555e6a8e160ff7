"""Compile-check entry point (port of ``__graft_entry__.entry``).

``entry()`` returns the flagship model's forward step and its example
arguments: the canonical DLWP CNN (ConvLSTM front end and the
conv-pool-upsample tower, :mod:`dlwp_torch.flagship`) at the 2.5-degree
grid with the northern-hemisphere crop, 36x144, B=8. Exporting it with
:func:`dlwp_torch.serve.export_program` is the port's compile check::

    python -m dlwp_torch.entry          # on the card; --device cpu here

The JAX package's ``dryrun_multichip`` (a sharded training step over a
mesh of several devices) is not ported yet: it needs the longitude tiles
and the sharded backward (ROADMAP.md section 1, item 6).
"""

from __future__ import annotations

import functools

import torch

from dlwp_torch.device import resolve_device
from dlwp_torch.flagship import convlstm_specs
from dlwp_torch.models.cnn import build_sequential


def entry(device=None):
    """``(forward, (params, x))``: ``forward(params, x)`` runs the flagship
    (random weights from seed 0) with the parameters ``params`` (a name ->
    tensor dict) under ``torch.no_grad()``; ``x`` is a zero batch of 8,
    (8, 2, 3, 36, 144): two time steps of two channels and insolation."""
    dev = resolve_device(device)
    x = torch.zeros((8, 2, 3, 36, 144), device=dev)
    model = build_sequential(convlstm_specs(), device=dev)
    model.init(x[:1], seed=0)
    params = dict(model.named_parameters())

    def forward(params, x):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (x,))

    return forward, (params, x)


def main(argv=None) -> int:
    import argparse

    from dlwp_torch.serve import export_program

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    forward, (params, x) = entry(args.device)
    servable = export_program(functools.partial(forward, params), (x,))
    out = servable.call(x)
    print("entry OK:", tuple(out.shape), servable)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python
"""Distributed (dp x sp) training workflow.

Demonstrates the parallelism the reference lacked entirely: a 2-D (data,
lat) mesh with batch sharding for data parallelism and latitude-band
activation sharding for spatial decomposition. The port is one program
over the mesh: activations stay whole on the model's device between
layers and each sharded conv exchanges its bands' halo rows.

Flags as in the JAX package's script, plus ``--device``. ``--virtual N``
makes the mesh N entries that repeat the chosen device (``[cpu] * N`` on
the CPU, ``[cuda:0] * N`` on a card), the port's counterpart of the JAX
script's virtual CPU devices; without it the mesh spans every card (or
the one CPU). For several processes, start them under ``torchrun`` and
call ``dlwp_torch.parallel.distributed.initialize_distributed`` first.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--virtual", type=int, default=0,
                   help="a mesh of N entries repeating the device, for a "
                        "dry run")
    p.add_argument("--data-shards", type=int, default=-1)
    p.add_argument("--lat-shards", type=int, default=1)
    p.add_argument("--predictor-file", default=None)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    """Train on the mesh; returns ``(model, history)``."""
    args = parse_args(argv)
    import torch

    from dlwp_torch.data import SeriesSampler
    from dlwp_torch.device import resolve_device
    from dlwp_torch.examples._synthetic import load_or_synthetic
    from dlwp_torch.models import DLWPNeuralNet
    from dlwp_torch.parallel import MeshConfig, build_mesh

    device = resolve_device(args.device)
    if args.virtual:
        devices = [device] * args.virtual
    elif device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    print(f"devices: {len(devices)}")
    mesh = build_mesh(
        MeshConfig(data=args.data_shards, lat=args.lat_shards),
        devices=devices,
    )
    print(f"mesh: {dict(mesh.shape)}")

    data = load_or_synthetic(args.predictor_file, note=None)

    dlwp = DLWPNeuralNet(time_dim=1, scaler_type=None,
                         device=mesh.local_devices()[0])
    sampler = SeriesSampler(data, model=dlwp, batch_size=args.batch_size,
                            shuffle=True)
    c = sampler.convolution_shape[0]
    # With lat shards, the batch_spec also shards latitude bands and every
    # spherical conv switches onto the halo-exchange path
    # (dlwp_torch.parallel.spatial); with lat=1 this is plain data
    # parallelism.
    spec = (
        ("data", None, "lat", None) if mesh.shape["lat"] > 1 else ("data",)
    )
    dlwp.build_model(
        [("CyclicConv2D", (32, 3), {"activation": "tanh"}),
         ("CyclicConv2D", (64, 3), {"activation": "tanh"}),
         ("CyclicConv2D", (c, 3), {})],
        mesh=mesh,
        batch_spec=spec,
    )
    if dlwp._spatial is not None:
        print(f"spatial sharding: {mesh.shape['lat']} lat bands "
              f"({dlwp._spatial.impl})")
    t0 = time.time()
    history = dlwp.fit_generator(sampler, epochs=args.epochs, verbose=True)
    print(f"Train time -- {time.time() - t0:.0f} seconds")
    return dlwp, history


if __name__ == "__main__":
    main()

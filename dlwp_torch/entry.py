"""Driver entry points (port of ``__graft_entry__``): a compile check and
a multi-device dry run.

``entry()`` returns the flagship model's forward step and its example
arguments: the canonical DLWP CNN (ConvLSTM front end and the
conv-pool-upsample tower, :mod:`dlwp_torch.flagship`) at the 2.5-degree
grid with the northern-hemisphere crop, 36x144, B=8. Exporting it with
:func:`dlwp_torch.serve.export_program` is the port's compile check.
``dryrun_multichip(n)`` trains dp x sp sharded models for one epoch on
tiny shapes over an n-entry mesh and runs the sharded spectral and
barotropic cores. ``train_distributed()`` is the multi-process run: under
``torchrun``, each process joins the group, builds a mesh whose data axis
spans the processes and whose lat axis lies on its own card (or, with
``--lat-across``, a lat axis of one band a process), and takes a few
flagship train steps::

    python -m dlwp_torch.entry              # on the card; --device cpu here
    python -m dlwp_torch.entry --dryrun 8   # 8 mesh entries over the cards
    torchrun --nproc_per_node N -m dlwp_torch.entry --distributed
    torchrun --nproc_per_node N -m dlwp_torch.entry --distributed \
        --lat-across
"""

from __future__ import annotations

import functools
import json

import numpy as np
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


def dryrun_multichip(n_devices: int, devices=None) -> dict[str, float]:
    """One epoch of dp x sp sharded training over an ``n_devices``-entry
    mesh, through the integrated path (``DLWPNeuralNet.build_model(mesh,
    batch_spec)`` attaches a ``SpatialSharding`` to every spherical conv,
    'ppermute' impl), then a sharded rollout, the free-function sharded
    conv, the sharded spectral transforms and barotropic steps, a
    lat-sharded ConvLSTM trained with a ``target_spec`` and, when
    ``n_devices % 4 == 0``, a (data, lat, lon) tile mesh. Step for step
    ``__graft_entry__.dryrun_multichip``.

    ``devices``: the mesh entries, default every CUDA device; give a list
    that repeats a device (``[torch.device("cuda", 0)] * 8``, or the CPU)
    to run more entries than there are cards. The models live on the first
    entry. Returns each fit's last loss, all finite."""
    from dlwp_torch.grid import LatLonGrid
    from dlwp_torch.models.api import DLWPNeuralNet
    from dlwp_torch.ops.losses import latitude_weighted_loss, mse
    from dlwp_torch.parallel import (
        MeshConfig,
        ShardedBarotropicModel,
        ShardedSphericalHarmonics,
        build_mesh,
        sharded_cyclic_conv2d,
    )
    from dlwp_torch.spectral import SphericalHarmonics

    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if len(devices) < n_devices:
        raise ValueError(f"{n_devices} mesh entries need as many devices, "
                         f"got {len(devices)}")
    devices = devices[:n_devices]
    dev = devices[0]
    lat_shards = 2 if n_devices % 2 == 0 else 1
    mesh = build_mesh(MeshConfig(data=n_devices // lat_shards,
                                 lat=lat_shards), devices=devices)

    # Tiny shapes: 16-lat x 32-lon grid, batch 2 per data shard. Equal
    # in/out channels so the autoregressive rollout can feed back.
    nlat, nlon, c, time_dim = 16, 32, 2, 2
    c_in = c_out = time_dim * c
    batch = 2 * mesh.shape["data"]
    x = np.random.RandomState(0).randn(batch, c_in, nlat, nlon) \
        .astype(np.float32)
    y = np.random.RandomState(1).randn(batch, c_out, nlat, nlon) \
        .astype(np.float32)
    lats = np.linspace(88.75, -88.75, nlat)
    losses = {}

    def fitted(net, name, xs, ys):
        hist = net.fit(xs, ys, epochs=1, batch_size=len(xs), verbose=False)
        losses[name] = float(hist.history["loss"][-1])
        assert np.isfinite(losses[name]), f"non-finite loss in {name}"

    dlwp = DLWPNeuralNet(scaler_type=None, device=dev)
    dlwp.build_model(
        [
            ("CyclicConv2D", (16, 3), {"activation": "tanh"}),
            ("MaxPooling2D", (2,), None),
            ("CyclicConv2D", (32, 3), {"activation": "tanh"}),
            ("UpSampling2D", (2,), None),
            ("CyclicConv2D", (c_out, 3), {"activation": "linear"}),
        ],
        loss=latitude_weighted_loss(mse, lats),
        mesh=mesh,
        batch_spec=("data", None, "lat", None),
    )
    if lat_shards > 1:
        assert dlwp._spatial is not None  # integrated spatial path active
        assert dlwp.base_model.layers[0].spatial is dlwp._spatial
    fitted(dlwp, "dp x sp", x, y)
    # Lat-sharded autoregressive rollout.
    ts = dlwp.predict_timeseries(x[:batch], 2)
    assert np.isfinite(ts).all()

    # The free-function sharded conv, and the sharded spectral transposes
    # and barotropic core (the other distribution mechanism).
    k = np.random.RandomState(2).randn(4, c_in, 3, 3).astype(np.float32) * 0.1
    out = sharded_cyclic_conv2d(torch.from_numpy(x).to(dev),
                                torch.from_numpy(k).to(dev), mesh)
    assert torch.isfinite(out).all()

    if lat_shards > 1:
        grid = LatLonGrid.gaussian(16, 32)
        sh = SphericalHarmonics.build(grid, 7, dtype=torch.float32,
                                      device=dev)
        ssh = ShardedSphericalHarmonics(sh, mesh)
        f = torch.from_numpy(np.random.RandomState(3).randn(16, 32)
                             .astype(np.float32)).to(dev)
        back = ssh.synthesize(ssh.analyze(f))
        assert torch.isfinite(back).all()

        T = 2 * lat_shards - 1  # T+1 divisible by the lat axis
        bt = ShardedBarotropicModel(
            grid, T, mesh=mesh, dt=1800.0, damping_coefficient=1e-4,
            dtype=torch.float32, device=dev)
        lat_r = np.radians(grid.lat)[:, None]
        lon_r = np.radians(grid.lon)[None, :]
        z0 = (5500.0 - 300.0 * np.sin(lat_r) ** 2
              + 60.0 * np.cos(lat_r) ** 3 * np.cos(3 * lon_r))
        st = bt.from_z(torch.from_numpy(
            np.broadcast_to(z0, (16, 32)).astype(np.float32)).to(dev))
        out_st = bt.run_sharded(st, 3)
        assert torch.isfinite(out_st.vrt_spec).all()

    # Lat-sharded ConvLSTM train step: the recurrent state (h, c) carries
    # the latitude bands through the time loop while both the input and
    # the recurrent convs run the sharded halo exchange.
    dlwp_r = DLWPNeuralNet(scaler_type=None, is_recurrent=True,
                           time_dim=time_dim, device=dev)
    dlwp_r.build_model(
        [
            ("ConvLSTM2D", (8, 3),
             {"return_sequences": True, "activation": "tanh"}),
            ("Reshape", ((time_dim * 8, nlat, nlon),), None),
            ("CyclicConv2D", (c_out, 3), {"activation": "linear"}),
        ],
        loss=latitude_weighted_loss(mse, lats),
        mesh=mesh,
        batch_spec=("data", None, None, "lat", None),
        target_spec=("data", None, "lat", None),
    )
    if lat_shards > 1:
        assert dlwp_r._spatial is not None
        assert dlwp_r.base_model.layers[0].spatial is dlwp_r._spatial
    xr = np.random.RandomState(4).randn(batch, time_dim, c, nlat, nlon) \
        .astype(np.float32)
    fitted(dlwp_r, "convlstm", xr, y)

    # 2-D (lat x lon) tiles: the periodic longitude boundary as a cyclic
    # ring, trained through the integrated model path on a 3-D mesh.
    if n_devices % 4 == 0:
        mesh3 = build_mesh(MeshConfig(data=n_devices // 4, lat=2, lon=2),
                           devices=devices)
        dlwp3 = DLWPNeuralNet(scaler_type=None, device=dev)
        dlwp3.build_model(
            [("CyclicConv2D", (8, 3), {"activation": "tanh"}),
             ("CyclicConv2D", (c_out, 3), {"activation": "linear"})],
            loss=latitude_weighted_loss(mse, lats),
            mesh=mesh3,
            batch_spec=("data", None, "lat", "lon"),
        )
        assert dlwp3._spatial is not None and dlwp3._spatial.lon_axis == "lon"
        b3 = 2 * mesh3.shape["data"]
        fitted(dlwp3, "data x lat x lon", x[:b3], y[:b3])
    return losses


def train_distributed(device=None, lat_across: bool = False) -> dict:
    """3 train steps of the flagship (36x144, random weights and batches
    from seed 0, 8 samples a process) with data parallelism across
    processes: joins the process group from ``torchrun``'s environment
    (:func:`~dlwp_torch.parallel.distributed.initialize_distributed`), puts
    2 lat bands on the process's card (``cuda:LOCAL_RANK``, repeated; the
    CPU for ``device="cpu"``), and builds the mesh with
    :func:`~dlwp_torch.parallel.distributed.multihost_mesh` (data across
    processes). With ``lat_across``, the mesh is ``MeshConfig(data=1,
    lat=-1)`` instead: one lat band a process, every process on the same
    8 samples, the overlap kernels reading the neighbours' edge rows over
    CUDA IPC. Returns this process's rank, backend, losses, ms a step and
    a checksum of the parameters (equal on every rank)."""
    import os
    import time

    from dlwp_torch.parallel import MeshConfig
    from dlwp_torch.parallel.distributed import (
        initialize_distributed,
        multihost_mesh,
        process_count,
        process_index,
    )
    from dlwp_torch.train import TrainConfig, Trainer
    from dlwp_torch.parallel.spatial import SpatialSharding

    dev = resolve_device(device)
    initialize_distributed(device=dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    n, steps, lat = process_count(), 3, 2
    if lat_across:
        mesh = multihost_mesh(MeshConfig(data=1, lat=-1), devices=[dev])
    else:
        mesh = multihost_mesh(MeshConfig(data=n, lat=lat),
                              devices=[dev] * lat)
    spatial = SpatialSharding(mesh, impl="overlap")
    model = build_sequential(convlstm_specs(), spatial=spatial, device=dev)
    rs = np.random.RandomState(0)
    B = 8 if lat_across else 8 * n
    x = rs.randn(steps, B, 2, 3, 36, 144).astype(np.float32)
    y = rs.randn(steps, B, 2, 2, 36, 144).astype(np.float32)
    model.init(torch.from_numpy(x[0, :1]).to(dev), seed=0)
    tr = Trainer(model, TrainConfig(), mesh=mesh,
                 batch_spec=("data", None, None, "lat", None))
    losses, ms = [], []
    for k in range(steps):
        t0 = time.perf_counter()
        losses.append(float(tr.train_step(x[k], y[k])["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    checksum = float(sum(p.detach().double().sum()
                         for p in model.parameters()))
    return {"rank": process_index(), "processes": n, "device": str(dev),
            "backend": torch.distributed.get_backend(), "mesh": mesh.shape,
            "losses": losses, "ms": ms,
            "param_checksum": checksum}


def main(argv=None) -> int:
    import argparse

    from dlwp_torch.serve import export_program

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--dryrun", type=int, default=0, metavar="N",
                        help="then dryrun_multichip(N) over N mesh entries, "
                             "the cards (or the CPU) repeated as needed")
    parser.add_argument("--distributed", action="store_true",
                        help="under torchrun: train_distributed() alone, "
                             "printing each rank's result")
    parser.add_argument("--lat-across", action="store_true",
                        help="with --distributed: a lat axis of one band a "
                             "process in place of data parallelism")
    args = parser.parse_args(argv)
    if args.distributed:
        out = train_distributed(device=args.device,
                                lat_across=args.lat_across)
        print(f"train_distributed rank {out['rank']}: {json.dumps(out)}",
              flush=True)
        from dlwp_torch.kernels.halo_exchange import release_mailboxes

        release_mailboxes()
        torch.distributed.destroy_process_group()
        return 0
    forward, (params, x) = entry(args.device)
    servable = export_program(functools.partial(forward, params), (x,))
    out = servable.call(x)
    print("entry OK:", tuple(out.shape), servable)
    if args.dryrun:
        dev = resolve_device(args.device)
        cards = (torch.cuda.device_count() if dev.type == "cuda" else 1)
        devices = [torch.device(dev.type, i % cards) if dev.type == "cuda"
                   else dev for i in range(args.dryrun)]
        losses = dryrun_multichip(args.dryrun, devices)
        print(f"dryrun_multichip({args.dryrun}) OK: {losses}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

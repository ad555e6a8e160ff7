"""Multi-process initialization, cross-process meshes and the moves
between processes (port of ``dlwp_tpu.parallel.distributed``).

The JAX package brings up ``jax.distributed`` over the data-centre network
and lays meshes out so that the latitude axis rides the fast links within
a slice while the data axis spans hosts. Here the processes are
``torch.distributed`` ranks: one per card under ``torchrun`` with NCCL,
or CPU processes with gloo. A mesh over them (:func:`multihost_mesh`)
keeps ``lat`` (and ``lon``) on each process's own cards and lets ``data``
span the processes; it also takes a ``lat`` axis that spans them, as the
JAX worker's ``MeshConfig(data=1, lat=-1)`` does.

The moves between processes are plain ``torch.distributed`` calls:
:func:`exchange_edges` (a lat band's edge rows to and from the band on
another process: ``batch_isend_irecv``, the port of the cross-host
``ppermute``), :func:`broadcast_block` (a block from its owner: the
join's ``process_allgather``), :func:`all_reduce_mean` (the gradient
mean of data parallelism) and :func:`broadcast_params`.

gloo carries host memory only: its send and receive take CPU tensors. So
under gloo each of these stages its tensors through the CPU
(:func:`wire_device`, the one place that says so); under NCCL they go
card to card. Two ranks on one card must use gloo: NCCL refuses two
ranks on one GPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from dlwp_torch.device import resolve_device
from dlwp_torch.parallel.mesh import Mesh, MeshConfig, Remote, build_mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device=None,
) -> None:
    """Join the process group (idempotent).

    With no arguments the process reads ``torchrun``'s environment
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), the counterpart of the TPU's automatic discovery;
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` set them by hand. ``backend``: ``nccl`` for the card
    (``device`` default ``cuda``; raises without one), ``gloo`` for
    ``device="cpu"`` and for the card where this host runs more ranks
    (``LOCAL_WORLD_SIZE``) than it has cards, since NCCL refuses two ranks
    on one GPU; a caller may name either. Under ``torchrun`` the process's
    card becomes ``cuda:LOCAL_RANK`` (modulo the card count); else it stays
    the caller's current card.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    env = os.environ
    missing = [k for k, v in (("MASTER_PORT", coordinator_address),
                              ("WORLD_SIZE", num_processes),
                              ("RANK", process_id))
               if v is None and k not in env]
    if missing:
        raise ValueError(f"initialize_distributed: {missing} unset; run "
                         "under torchrun or pass coordinator_address, "
                         "num_processes and process_id")
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env['MASTER_PORT']}")
    world = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    gloo = True  # the CPU, or more ranks on this host than cards
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if "LOCAL_RANK" in env:
            torch.cuda.set_device(int(env["LOCAL_RANK"]) % cards)
        gloo = int(env.get("LOCAL_WORLD_SIZE", 1)) > cards
    backend = backend or ("gloo" if gloo else "nccl")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


def multihost_mesh(config: MeshConfig | None = None, ici_axis: str = "lat",
                   devices=None) -> Mesh:
    """A (data, ``ici_axis``) mesh -- (data, ``ici_axis``, lon) when
    ``config.lon`` is set -- over every process's entries, laid out
    process by process: ``devices`` (default every CUDA card of this
    process) are this process's entries, and each process must give as
    many. With ``data`` a multiple of the process count, ``lat`` and
    ``lon`` lie on each process's own entries and ``data`` spans the
    processes; ``MeshConfig(data=1, lat=-1)`` gives a lat axis across
    them. One process: :func:`~dlwp_torch.parallel.mesh.build_mesh`."""
    config = config or MeshConfig()
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [resolve_device(d) for d in devices]
    world = process_count()
    if world == 1:
        every = [local]
    else:
        every = [None] * world
        dist.all_gather_object(every, [str(d) for d in local])
        if len({len(e) for e in every}) != 1:
            raise ValueError("every process must give as many mesh entries:"
                             f" {[len(e) for e in every]}")
        every = [[torch.device(d) for d in e] for e in every]
    lon = config.resolve(len(local) * world)[2]
    names = ("data", ici_axis, "lon") if lon > 1 else ("data", ici_axis)
    mesh = build_mesh(config, [d for e in every for d in e], axis_names=names)
    if world == 1:
        return mesh
    ranks = np.repeat(np.arange(world), len(local)).reshape(
        mesh.devices.shape)
    return Mesh(mesh.devices, mesh.axis_names, ranks, process_index())


def wire_device(device: torch.device) -> torch.device:
    """Where the process group's backend takes tensors: the CPU under
    gloo (host memory only), ``device`` under NCCL."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else device


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(wire_device(t.device)).contiguous()


def broadcast_block(block, like: torch.Tensor) -> torch.Tensor:
    """A block from its owner: ``block`` is this process's tensor, or a
    :class:`~dlwp_torch.parallel.mesh.Remote` whose process sends it
    (shaped like ``like``). Every process calls it (collective)."""
    if isinstance(block, Remote):
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device=wire_device(like.device))
        dist.broadcast(buf, src=block.rank)
        return buf.to(like.device)
    dist.broadcast(_wire(block), src=dist.get_rank())
    return block


def exchange_edges(row: list, halo: tuple[int, int]) -> dict:
    """The edge rows a lat-ordered data row needs from other processes:
    ``row`` holds this process's bands and
    :class:`~dlwp_torch.parallel.mesh.Remote` markers. At each boundary
    between a band here and a band on another process, this side sends
    its edge rows (the last ``top`` south, the first ``bot`` north) and
    receives the other's, in one ``batch_isend_irecv``. Returns
    ``{(i, "north" | "south"): rows}`` for band ``i`` here."""
    top, bot = halo
    like = next(b for b in row if not isinstance(b, Remote))
    wire = wire_device(like.device)
    ops, got = [], {}

    def recv(key, rows, src, tag):
        buf = torch.empty(like.shape[:-2] + (rows, like.shape[-1]),
                          dtype=like.dtype, device=wire)
        got[key] = buf
        ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))

    def send(t, dst, tag):
        ops.append(dist.P2POp(dist.isend, _wire(t), dst, tag=tag))

    for i in range(len(row) - 1):
        a, b = row[i], row[i + 1]
        if isinstance(a, Remote) == isinstance(b, Remote):
            continue
        # Both sides list the boundary's two moves in the same order:
        # southward (tag 2i), then northward (tag 2i + 1).
        if isinstance(b, Remote):
            if top > 0:
                send(a[..., a.shape[-2] - top:, :], b.rank, 2 * i)
            if bot > 0:
                recv((i, "south"), bot, b.rank, 2 * i + 1)
        else:
            if top > 0:
                recv((i + 1, "north"), top, a.rank, 2 * i)
            if bot > 0:
                send(b[..., :bot, :], a.rank, 2 * i + 1)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {k: v.to(like.device) for k, v in got.items()}


def all_reduce_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over processes of each tensor (one flat ``all_reduce``);
    every process gets the same bits."""
    flat = _wire(torch.cat([t.reshape(-1) for t in tensors]))
    dist.all_reduce(flat)
    flat = (flat / dist.get_world_size()).to(tensors[0].device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


@torch.no_grad()
def broadcast_params(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` set to process 0's."""
    for t in module.state_dict().values():
        buf = _wire(t)
        dist.broadcast(buf, src=0)
        t.copy_(buf)


__all__ = [
    "all_reduce_mean",
    "broadcast_block",
    "broadcast_params",
    "exchange_edges",
    "initialize_distributed",
    "is_primary",
    "multihost_mesh",
    "process_count",
    "process_index",
    "wire_device",
]

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
:func:`exchange_edges` (a block's edge rows or columns to and from the
neighbouring block on another process along a lat line or a cyclic lon
ring: ``batch_isend_irecv``, the port of the cross-host ``ppermute``)
and :func:`return_edges`, its transpose (each received edge's gradient
back to its sender, the same messages reversed), :func:`broadcast_block`
(a block from its owner: the join's ``process_allgather``),
:func:`all_reduce_mean` / :func:`all_reduce_sum` (the gradient mean of
data parallelism, the sum of a conv kernel's gradient over the bands of
other processes) and :func:`broadcast_params`. A collective over a part
of the processes runs in :func:`process_group`'s group of them.

gloo carries host memory only: its send and receive take CPU tensors. So
under gloo each of these stages its tensors through the CPU
(:func:`wire_device`, the one place that says so); under NCCL they go
card to card. Two ranks on one card must use gloo: NCCL refuses two
ranks on one GPU.
"""

from __future__ import annotations

import datetime
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
    timeout: float | None = None,
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
    the caller's current card. ``timeout`` (seconds; the backend's default
    where None) bounds the wait for the other processes at start and in
    every collective, so a process that is lost ends the others' run
    rather than hanging it.
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
    kw = {} if timeout is None else {"timeout": datetime.timedelta(
        seconds=timeout)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, **kw)


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


_GROUPS: dict = {}  # sorted ranks -> process group


def process_group(ranks):
    """The process group of ``ranks`` (global ranks): None, the default
    group, where they are every process; else a group made at first use
    by its members alone (``use_local_synchronization``), so that groups
    of disjoint processes may be made at once."""
    ranks = tuple(sorted({int(r) for r in ranks}))
    if len(ranks) == dist.get_world_size():
        return None
    group = _GROUPS.get(ranks)
    if group is None:
        group = _GROUPS[ranks] = dist.new_group(
            list(ranks), use_local_synchronization=True)
    return group


def broadcast_block(block, like: torch.Tensor, group=None) -> torch.Tensor:
    """A block from its owner: ``block`` is this process's tensor, or a
    :class:`~dlwp_torch.parallel.mesh.Remote` whose process sends it
    (shaped like ``like``). Every process of ``group`` calls it
    (collective)."""
    if isinstance(block, Remote):
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device=wire_device(like.device))
        dist.broadcast(buf, src=block.rank, group=group)
        return buf.to(like.device)
    dist.broadcast(_wire(block), src=dist.get_rank(), group=group)
    return block


def _boundaries(row: list, cyclic: bool):
    """``(b, i, j)``: the boundaries of a line of blocks, between block i
    and the next, j, where one is here and the other on another process
    (with ``cyclic``, the last block's next is the first)."""
    n = len(row)
    for b in range(n if cyclic and n > 1 else n - 1):
        i, j = b, (b + 1) % n
        if isinstance(row[i], Remote) != isinstance(row[j], Remote):
            yield b, i, j


def _run(ops) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _messages(row, halo, dim, cyclic, tag, send_first, recv_last):
    """The two messages of each boundary of a line (a :func:`_boundaries`
    boundary b between block i and block j): block i's last ``top`` rows
    go to j (tag ``tag + 2b``), block j's first ``bot`` rows go to i (tag
    ``tag + 2b + 1``); both sides list them in that order. ``send_first``
    / ``recv_last`` build the sides' payloads and buffers; returns the
    received buffers by key."""
    top, bot = halo
    like = next(b for b in row if not isinstance(b, Remote))
    wire = wire_device(like.device)
    ops, got = [], {}

    def recv(key, rows, src, t):
        shape = list(like.shape)
        shape[dim] = rows
        buf = torch.empty(shape, dtype=like.dtype, device=wire)
        got[key] = buf
        ops.append(dist.P2POp(dist.irecv, buf, src, tag=t))

    def send(t, dst, tg):
        ops.append(dist.P2POp(dist.isend, _wire(t), dst, tag=tg))

    for b, i, j in _boundaries(row, cyclic):
        if isinstance(row[j], Remote):  # block i is here
            if top > 0:
                if send_first:
                    send(row[i].narrow(dim, row[i].shape[dim] - top, top),
                         row[j].rank, tag + 2 * b)
                else:
                    recv((i, "last"), top, row[j].rank, tag + 2 * b)
            if bot > 0:
                if send_first:
                    recv((i, "south"), bot, row[j].rank, tag + 2 * b + 1)
                else:
                    send(recv_last[(i, "south")], row[j].rank,
                         tag + 2 * b + 1)
        else:  # block j is here
            if top > 0:
                if send_first:
                    recv((j, "north"), top, row[i].rank, tag + 2 * b)
                else:
                    send(recv_last[(j, "north")], row[i].rank, tag + 2 * b)
            if bot > 0:
                if send_first:
                    send(row[j].narrow(dim, 0, bot), row[i].rank,
                         tag + 2 * b + 1)
                else:
                    recv((j, "first"), bot, row[i].rank, tag + 2 * b + 1)
    _run(ops)
    return {k: v.to(like.device) for k, v in got.items()}


def exchange_edges(row: list, halo: tuple[int, int], *, dim: int = -2,
                   cyclic: bool = False, tag: int = 0) -> dict:
    """The edge rows a line of blocks needs from other processes: ``row``
    holds this process's blocks and
    :class:`~dlwp_torch.parallel.mesh.Remote` markers, in order along
    ``dim`` (lat bands along -2; lon tiles along -1, ``cyclic``). At each
    boundary between a block here and a block on another process, this
    side sends its edge (the last ``top`` to the next block, the first
    ``bot`` to the previous one) and receives the other's, in one
    ``batch_isend_irecv`` under tags from ``tag`` (two a boundary; a
    caller with several lines gives each its own). Returns ``{(i, "north"
    | "south"): rows}`` for block i here: from the previous block and from
    the next."""
    return _messages(row, halo, dim, cyclic, tag, True, None)


def return_edges(row: list, halo: tuple[int, int], grads: dict, *,
                 dim: int = -2, cyclic: bool = False, tag: int = 0) -> dict:
    """The transpose of :func:`exchange_edges` (the cross-host
    ``ppermute``'s): ``grads`` holds, under the keys that
    :func:`exchange_edges` returned, the gradient of each received edge;
    each goes back to the block that sent it, with the same tag. Returns
    ``{(i, "last" | "first"): gradient}`` of the edges block i here sent
    (its last ``top`` to the next block, its first ``bot`` to the previous
    one), which the caller adds into block i's gradient."""
    return _messages(row, halo, dim, cyclic, tag, False, grads)


def _all_reduce(tensors: list[torch.Tensor], group, mean: bool):
    flat = _wire(torch.cat([t.reshape(-1) for t in tensors]))
    dist.all_reduce(flat, group=group)
    if mean:
        flat = flat / dist.get_world_size(group)
    flat = flat.to(tensors[0].device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def broadcast_flat(tensors: list[torch.Tensor], src: int,
                   group=None) -> list[torch.Tensor]:
    """Process ``src``'s tensors on every process of ``group`` (one flat
    ``broadcast``)."""
    flat = _wire(torch.cat([t.reshape(-1) for t in tensors]))
    dist.broadcast(flat, src=src, group=group)
    flat = flat.to(tensors[0].device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def all_reduce_mean(tensors: list[torch.Tensor],
                    group=None) -> list[torch.Tensor]:
    """The mean over the processes of ``group`` (default: all) of each
    tensor (one flat ``all_reduce``); every process gets the same bits."""
    return _all_reduce(tensors, group, True)


def all_reduce_sum(tensors: list[torch.Tensor],
                   group=None) -> list[torch.Tensor]:
    """The sum over the processes of ``group`` of each tensor."""
    return _all_reduce(tensors, group, False)


@torch.no_grad()
def broadcast_params(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` set to process 0's."""
    for t in module.state_dict().values():
        buf = _wire(t)
        dist.broadcast(buf, src=0)
        t.copy_(buf)


__all__ = [
    "all_reduce_mean",
    "all_reduce_sum",
    "broadcast_block",
    "broadcast_flat",
    "broadcast_params",
    "exchange_edges",
    "initialize_distributed",
    "is_primary",
    "multihost_mesh",
    "process_count",
    "process_group",
    "process_index",
    "return_edges",
    "wire_device",
]

"""Latitude halo exchange over lat-band shards (kernel ``csrc/halo_exchange.cu``).

Port of ``dlwp_tpu.parallel.pallas_halo.pallas_halo_exchange_lat`` (the
Pallas ``_halo_kernel``). Shards come as ``shards[d][l]``: data row ``d``,
latitude band ``l`` (north to south), each a contiguous (..., H, W)
tensor. :func:`halo_exchange` returns the padded blocks (..., top + H +
bot, W) in the same layout, in the input dtype, with zeros north of the
first band and south of the last. For CUDA tensors it launches the kernel
once per card, covering every shard on it; for CPU tensors it takes the
plain version, :func:`halo_exchange_plain`. ``halo_exchange.launches``
counts kernel launches.

A lat axis across processes: a shard another process holds is a
:class:`~dlwp_torch.parallel.mesh.Remote` marker (anything with a
``rank`` in place of a tensor), and comes back as it is. A band here whose
neighbour is another process's reads that neighbour's edge rows from the
other process's :class:`Mailbox`, mapped into this one over CUDA IPC (the
TPU kernel's remote DMA of its edge slabs); on the CPU the plain version
gets them with ``torch.distributed`` messages
(:func:`~dlwp_torch.parallel.halo.halo_exchange_lat`).
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import NamedTuple

import torch

from dlwp_torch.kernels import _build
from dlwp_torch.utils.profiling import span


def is_remote(entry) -> bool:
    """Whether a shard (or a layout entry) is another process's: a
    ``Remote`` marker in place of a tensor (or of a device)."""
    return not isinstance(entry, (torch.Tensor, torch.device))


def halo_rows_plain(row: list[torch.Tensor],
                    halo: tuple[int, int]) -> list[torch.Tensor]:
    """The padded blocks of one data row of lat-ordered shards."""
    top, bot = halo
    n = len(row)
    out = []
    for i, x in enumerate(row):
        parts = []
        if top > 0:
            parts.append(row[i - 1][..., -top:, :].to(x.device) if i > 0
                         else x.new_zeros(x.shape[:-2] + (top, x.shape[-1])))
        parts.append(x)
        if bot > 0:
            parts.append(row[i + 1][..., :bot, :].to(x.device) if i < n - 1
                         else x.new_zeros(x.shape[:-2] + (bot, x.shape[-1])))
        out.append(torch.cat(parts, dim=-2))
    return out


def halo_exchange_plain(shards, halo):
    """The plain version; rows with another process's bands exchange their
    edge rows with ``torch.distributed`` messages, each row under its own
    tags."""
    if not any(is_remote(s) for row in shards for s in row):
        return [halo_rows_plain(row, halo) for row in shards]
    from dlwp_torch.parallel.halo import halo_exchange_lat

    return [halo_exchange_lat(row, halo, tag=2 * d * len(row))
            for d, row in enumerate(shards)]


def check_shards(shards, name: str) -> torch.Tensor:
    """Raise unless ``shards`` is a non-empty grid of same-shaped,
    same-typed tensors of rank >= 2 (and ``Remote`` markers), all on the
    CPU or all on CUDA; return the first tensor."""
    if not shards or not shards[0] or any(len(r) != len(shards[0])
                                          for r in shards):
        raise ValueError(f"{name}: shards must be a non-empty grid [d][l]")
    first = next((s for row in shards for s in row if not is_remote(s)),
                 None)
    if first is None:
        raise ValueError(f"{name}: this process holds no shard")
    if first.dim() < 2:
        raise ValueError(f"{name}: shards need (..., H, W), got "
                         f"{tuple(first.shape)}")
    kinds = set()
    for row in shards:
        for s in row:
            if is_remote(s):
                continue
            if s.shape != first.shape or s.dtype != first.dtype:
                raise ValueError(
                    f"{name}: shards differ: {tuple(s.shape)} {s.dtype} vs "
                    f"{tuple(first.shape)} {first.dtype}")
            kinds.add(s.device.type)
    if kinds not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"{name}: shards on {sorted(kinds)}; need all on "
                         "the CPU or all on CUDA")
    return first


class Group(NamedTuple):
    """One card's launch: its shards, which it writes (``outputs``, (d, l)
    keys); every shard it reads (``sources``: the outputs, then the lat
    neighbours that sit on other cards or in other processes, source-only
    entries); each output's northern and southern neighbour as an index
    into ``sources`` (-1 for none); the other cards it reads (``peers``);
    and the sources that are another process's edge slabs, mapped from its
    :class:`Mailbox` (``slabs``: ``(source index, owner rank, slot)``)."""
    outputs: list
    sources: list
    north: list
    south: list
    peers: list
    slabs: tuple = ()


def device_groups(devices) -> dict:
    """``{card: Group}`` for shards on ``devices[d][l]`` (the shards'
    devices, lat-ordered within each data row; a ``Remote`` marker where
    another process holds the shard): a pure function of the layout,
    which needs no card."""
    return _groups(tuple(tuple(row) for row in devices))


def exports(devices, rank=None) -> list:
    """The bands whose edge rows process ``rank`` (None: this process)
    puts in its mailbox, in (d, l) order: the slots of its mailbox. A band
    is exported where a lat neighbour belongs to another process. A pure
    function of the layout (``devices`` as for :func:`device_groups`)."""
    def owner(d, l):
        if not 0 <= l < len(devices[d]):
            return "none"
        e = devices[d][l]
        return e.rank if is_remote(e) else None

    return [(d, l) for d, row in enumerate(devices) for l in range(len(row))
            if owner(d, l) == rank
            and any(owner(d, n) not in (rank, "none") for n in (l - 1, l + 1))]


def source_rows(group: Group, H: int, edge: int) -> list[int]:
    """Each source's rows per image: ``H`` for a band, ``edge`` (the
    mailbox's top + bottom rows) for a mapped slab."""
    slab = {i for i, _, _ in group.slabs}
    return [edge if i in slab else H for i in range(len(group.sources))]


@functools.cache  # a launch's plan depends on its layout alone
def _groups(devices) -> dict:
    groups: dict = {}
    for d, row in enumerate(devices):
        for l, dev in enumerate(row):
            if not is_remote(dev):
                groups.setdefault(dev, []).append((d, l))
    out = {}
    for dev, keys in groups.items():
        sources = list(keys)
        pos = {k: i for i, k in enumerate(keys)}
        peers, slabs = [], []

        def index(d, l):
            if not 0 <= l < len(devices[d]):
                return -1
            if (d, l) not in pos:
                pos[(d, l)] = len(sources)
                sources.append((d, l))
                other = devices[d][l]
                if is_remote(other):
                    slabs.append((pos[(d, l)], other.rank,
                                  exports(devices, other.rank).index((d, l))))
                elif other not in peers:
                    peers.append(other)
            return pos[(d, l)]

        north = [index(d, l - 1) for d, l in keys]
        south = [index(d, l + 1) for d, l in keys]
        out[dev] = Group(keys, sources, north, south, peers, tuple(slabs))
    return out


def check_contiguous(shards, name: str) -> None:
    for row in shards:
        for s in row:
            if not is_remote(s) and not s.is_contiguous():
                raise ValueError(f"{name}: shards must be contiguous")


_PEERS_ENABLED: set = set()  # (reader, owner) card indices; process state


def enable_peer_access(dev: torch.device, peer: torch.device,
                       name: str) -> None:
    """Let card ``dev`` read card ``peer``'s memory (once per ordered pair
    in the process); raises, naming both cards, where the pair has no peer
    access."""
    pair = (dev.index, peer.index)
    if pair in _PEERS_ENABLED:
        return
    if not torch.cuda.can_device_access_peer(dev.index, peer.index):
        raise RuntimeError(
            f"{name}: {dev} cannot read {peer} (no peer access between the "
            "two cards); put lat neighbours on cards with peer access")
    err = _lib().dlwp_enable_peer_access(dev.index, peer.index)
    if err:
        raise RuntimeError(f"{name}: enabling peer access from {dev} to "
                           f"{peer} failed: CUDA error {err}")
    _PEERS_ENABLED.add(pair)


def wait_for_peers(dev: torch.device, group: Group, name: str) -> None:
    """Before card ``dev``'s launch: peer access to every card it reads,
    and its current stream waits on each such card's current stream,
    where the neighbours' shards were written."""
    if not group.peers:
        return
    stream = torch.cuda.current_stream(dev)
    for peer in group.peers:
        enable_peer_access(dev, peer, name)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(peer))
        stream.wait_event(event)


def release_peers(dev: torch.device, group: Group, shards) -> None:
    """After card ``dev``'s launch: each shard it read on another card is
    marked in use on its stream, so that the caching allocator does not
    reuse that memory while the read may be in flight (a mapped slab is
    the mailbox's, never freed while in use)."""
    if not group.peers:
        return
    stream = torch.cuda.current_stream(dev)
    for d, l in group.sources[len(group.outputs):]:
        if not is_remote(shards[d][l]):
            shards[d][l].record_stream(stream)


@functools.cache
def _lib():
    lib = _build.load("halo_exchange")
    fn = lib.dlwp_halo_exchange
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.dlwp_halo_exchange_max_shards.restype = ctypes.c_int
    lib.dlwp_enable_peer_access.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dlwp_enable_peer_access.restype = ctypes.c_int
    lib.dlwp_cuda_error_name.argtypes = [ctypes.c_int]
    lib.dlwp_cuda_error_name.restype = ctypes.c_char_p
    lib.dlwp_ipc_handle_size.restype = ctypes.c_int
    ptr, char = ctypes.c_void_p, ctypes.c_char_p
    for name, args in (
            ("dlwp_ipc_malloc", [ctypes.c_size_t, ctypes.POINTER(ptr), char]),
            ("dlwp_ipc_free", [ptr]),
            ("dlwp_ipc_open", [char, ctypes.POINTER(ptr)]),
            ("dlwp_ipc_close", [ptr]),
            ("dlwp_ipc_event", [ctypes.POINTER(ptr), char]),
            ("dlwp_ipc_open_event", [char, ctypes.POINTER(ptr)]),
            ("dlwp_event_destroy", [ptr]),
            ("dlwp_event_record", [ptr, ptr]),
            ("dlwp_stream_wait_event", [ptr, ptr]),
            ("dlwp_pack_edges", [ptr, ptr] + [ctypes.c_int] * 6 + [ptr])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    return lib


def cuda_check(err: int, what: str, name: str) -> None:
    """Raise, naming the CUDA error and its code, unless ``err`` is 0."""
    if err:
        label = _lib().dlwp_cuda_error_name(err) or b"unknown"
        raise RuntimeError(f"{name}: {what} failed: CUDA error "
                           f"{label.decode()} ({err})")


class Mailbox:
    """This process's edge mailbox for one launch layout and shard shape,
    and the other processes' mailboxes it reads, over CUDA IPC.

    The mailbox holds, for each band here that another process reads
    (:func:`exports`, its slots in order), the band's first ``bot`` rows
    and last ``top`` rows of every image: (rows, bot + top, W) a slot. It
    is two ``cudaMalloc`` allocations, used by call parity, each with an
    interprocess "written" and "read" event; their IPC handles go to every
    process of the layout once (``all_gather_object``), and each process
    maps the mailboxes of the processes whose bands border its own, once.
    A call (:meth:`post`, the launches, :meth:`done`):

    1. this card's stream waits until the readers are done with this
       parity's mailbox (their "read" events, recorded two calls ago);
    2. the exported edge rows are copied in, and "written" is recorded;
    3. a host barrier over the layout's processes, so that every record of
       this call precedes every wait on it;
    4. each launching card's stream waits on the neighbours' "written";
    5. after the launches, "read" is recorded.

    No kernel waits on another process's flag. Creating a mailbox raises
    with the CUDA error where the machine refuses IPC; nothing falls back.
    ``open_seconds``: the one-time cost of allocating, exporting and
    mapping; ``barrier_seconds`` / ``calls``: the host barrier's time,
    summed over calls."""

    def __init__(self, layout, shape, itemsize: int, edge: tuple[int, int],
                 device: torch.device, name: str):
        from dlwp_torch.parallel.distributed import process_group

        t0 = time.perf_counter()
        lib = _lib()
        self.name, self.device = name, device
        self.top, self.bot = edge
        self.rows = 1
        for n in shape[:-2]:
            self.rows *= int(n)
        self.H, self.row_bytes = int(shape[-2]), int(shape[-1]) * itemsize
        self.exports = exports(layout)
        self.slab_bytes = self.rows * (self.top + self.bot) * self.row_bytes
        me = torch.distributed.get_rank()
        neighbours = {layout[d][n].rank for d, row in enumerate(layout)
                      for l, e in enumerate(row) if not is_remote(e)
                      for n in (l - 1, l + 1)
                      if 0 <= n < len(row) and is_remote(row[n])}
        self.ranks = sorted({e.rank for row in layout for e in row
                             if is_remote(e)} | {me})
        self.group = process_group(self.ranks)
        size = lib.dlwp_ipc_handle_size()
        buf = ctypes.create_string_buffer
        self.buffers, self.written, self.read = [], [], []
        self._opened, self._events = [], []
        mine = []
        with torch.cuda.device(device):
            for _ in range(2):
                ptr, handle = ctypes.c_void_p(), buf(size)
                cuda_check(lib.dlwp_ipc_malloc(
                    max(1, len(self.exports)) * self.slab_bytes,
                    ctypes.byref(ptr), handle), "cudaIpcGetMemHandle", name)
                self.buffers.append(ptr.value)
                events = []
                for _ in range(2):
                    ev, eh = ctypes.c_void_p(), buf(size)
                    cuda_check(lib.dlwp_ipc_event(ctypes.byref(ev), eh),
                               "cudaIpcGetEventHandle", name)
                    self._events.append(ev.value)
                    events.append((ev.value, eh.raw))
                self.written.append(events[0][0])
                self.read.append(events[1][0])
                mine.append((handle.raw, events[0][1], events[1][1]))
            every = [None] * len(self.ranks)
            torch.distributed.all_gather_object(every, (me, mine),
                                                group=self.group)
            # peer rank -> per parity (mapped mailbox, written, read events)
            self.peers: dict = {}
            for rank, theirs in every:
                if rank not in neighbours:
                    continue
                maps = []
                for handle, w, r in theirs:
                    ptr = ctypes.c_void_p()
                    cuda_check(lib.dlwp_ipc_open(handle, ctypes.byref(ptr)),
                               "cudaIpcOpenMemHandle", name)
                    self._opened.append(ptr.value)
                    evs = []
                    for h in (w, r):
                        ev = ctypes.c_void_p()
                        err = lib.dlwp_ipc_open_event(h, ctypes.byref(ev))
                        cuda_check(err, "cudaIpcOpenEventHandle", name)
                        self._events.append(ev.value)
                        evs.append(ev.value)
                    maps.append((ptr.value, *evs))
                self.peers[rank] = maps
        self.calls = 0
        self.barrier_seconds = 0.0
        self.open_seconds = time.perf_counter() - t0

    @property
    def parity(self) -> int:
        return self.calls % 2

    def slab(self, rank: int, slot: int) -> int:
        """The address of process ``rank``'s slot ``slot`` in this call's
        mailbox, mapped here."""
        return self.peers[rank][self.parity][0] + slot * self.slab_bytes

    def post(self, shards, devices) -> None:
        """Steps 1-4 of a call: this process's exported edge rows into its
        mailbox, then each card of ``devices`` waits on the neighbours'."""
        lib, p = _lib(), self.parity
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            for dev in {s.device for row in shards for s in row
                        if not is_remote(s)} - {self.device}:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                stream.wait_event(event)
            for maps in self.peers.values():
                cuda_check(lib.dlwp_stream_wait_event(stream.cuda_stream,
                                                      maps[p][2]),
                           "cudaStreamWaitEvent", self.name)
            src = [shards[d][l].data_ptr() for d, l in self.exports]
            cuda_check(lib.dlwp_pack_edges(
                self.buffers[p], (ctypes.c_void_p * max(1, len(src)))(*src),
                len(src), self.rows, self.H, self.row_bytes, self.top,
                self.bot, stream.cuda_stream), "cudaMemcpy2DAsync", self.name)
            cuda_check(lib.dlwp_event_record(self.written[p],
                                             stream.cuda_stream),
                       "cudaEventRecord", self.name)
        t0 = time.perf_counter()
        torch.distributed.barrier(group=self.group)
        self.barrier_seconds += time.perf_counter() - t0
        for dev in devices:
            stream = torch.cuda.current_stream(dev).cuda_stream
            for maps in self.peers.values():
                cuda_check(lib.dlwp_stream_wait_event(stream, maps[p][1]),
                           "cudaStreamWaitEvent", self.name)

    def done(self, devices) -> None:
        """Step 5: "read" recorded behind every launch of ``devices``."""
        lib = _lib()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            for dev in set(devices) - {self.device}:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                stream.wait_event(event)
            cuda_check(lib.dlwp_event_record(self.read[self.parity],
                                             stream.cuda_stream),
                       "cudaEventRecord", self.name)
        self.calls += 1

    def close(self) -> None:
        """Unmap the other processes' mailboxes, then free this one's and
        the events (after a barrier, where the group still exists, so that
        no process frees what another still reads)."""
        lib = _lib()
        torch.cuda.synchronize(self.device)
        if torch.distributed.is_initialized():
            torch.distributed.barrier(group=self.group)
        with torch.cuda.device(self.device):
            for ptr in self._opened:
                lib.dlwp_ipc_close(ptr)
            if torch.distributed.is_initialized():
                torch.distributed.barrier(group=self.group)
            for ptr in self.buffers:
                lib.dlwp_ipc_free(ptr)
            for ev in self._events:
                lib.dlwp_event_destroy(ev)
        self._opened, self.buffers, self._events = [], [], []


_MAILBOXES: dict = {}  # (layout, shape, dtype, edge) -> Mailbox


def mailbox(layout, first: torch.Tensor, edge, name: str) -> Mailbox:
    """The mailbox of a launch layout, shard shape and edge, shared by the
    kernels (made at first use, where every process of the layout calls
    this together)."""
    key = (layout, tuple(first.shape), first.dtype, tuple(edge))
    box = _MAILBOXES.get(key)
    if box is None:
        dev = next(e for row in layout for e in row if not is_remote(e))
        box = _MAILBOXES[key] = Mailbox(layout, first.shape,
                                        first.element_size(), edge, dev,
                                        name)
    return box


def mailboxes() -> list[Mailbox]:
    """Every mailbox of this process, in the order made."""
    return list(_MAILBOXES.values())


def release_mailboxes() -> None:
    """Close every mailbox (collective over each one's processes; a
    process calls it before it leaves the process group)."""
    while _MAILBOXES:
        _MAILBOXES.pop(next(iter(_MAILBOXES))).close()


@span("kernel.halo_exchange")
def halo_exchange(shards, halo):
    """``shards[d][l]`` (..., H, W) -> padded blocks (..., top + H + bot, W)
    (a ``Remote`` marker stays)."""
    top, bot = (int(h) for h in halo)
    first = check_shards(shards, "halo_exchange")
    H, W = first.shape[-2:]
    if not (0 <= top <= H and 0 <= bot <= H):
        raise ValueError(f"halo_exchange: halo {halo} outside [0, {H}]")
    if first.device.type == "cpu":
        return halo_exchange_plain(shards, (top, bot))
    check_contiguous(shards, "halo_exchange")
    layout = tuple(tuple(s if is_remote(s) else s.device for s in row)
                   for row in shards)
    groups = device_groups(layout)
    if top == 0 and bot == 0:
        return [list(row) for row in shards]
    rows = first.numel() // (H * W)
    row_bytes = W * first.element_size()
    if rows * (top + H + bot) >= 2 ** 31 or rows * H * W >= 2 ** 31:
        raise ValueError(f"halo_exchange: shards too large, {first.shape}")
    out_shape = first.shape[:-2] + (top + H + bot, W)
    out = [[s if is_remote(s) else None for s in row] for row in shards]
    lib = _lib()
    box = (mailbox(layout, first, (top, bot), "halo_exchange")
           if any(g.slabs for g in groups.values()) else None)
    if box is not None:
        box.post(shards, [dev for dev, g in groups.items() if g.slabs])
    for dev, g in groups.items():
        if len(g.sources) > lib.dlwp_halo_exchange_max_shards():
            raise ValueError(f"halo_exchange: {len(g.sources)} shards read "
                             f"on {dev}")
        for d, l in g.outputs:
            out[d][l] = torch.empty(out_shape, device=dev, dtype=first.dtype)
        slabs = {i: box.slab(rank, slot) for i, rank, slot in g.slabs}
        src = [slabs[i] if i in slabs else shards[d][l].data_ptr()
               for i, (d, l) in enumerate(g.sources)]
        dst = [out[d][l].data_ptr() for d, l in g.outputs]
        unit = next(u for u in (16, 8, 4, 2, 1)
                    if row_bytes % u == 0 and all(p % u == 0
                                                  for p in src + dst))
        n, n_src = len(dst), len(src)
        with torch.cuda.device(dev):
            wait_for_peers(dev, g, "halo_exchange")
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.dlwp_halo_exchange(
                (ctypes.c_void_p * n_src)(*src),
                (ctypes.c_int * n_src)(*source_rows(g, H, top + bot)),
                (ctypes.c_void_p * n)(*dst),
                (ctypes.c_int * n)(*g.north), (ctypes.c_int * n)(*g.south),
                n, n_src, rows, H, row_bytes, unit, top, bot, stream)
        if err:
            raise RuntimeError(f"halo_exchange launch failed: CUDA error {err}")
        release_peers(dev, g, shards)
        halo_exchange.launches += 1
    if box is not None:
        box.done([dev for dev, g in groups.items() if g.slabs])
    return out


halo_exchange.launches = 0

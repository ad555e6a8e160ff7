"""The lat-band kernels' launch plan across cards (peer access), on the CPU.

``dlwp_torch.kernels.halo_exchange.device_groups`` plans each card's
launch from the shards' devices alone: the card's own shards (outputs),
then the lat neighbours it reads on other cards (source-only entries),
each output's neighbours as indices into the sources, and the cards it
reads (peers). No card is needed: the plans are built on
``torch.device("cuda", i)`` objects. The kernels' table semantics are
emulated in numpy against the plain versions (``halo_rows_plain``,
``overlap_conv_plain``, bit for bit and in float64), the overlap kernels'
tiles are checked to cover each card's own shards once, and a pair of
cards without peer access raises naming both.

A lat axis across processes: the plan maps a neighbour band of another
process to a slab of that process's edge mailbox (``Group.slabs``: owner
and slot, the slot the band's place in the owner's ``exports``; the
slab's rows per image from ``source_rows``); the kernels' reads through
such a table, with the slabs packed as ``dlwp_pack_edges`` packs them,
are emulated against the plain versions; the kernel impls on such a mesh
match the JAX conv with the messages between processes replaced by
their contract; and a machine that refuses CUDA IPC makes the mailbox
raise with the CUDA error's name and code (a stubbed entry point).
"""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dlwp_torch.kernels.halo_exchange import (
    Group,
    device_groups,
    enable_peer_access,
    exports,
    halo_rows_plain,
    source_rows,
)
from dlwp_torch.kernels.overlap_conv import _plan, _tile, overlap_conv_plain
from dlwp_torch.ops.conv import cyclic_conv2d
from dlwp_torch.ops.padding import pad_latlon
from dlwp_torch.parallel import SpatialSharding
from dlwp_torch.parallel.mesh import Mesh, Remote, split_shards

# The module (the package exports a function of the same name).
hx = importlib.import_module("dlwp_torch.kernels.halo_exchange")
C0, C1, C2, C3 = (torch.device("cuda", i) for i in range(4))

LAYOUTS = {
    "one card, lat 2": [[C0, C0]],
    "two cards, lat 2": [[C0, C1]],
    "two cards, lat 4": [[C0, C0, C1, C1]],
    "four cards, lat 4": [[C0, C1, C2, C3]],
    "interleaved": [[C0, C1, C0, C1]],
    "data 2 x lat 2": [[C0, C1], [C0, C1]],
    "data 2 x lat 2, a card a row": [[C0, C0], [C1, C1]],
    "data 2 x lat 3": [[C0, C1, C2], [C2, C1, C0]],
}


def test_two_cards_plan():
    groups = device_groups([[C0, C1]])
    assert groups == {
        C0: Group([(0, 0)], [(0, 0), (0, 1)], [-1], [1], [C1]),
        C1: Group([(0, 1)], [(0, 1), (0, 0)], [1], [-1], [C0]),
    }


def test_repeated_card_plan_reads_no_peer():
    (g,) = device_groups([[C0, C0, C0], [C0, C0, C0]]).values()
    assert g.outputs == g.sources and g.peers == []
    assert g.north == [-1, 0, 1, -1, 3, 4]
    assert g.south == [1, 2, -1, 4, 5, -1]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plan_covers_every_shard_and_neighbour(layout):
    devices = LAYOUTS[layout]
    groups = device_groups(devices)
    outputs = [k for g in groups.values() for k in g.outputs]
    assert sorted(outputs) == [(d, l) for d, row in enumerate(devices)
                               for l in range(len(row))]
    for dev, g in groups.items():
        n = len(g.outputs)
        assert g.sources[:n] == g.outputs
        assert all(devices[d][l] == dev for d, l in g.outputs)
        # Source-only entries: each a neighbour on another card, once.
        extra = g.sources[n:]
        assert len(set(extra)) == len(extra)
        assert all(devices[d][l] != dev for d, l in extra)
        assert g.peers == list(dict.fromkeys(devices[d][l]
                                             for d, l in extra))
        for (d, l), north, south in zip(g.outputs, g.north, g.south):
            assert (g.sources[north] if north >= 0 else None) == (
                (d, l - 1) if l > 0 else None)
            assert (g.sources[south] if south >= 0 else None) == (
                (d, l + 1) if l + 1 < len(devices[d]) else None)
        used = {i for i in g.north + g.south if i >= 0}
        assert set(range(n, len(g.sources))) <= used


def _shards(devices, shape, seed=0, dtype=np.float64):
    rs = np.random.RandomState(seed)
    return [[torch.from_numpy(rs.randn(*shape).astype(dtype)) for _ in row]
            for row in devices]


def _emulate_halo(devices, shards, halo):
    """csrc/halo_exchange.cu over each card's table: output s is the last
    `top` rows of sources[north[s]], shard s, the first `bot` rows of
    sources[south[s]], zeros for -1."""
    top, bot = halo
    out = [[None] * len(row) for row in devices]
    for g in device_groups(devices).values():
        src = [shards[d][l].numpy() for d, l in g.sources]
        for s, (d, l) in enumerate(g.outputs):
            x = src[s]
            zeros = np.zeros(x.shape[:-2] + (0, x.shape[-1]))
            n_rows = (src[g.north[s]][..., x.shape[-2] - top:, :]
                      if g.north[s] >= 0 else
                      np.zeros(x.shape[:-2] + (top, x.shape[-1])))
            s_rows = (src[g.south[s]][..., :bot, :] if g.south[s] >= 0
                      else np.zeros(x.shape[:-2] + (bot, x.shape[-1])))
            out[d][l] = np.concatenate(
                [n_rows if top else zeros, x, s_rows if bot else zeros],
                axis=-2)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("halo", [(1, 1), (2, 1), (0, 2)])
def test_halo_table_emulation_equals_plain(layout, halo):
    devices = LAYOUTS[layout]
    shards = _shards(devices, (2, 3, 4, 8))
    got = _emulate_halo(devices, shards, halo)
    for d, row in enumerate(shards):
        for l, want in enumerate(halo_rows_plain(row, halo)):
            np.testing.assert_array_equal(got[d][l], want.numpy())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_overlap_table_emulation_equals_plain(layout):
    """The overlap kernels' staging (csrc/overlap_conv.cu ``decode`` and
    ``stage_x``): a tile of output s reads row -1 from the last row of
    sources[north[s]] and row H from the first of sources[south[s]]; the
    tiles of each card's plan (over its own shards only) cover every
    (sample, row) of its outputs once."""
    devices = LAYOUTS[layout]
    B, Ch, H, W, O = 3, 5, 4, 16, 6
    shards = _shards(devices, (B, Ch, H, W), seed=1)
    k = torch.from_numpy(np.random.RandomState(2).randn(O, Ch, 3, 3))
    want = overlap_conv_plain([[s.float() for s in row] for row in shards],
                              k.float())
    for g in device_groups(devices).values():
        n = len(g.outputs)
        for chunk in (None, 2):
            plan = _plan(B, Ch, H, W, O, chunk, n, 132)
            seen = {}
            for t in range(plan.tiles):
                s, b0, nb, h0, nr, og = _tile(plan, B, H, n, t)
                assert 0 <= s < n
                for b in range(b0, b0 + nb):
                    for h in range(h0, h0 + nr):
                        seen[(s, b, h, og)] = seen.get((s, b, h, og), 0) + 1
            assert seen == {(s, b, h, og): 1 for s in range(n)
                            for b in range(B) for h in range(H)
                            for og in range(plan.n_og)}
        src = [shards[d][l] for d, l in g.sources]
        for s, (d, l) in enumerate(g.outputs):
            x = src[s]
            north = (src[g.north[s]][..., -1:, :] if g.north[s] >= 0
                     else torch.zeros_like(x[..., :1, :]))
            south = (src[g.south[s]][..., :1, :] if g.south[s] >= 0
                     else torch.zeros_like(x[..., :1, :]))
            staged = torch.cat([north, x, south], dim=-2)
            got = F.conv2d(pad_latlon(staged, (0, 0), (1, 1)), k)
            np.testing.assert_allclose(got.numpy(), want[d][l].numpy(),
                                       rtol=0, atol=1e-5)


def test_a_pair_without_peer_access_raises_naming_both(monkeypatch):
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    monkeypatch.setattr(hx, "_PEERS_ENABLED", set())
    with pytest.raises(RuntimeError, match="cuda:0 cannot read cuda:1"):
        enable_peer_access(C0, C1, "halo_exchange")


def test_enabled_pair_is_not_asked_again(monkeypatch):
    asked = []
    monkeypatch.setattr(hx, "_PEERS_ENABLED", {(0, 1)})
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: asked.append((a, b)) or True)
    enable_peer_access(C0, C1, "halo_exchange")
    assert asked == []


def _cross_process_mesh(process_index):
    """(data 1, lat 4): bands 0-1 on process 0, 2-3 on process 1."""
    devices = np.empty((1, 4), dtype=object)
    devices[:] = [torch.device("cpu")] * 4
    return Mesh(devices, ("data", "lat"), np.array([[0, 0, 1, 1]]),
                process_index)


# Which bands of a lat-ordered data row another process holds.
REMOTE_PATTERNS = {
    "here, there": [False, True],
    "there, here": [True, False],
    "there, here, there": [True, False, True],
    "here, there, here": [False, True, False],
    "two there, here, there": [True, True, False, True],
    "two here, two there": [False, False, True, True],
}


def _fake_processes(monkeypatch, whole_rows, pid):
    """This process as process ``pid`` of a (data 1, lat 4) mesh over two
    processes, with the messages between processes replaced by their
    contract: a band's edge rows come from ``whole_rows`` (the row's
    bands), and the join's remote blocks come back as NaN (only this
    process's rows are checked)."""
    from dlwp_torch.parallel import distributed
    from dlwp_torch.parallel import halo as halo_mod

    def exchange(row, halo, **kw):
        assert kw.get("dim", -2) == -2 and not kw.get("cyclic", False)
        top, bot = halo
        out = {}
        for i, b in enumerate(row):
            if isinstance(b, Remote):
                continue
            if top and i > 0 and isinstance(row[i - 1], Remote):
                out[(i, "north")] = whole_rows[i - 1][..., -top:, :]
            if bot and i < len(row) - 1 and isinstance(row[i + 1], Remote):
                out[(i, "south")] = whole_rows[i + 1][..., :bot, :]
        return out

    monkeypatch.setattr(halo_mod, "exchange_edges", exchange)
    monkeypatch.setattr(distributed, "process_group", lambda ranks: None)
    monkeypatch.setattr(distributed, "broadcast_block",
                        lambda b, like, group=None: like.new_full(
                            like.shape, np.nan) if isinstance(b, Remote)
                        else b)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: pid)


@pytest.mark.parametrize("impl", ["pallas", "overlap"])
def test_kernel_impls_refuse_a_lat_axis_across_processes(monkeypatch, impl):
    """The kernel impls on a lat axis across processes no longer refuse:
    on each process of (data 1, lat 4) over two, with the messages
    replaced by their contract, the bands it holds equal the JAX conv's
    rows in float32 (the kernels' plain versions here)."""
    import jax.numpy as jnp
    from dlwp_tpu.ops.conv import cyclic_conv2d as jax_cyclic

    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 3, 8, 16)).float()
    k = torch.from_numpy(rs.randn(4, 3, 3, 3)).float()
    want = np.asarray(jax_cyclic(jnp.asarray(x.numpy()),
                                 jnp.asarray(k.numpy())))
    for pid in (0, 1):
        _fake_processes(monkeypatch, list(x.chunk(4, dim=-2)), pid)
        got = SpatialSharding(_cross_process_mesh(pid), data_axis=None,
                              impl=impl).conv(x, k).numpy()
        rows = slice(4 * pid, 4 * pid + 4)
        np.testing.assert_allclose(got[..., rows, :], want[..., rows, :],
                                   rtol=0, atol=1e-5)
        assert np.isnan(np.delete(got, np.r_[rows], axis=-2)).all()


# Layouts of a lat axis across processes as one process sees them: its
# own bands on its cards, the others' as Remote markers.
R0, R1, R2 = Remote(0), Remote(1), Remote(2)
CROSS = {
    "lat 2, process 0": [[C0, R1]],
    "lat 2, process 1": [[R0, C0]],
    "lat 4 over 2, process 0": [[C0, C0, R1, R1]],
    "lat 4 over 4, process 1": [[R0, C0, R2, Remote(3)]],
    "lat 4 over 2 with two cards, process 1": [[R0, R0, C0, C1]],
    "data 2 x lat 2 over 4, process 0": [[C0, R1], [R2, Remote(3)]],
    "data 3 x lat 2 over 3, process 1": [[R0, R0], [R0, C0], [C0, R2]],
}


def test_mailbox_plan_of_lat_2():
    (g,) = device_groups([[C0, R1]]).values()
    assert g == Group([(0, 0)], [(0, 0), (0, 1)], [-1], [1], [],
                      ((1, 1, 0),))
    assert source_rows(g, 18, 4) == [18, 4]
    assert exports([[C0, R1]]) == [(0, 0)]
    assert exports([[C0, R1]], 1) == [(0, 1)]


@pytest.mark.parametrize("layout", list(CROSS))
def test_mailbox_plan_maps_each_remote_neighbour_to_its_slot(layout):
    """Every neighbour band of another process is a source-only entry of
    the launch that reads it, marked as a slab of its owner's mailbox at
    the band's place in the owner's exports (which the owner computes
    from its own view alike), with the mailbox's rows per image; no card
    of this process is a peer for it; Remote bands have no launch."""
    devices = CROSS[layout]
    groups = device_groups(devices)
    outputs = sorted(k for g in groups.values() for k in g.outputs)
    assert outputs == [(d, l) for d, row in enumerate(devices)
                       for l, e in enumerate(row) if isinstance(e,
                                                                torch.device)]
    seen = set()
    for dev, g in groups.items():
        assert isinstance(dev, torch.device)
        slabs = {i: (rank, slot) for i, rank, slot in g.slabs}
        for i, (d, l) in enumerate(g.sources):
            e = devices[d][l]
            if isinstance(e, Remote):
                assert slabs[i] == (e.rank,
                                    exports(devices, e.rank).index((d, l)))
                seen.add((d, l))
            else:
                assert i not in slabs
        assert all(isinstance(p, torch.device) for p in g.peers)
        assert source_rows(g, 9, 2) == [2 if i in slabs else 9
                                        for i in range(len(g.sources))]
    want = {(d, n) for d, row in enumerate(devices)
            for l, e in enumerate(row) if isinstance(e, torch.device)
            for n in (l - 1, l + 1) if 0 <= n < len(row)
            and isinstance(row[n], Remote)}
    assert seen == want
    # The owner's exports are the bands with a neighbour of another
    # process, whoever computes them.
    mine = exports(devices)
    assert mine == [(d, l) for d, row in enumerate(devices)
                    for l, e in enumerate(row) if isinstance(e, torch.device)
                    and any(0 <= n < len(row) and isinstance(row[n], Remote)
                            for n in (l - 1, l + 1))]


def _pack(band, top, bot):
    """``dlwp_pack_edges``: per image the band's first ``bot`` rows, then
    its last ``top`` rows."""
    return np.concatenate([band[..., :bot, :],
                           band[..., band.shape[-2] - top:, :]], axis=-2)


def _whole_and_layout(pattern, shape, seed):
    remote = REMOTE_PATTERNS[pattern]
    rs = np.random.RandomState(seed)
    whole = [rs.randn(*shape) for _ in remote]
    layout = [[Remote(1) if r else C0 for r in remote]]
    return whole, layout


@pytest.mark.parametrize("pattern", list(REMOTE_PATTERNS))
@pytest.mark.parametrize("halo", [(1, 1), (2, 1), (0, 2), (2, 0)])
def test_mailbox_halo_emulation_equals_plain(pattern, halo):
    """csrc/halo_exchange.cu over a table with mapped slabs: the slab of a
    band of another process is its owner's packed edge rows, read with
    the source's own rows per image (the north's last ``top``, the
    south's first ``bot``); the bands here come out as the plain exchange
    pads them on the whole row, bit for bit."""
    top, bot = halo
    whole, layout = _whole_and_layout(pattern, (2, 3, 4, 8), 7)
    (g,) = device_groups(layout).values()
    H = whole[0].shape[-2]
    rows = source_rows(g, H, top + bot)
    slab = {i for i, _, _ in g.slabs}
    src = [_pack(whole[l], top, bot) if i in slab else whole[l]
           for i, (_, l) in enumerate(g.sources)]
    want = halo_rows_plain([torch.from_numpy(b) for b in whole], halo)
    for s, (_, l) in enumerate(g.outputs):
        parts = []
        for idx, n, first in ((g.north[s], top, False), (g.south[s], bot,
                                                          True)):
            if idx < 0:
                part = np.zeros(src[s].shape[:-2] + (n, src[s].shape[-1]))
            else:
                at = 0 if first else rows[idx] - n
                part = src[idx].reshape((-1, rows[idx], src[idx].shape[-1])
                                        )[:, at:at + n].reshape(
                    src[s].shape[:-2] + (n, src[s].shape[-1]))
            parts.append(part)
        got = np.concatenate([parts[0], src[s], parts[1]], axis=-2)
        np.testing.assert_array_equal(got, want[l].numpy())


@pytest.mark.parametrize("pattern", list(REMOTE_PATTERNS))
def test_mailbox_overlap_emulation_equals_plain(pattern):
    """The overlap kernels' staging over mapped slabs of 2 rows an image
    (csrc/overlap_conv.cu ``decode``: row -1 is the north source's last
    row at its own image stride, row H the south's first): the conv of
    each band here equals the plain version's on the whole row."""
    whole, layout = _whole_and_layout(pattern, (3, 5, 4, 16), 8)
    (g,) = device_groups(layout).values()
    k = torch.from_numpy(np.random.RandomState(9).randn(6, 5, 3, 3))
    slab = {i for i, _, _ in g.slabs}
    src = [_pack(whole[l], 1, 1) if i in slab else whole[l]
           for i, (_, l) in enumerate(g.sources)]
    want = overlap_conv_plain([[torch.from_numpy(b).float() for b in whole]],
                              k.float())[0]
    for s, (_, l) in enumerate(g.outputs):
        x = torch.from_numpy(src[s])
        north = (torch.from_numpy(src[g.north[s]][..., -1:, :])
                 if g.north[s] >= 0 else torch.zeros_like(x[..., :1, :]))
        south = (torch.from_numpy(src[g.south[s]][..., :1, :])
                 if g.south[s] >= 0 else torch.zeros_like(x[..., :1, :]))
        staged = torch.cat([north, x, south], dim=-2)
        got = F.conv2d(pad_latlon(staged, (0, 0), (1, 1)), k)
        np.testing.assert_allclose(got.numpy(), want[l].numpy(), rtol=0,
                                   atol=1e-5)


class _RefusingLib:
    """The CUDA IPC entry points of csrc/halo_exchange.cu on a machine
    that refuses IPC: the export fails with cudaErrorNotSupported (801)."""

    def dlwp_ipc_handle_size(self):
        return 64

    def dlwp_ipc_malloc(self, nbytes, ptr, handle):
        return 801

    def dlwp_cuda_error_name(self, err):
        return b"cudaErrorNotSupported"

    def __getattr__(self, name):
        raise AssertionError(f"{name} called after the refusal")


def test_a_machine_refusing_ipc_raises_with_the_cuda_error(monkeypatch):
    """No fallback: where the export of the mailbox fails, the kernel's
    mailbox raises, naming the CUDA error and its code, before any
    launch or message."""
    import contextlib

    from dlwp_torch.parallel import distributed

    monkeypatch.setattr(hx, "_lib", lambda: _RefusingLib())
    monkeypatch.setattr(distributed, "process_group", lambda ranks: None)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    with pytest.raises(RuntimeError,
                       match=r"halo_exchange: cudaIpcGetMemHandle failed: "
                             r"CUDA error cudaErrorNotSupported \(801\)"):
        hx.Mailbox(((C0, R1),), (2, 3, 18, 144), 4, (1, 1), C0,
                   "halo_exchange")


def test_cross_process_split_keeps_remote_places():
    x = torch.arange(2 * 8 * 4, dtype=torch.float64).reshape(2, 8, 4)
    for pid in (0, 1):
        (row,) = split_shards(x, _cross_process_mesh(pid), None, "lat")
        assert [isinstance(s, Remote) for s in row] == (
            [False, False, True, True] if pid == 0
            else [True, True, False, False])
        mine = [s for s in row if not isinstance(s, Remote)]
        want = list(x.chunk(4, dim=-2))[2 * pid:2 * pid + 2]
        assert all(torch.equal(a, b) for a, b in zip(mine, want))


def test_data_across_processes_keeps_the_kernels_on_the_own_block():
    """(data 2 across processes, lat 2 within each): the convs of a layer
    run the process's block of the batch on its own entries, kernel impls
    included (their plain versions here)."""
    devices = np.empty(4, dtype=object)
    devices[:] = [torch.device("cpu")] * 4
    mesh = Mesh(devices.reshape(2, 2), ("data", "lat"), np.array([[0, 0], [1, 1]]), 1)
    cfg = SpatialSharding(mesh, impl="overlap")
    assert cfg.local.mesh.shape == {"data": 1, "lat": 2}
    assert cfg.local.mesh.ranks is None
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(3, 4, 8, 16)).float()
    k = torch.from_numpy(rs.randn(5, 4, 3, 3)).float()
    np.testing.assert_allclose(cfg.conv(x, k).numpy(),
                               cyclic_conv2d(x, k).numpy(), rtol=0,
                               atol=1e-5)


def test_a_data_row_held_elsewhere_comes_back_unchanged():
    """(data 2, lat 2) over four processes, one entry each: process 0 holds
    band 0 of data row 0 and nothing of row 1, whose exchange is the other
    processes' and returns the row as it was, with no message sent."""
    from dlwp_torch.parallel.halo import halo_exchange_lat

    devices = np.empty((2, 2), dtype=object)
    devices[:] = [[torch.device("cpu")] * 2] * 2
    mesh = Mesh(devices, ("data", "lat"), np.array([[0, 1], [2, 3]]), 0)
    x = torch.arange(2 * 3 * 8 * 4, dtype=torch.float64).reshape(2, 3, 8, 4)
    mine, elsewhere = split_shards(x, mesh, "data", "lat")
    assert [isinstance(s, Remote) for s in mine] == [False, True]
    assert elsewhere == [Remote(2), Remote(3)]
    assert halo_exchange_lat(elsewhere, (1, 1)) == [Remote(2), Remote(3)]


@pytest.mark.parametrize("pattern", list(REMOTE_PATTERNS))
@pytest.mark.parametrize("halo", [(1, 1), (2, 1), (0, 2), (2, 0)])
def test_remote_bands_pad_like_the_plain_exchange(monkeypatch, pattern,
                                                  halo):
    """The exchange across processes replaced by its contract (band i here
    receives its north rows from band i - 1 and its south rows from band
    i + 1 where those are another process's): the bands here come out as
    ``halo_rows_plain`` pads them on the whole row, bit for bit, and the
    remote places stay."""
    from dlwp_torch.parallel import halo as halo_mod

    remote = REMOTE_PATTERNS[pattern]
    rs = np.random.RandomState(len(remote))
    whole = [torch.from_numpy(rs.randn(2, 3, 4, 5)) for _ in remote]
    top, bot = halo

    def exchange(row, got_halo, **kw):
        assert got_halo == halo
        assert kw == {"dim": -2, "cyclic": False, "tag": 0}
        out = {}
        for i, b in enumerate(row):
            if isinstance(b, Remote):
                continue
            if top and i > 0 and remote[i - 1]:
                out[(i, "north")] = whole[i - 1][..., -top:, :]
            if bot and i < len(row) - 1 and remote[i + 1]:
                out[(i, "south")] = whole[i + 1][..., :bot, :]
        return out

    monkeypatch.setattr(halo_mod, "exchange_edges", exchange)
    row = [Remote(1) if r else b for b, r in zip(whole, remote)]
    got = halo_mod.halo_exchange_lat(row, halo)
    want = halo_rows_plain(whole, halo)
    for g, w, r in zip(got, want, remote):
        if r:
            assert g == Remote(1)
        else:
            assert torch.equal(g, w)

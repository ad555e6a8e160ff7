"""The lat-band kernels' launch plan across cards (peer access), on the CPU.

``dlwp_torch.kernels.halo_exchange.device_groups`` plans each card's
launch from the shards' devices alone: the card's own shards (outputs),
then the lat neighbours it reads on other cards (source-only entries),
each output's neighbours as indices into the sources, and the cards it
reads (peers). No card is needed: the plans are built on
``torch.device("cuda", i)`` objects. The kernels' table semantics are
emulated in numpy against the plain versions (``halo_rows_plain``,
``overlap_conv_plain``, bit for bit and in float64), the overlap kernels'
tiles are checked to cover each card's own shards once, a pair of cards
without peer access raises naming both, and a mesh whose lat axis spans
processes is refused by the kernel impls and runs on the plain one.
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
    halo_rows_plain,
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


@pytest.mark.parametrize("impl", ["pallas", "overlap"])
def test_kernel_impls_refuse_a_lat_axis_across_processes(impl):
    mesh = _cross_process_mesh(0)
    x = torch.ones(2, 3, 8, 16)
    with pytest.raises(NotImplementedError, match="item 6f"):
        SpatialSharding(mesh, data_axis=None, impl=impl).conv(
            x, torch.ones(4, 3, 3, 3))


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


# Which bands of a lat-ordered data row another process holds.
REMOTE_PATTERNS = {
    "here, there": [False, True],
    "there, here": [True, False],
    "there, here, there": [True, False, True],
    "here, there, here": [False, True, False],
    "two there, here, there": [True, True, False, True],
    "two here, two there": [False, False, True, True],
}


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

    def exchange(row, got_halo):
        assert got_halo == halo
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

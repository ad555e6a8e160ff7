"""The gnomonic cubed sphere of DLWP-CS (Weyn, Durran & Caruana 2020).

Six faces of ``N x N`` cells, equiangular in each face's two gnomonic
angles. Faces 0-3 lie on the equator, centred at longitudes 0, 90, 180
and 270 degrees; face 4 is the north polar face, face 5 the south.

Each face has a frame: its centre ``c`` (outward), ``u`` (the direction
of increasing column) and ``v`` (the direction of decreasing row), so a
cell at gnomonic angles ``(alpha, beta)`` lies on ``c + tan(alpha) u +
tan(beta) v``. Row 0 is the face's ``+v`` edge ("top"), column 0 its
``-u`` edge ("left"). On the equatorial faces ``u`` points east and ``v``
north; the north face's top edge meets face 2 and its left edge face 3;
the south face's top edge meets face 0 and its left edge face 3.

**Storage.** The cube models keep the north face with its rows reversed
("pole-aligned"): the reflection across the equator maps the south face
onto the north face stored so, cell for cell, which is DLWP-CS's
``flip_north_pole``. The two polar faces then share one conv kernel in
one call.

**Halo.** :func:`halo_sources` gives each cell of a face padded by
``pad`` its source cell: the face's own cell inside, and across an edge
the cell at the same depth from the shared edge on the neighbouring face,
in the orientation the cube's connectivity gives (the four equatorial
faces are cyclic without rotation; the polar faces meet each equatorial
face at another rotation). A corner cell of the halo, where three faces
meet, takes the source of the nearest cell of the halo across its top or
bottom edge (column clamped into the face). :func:`pad_table` turns that
into flat source indices in storage order, the table that the
``cube_pad`` kernel and its plain version read; :func:`pad_transpose`
is the table of its vector-Jacobian product.
"""

from __future__ import annotations

import functools

import numpy as np

N_FACES = 6
NORTH, SOUTH = 4, 5
EDGES = ("top", "bottom", "left", "right")


def _frames() -> np.ndarray:
    """(6, 3, 3): each face's centre, u and v as unit vectors."""
    frames = []
    for k in range(4):
        a = np.radians(90.0 * k)
        frames.append([(np.cos(a), np.sin(a), 0.0),
                       (-np.sin(a), np.cos(a), 0.0), (0.0, 0.0, 1.0)])
    frames.append([(0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (-1.0, 0.0, 0.0)])
    frames.append([(0.0, 0.0, -1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)])
    return np.round(np.asarray(frames, dtype=np.float64), 12)


FRAMES = _frames()


def cell_angles(n: int) -> np.ndarray:
    """The ``n`` cell-centre angles of one face axis, radians, ascending."""
    return -np.pi / 4 + (np.arange(n) + 0.5) * (np.pi / 2 / n)


def points(face: int, alpha, beta) -> np.ndarray:
    """Unit vectors ``(..., 3)`` of gnomonic angles ``(alpha, beta)`` on
    ``face`` (angles beyond +-pi/4 extend the face's plane)."""
    c, u, v = FRAMES[face]
    p = (c + np.tan(np.asarray(alpha))[..., None] * u
         + np.tan(np.asarray(beta))[..., None] * v)
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def cell_xyz(n: int) -> np.ndarray:
    """(6, n, n, 3) unit vectors of the cell centres; row ``i`` at angle
    ``beta = -cell_angles(n)[i]``, column ``j`` at ``alpha =
    cell_angles(n)[j]``."""
    a = cell_angles(n)
    alpha, beta = np.meshgrid(a, -a)
    return np.stack([points(f, alpha, beta) for f in range(N_FACES)])


def lat_lon(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(6, n, n) latitude and longitude (degrees, longitude in [0, 360))
    of the cell centres."""
    p = cell_xyz(n)
    lat = np.degrees(np.arcsin(np.clip(p[..., 2], -1.0, 1.0)))
    lon = np.degrees(np.arctan2(p[..., 1], p[..., 0])) % 360.0
    return lat, lon


def folded_lat_lon(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(6 n, n) latitude and longitude with the faces stacked along the
    rows, the layout of the fields the estimator and samplers carry."""
    lat, lon = lat_lon(n)
    return lat.reshape(N_FACES * n, n), lon.reshape(N_FACES * n, n)


def _edge_vector(face: int, edge: str) -> np.ndarray:
    _, u, v = FRAMES[face]
    return {"top": v, "bottom": -v, "left": -u, "right": u}[edge]


def _along_vector(face: int, edge: str) -> np.ndarray:
    """The direction of increasing position along an edge: the column
    index along the top and bottom edges, the row index along the left
    and right ones."""
    _, u, v = FRAMES[face]
    return u if edge in ("top", "bottom") else -v


def _match(vec, candidates: dict) -> str:
    for name, cand in candidates.items():
        if np.allclose(vec, cand):
            return name
    raise AssertionError(f"no match for {vec}")


@functools.lru_cache(maxsize=1)
def connectivity() -> dict:
    """``{(face, edge): (neighbour, its edge, reversed)}``: the face across
    each edge, the edge of it that is shared, and whether positions along
    the shared edge run the other way on the neighbour."""
    out = {}
    for f in range(N_FACES):
        for e in EDGES:
            d = _edge_vector(f, e)
            g = next(k for k in range(N_FACES) if np.allclose(FRAMES[k][0], d))
            ge = _match(FRAMES[f][0], {x: _edge_vector(g, x) for x in EDGES})
            rev = not np.allclose(_along_vector(f, e), _along_vector(g, ge))
            out[(f, e)] = (g, ge, rev)
    return out


def _inside(n: int, edge: str, depth, along):
    """(row, column) of the cell ``depth`` cells in from ``edge`` at
    position ``along``."""
    if edge == "top":
        return depth, along
    if edge == "bottom":
        return n - 1 - depth, along
    if edge == "left":
        return along, depth
    return along, n - 1 - depth


@functools.lru_cache(maxsize=32)
def halo_sources(n: int, pad: int) -> np.ndarray:
    """(6, n + 2 pad, n + 2 pad, 3) int: the source (face, row, column)
    of every cell of each face padded by ``pad``, in the cube's own
    orientation (the north face not flipped)."""
    if not 0 <= pad <= n:
        raise ValueError(f"pad {pad} out of range for faces of {n}")
    conn = connectivity()
    m = n + 2 * pad
    out = np.zeros((N_FACES, m, m, 3), dtype=np.int64)
    for f in range(N_FACES):
        for r in range(m):
            for c in range(m):
                i, j = r - pad, c - pad
                if 0 <= i < n and 0 <= j < n:
                    out[f, r, c] = (f, i, j)
                    continue
                if i < 0 or i >= n:
                    edge = "top" if i < 0 else "bottom"
                    depth = -1 - i if i < 0 else i - n
                    along = min(max(j, 0), n - 1)
                else:
                    edge = "left" if j < 0 else "right"
                    depth = -1 - j if j < 0 else j - n
                    along = i
                g, ge, rev = conn[(f, edge)]
                gi, gj = _inside(n, ge, depth, n - 1 - along if rev else along)
                out[f, r, c] = (g, gi, gj)
    return out


def _storage_rows(face, row, n: int):
    """A row index in storage order: the north face's rows reversed."""
    return np.where(np.asarray(face) == NORTH, n - 1 - np.asarray(row), row)


@functools.lru_cache(maxsize=32)
def pad_table(n: int, pad: int) -> np.ndarray:
    """(6, m, m) int32, m = n + 2 pad: for each padded cell in storage
    order, the flat index ``face * n * n + row * n + column`` of its
    source in storage order."""
    src = halo_sources(n, pad)
    f = src[..., 0]
    flat = f * n * n + _storage_rows(f, src[..., 1], n) * n + src[..., 2]
    # The north face's padded rows in storage order, reversed too.
    flat[NORTH] = flat[NORTH][::-1]
    return np.ascontiguousarray(flat.astype(np.int32))


@functools.lru_cache(maxsize=32)
def pad_transpose(n: int, pad: int) -> np.ndarray:
    """(K, 6 n n) int64: for each source cell in storage order, the flat
    padded positions (``face * m * m + row * m + column``) that read it,
    its own interior position first, the rest ascending; a cell read
    fewer than K times is filled with ``6 m m``, a slot that holds
    zero. The vector-Jacobian product of the pad sums the gradient over
    these K positions in this order."""
    m = n + 2 * pad
    table = pad_table(n, pad).reshape(-1).astype(np.int64)
    readers = [[] for _ in range(N_FACES * n * n)]
    for pos, s in enumerate(table):
        readers[s].append(pos)
    interior = np.zeros(N_FACES * n * n, dtype=np.int64)
    for f in range(N_FACES):
        r, c = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        interior[f * n * n + (r * n + c).ravel()] = (
            f * m * m + (r + pad) * m + (c + pad)).ravel()
    k = max(len(r) for r in readers)
    out = np.full((k, N_FACES * n * n), N_FACES * m * m, dtype=np.int64)
    for s, rs in enumerate(readers):
        rest = sorted(p for p in rs if p != interior[s])
        out[:1 + len(rest), s] = [interior[s]] + rest
    return out


__all__ = [
    "EDGES",
    "FRAMES",
    "NORTH",
    "N_FACES",
    "SOUTH",
    "cell_angles",
    "cell_xyz",
    "connectivity",
    "folded_lat_lon",
    "halo_sources",
    "lat_lon",
    "pad_table",
    "pad_transpose",
    "points",
]

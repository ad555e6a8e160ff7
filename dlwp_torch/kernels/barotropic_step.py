"""n leapfrog steps of the barotropic core in one launch (kernel
``csrc/barotropic_step.cu``).

Port of the fused Pallas step of ``dlwp_tpu.barotropic.pallas_step``
(``_make_kernel``, forms ``psi`` and ``vrt``). :func:`barotropic_step`
launches the cooperative CUDA kernel for CUDA tensors and takes the plain
PyTorch version, :func:`barotropic_step_plain`, for CPU tensors.
``barotropic_step.launches`` counts kernel launches.

Operands: the real-pair state ``vr, vi, pr, pi`` (each (M, M) float32:
real/imaginary parts of the current and previous spectral vorticity) and
the tables of :mod:`dlwp_torch.barotropic.fused_step`, with M = T+1 modes,
J latitudes and L longitudes:

- both forms: ``dinv`` (L, 2M), ``dfwd_re``/``dfwd_im`` (M, L),
  ``damp``/``dden`` (M, M);
- ``psi``: ``Gm``, ``Ha`` (M, J, M); ``A`` (M, M, J); ``invF`` (M, M);
- ``vrt``: ``P``, ``Hv``, ``Gv`` (M, J, M); ``Au``, ``Av`` (M, M, J);
  ``f_row`` (1, J).

The kernel reads the Legendre tables in the packed layout of
:func:`pack_tables`, made once per table set (``fused_step`` makes it when
it builds the tables, as a :class:`StepTables`, which a launch requires),
and the DFTs from one twiddle table:

- Row pairs. Block ``b < P = ceil(M/2)`` owns the wavenumbers
  ``m1 = b`` and ``m2 = M-1-b`` (the middle row of odd M alone). The
  tables are zero for n < m, so the pair's n >= m entries number
  ``c1 + c2 = (M - m1) + (m1 + 1) = M + 1``: entry ``k < c1`` is
  ``(m1, m1 + k)``, entry ``k >= c1`` is ``(m2, m2 + k - c1)`` (zero
  padding after the middle row). :func:`pair_entries` lists them.
- ``tab`` (P, NT, SLAB) float32, SLAB = (M+1)*J rounded up to 4 floats:
  each pair's NT slabs are one contiguous run that a block copies into
  shared memory once per launch. The synthesis tables (psi ``Gm, Ha``;
  vrt ``P, Hv, Gv``) come first, each slab ``[k, j] = T[m_k, j, n_k]``
  (j fastest); then the analysis tables (psi ``A``; vrt ``Au, Av``), each
  slab ``[j, k] = T[m_k, n_k, j]`` (k fastest).
- ``tw`` (L, 4) float32: ``cos, sin`` of 2*pi*k/L and the same over L,
  ``cos/L, -sin/L``. Each block builds from it, at launch, its matrix of
  (cos, sin) of 2*pi*m*l/L, entry k = (m*l) mod L, for both DFTs, and
  scales the forward sums by the table's 1/L.
- ``wts`` (2, M) float32: irfft's multiplicities of the real and the
  imaginary parts (:func:`dlwp_torch.spectral.transforms.dft_weights`,
  the weights of ``dinv``), which the kernel applies to each
  synthesised mode.

With ``damp``, ``dden`` and ``invF`` (M, M) or ``f_row`` (J) as they are,
these are the whole of what the kernel reads: it never reads ``dinv``,
``dfwd_*`` or the natural-layout Legendre tables.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dlwp_torch.kernels import _build
from dlwp_torch.kernels._tiling import MAX_SMEM
from dlwp_torch.spectral.transforms import dft_weights
from dlwp_torch.utils.profiling import span

FORMS = {"psi": 0, "vrt": 1}
# Shared-memory layout and partial sums of csrc/barotropic_step.cu: each
# output of the synthesis, the DFTs and the analysis is the in-order sum
# of SPLIT partial sums over consecutive chunks of its contraction
# (kSplit).
SPLIT = 6
# Stage clocks a step of the timing build (kStamps), in the order block 0
# stamps them: after the first grid sync, the five stages of phase B, the
# second grid sync, the three of phase C, the two of the next phase A.
STAMPS = 12
SYN_TABLES = {"psi": ("Gm", "Ha"), "vrt": ("P", "Hv", "Gv")}
ANA_TABLES = {"psi": ("A",), "vrt": ("Au", "Av")}
# Complex fields of phase B: synthesised (NF) and grid products (NP).
NF = {"psi": 4, "vrt": 3}
NP = {"psi": 1, "vrt": 2}


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def pair_entries(M: int, b: int):
    """``(m, n)`` of the M+1 packed entries of row pair ``b``, and
    ``c1``, the entry count of its first row; padding entries (after the
    middle row of odd M) are ``(-1, -1)``."""
    m1, m2 = b, M - 1 - b
    c1 = M - m1
    entries = [(m1, m1 + k) for k in range(c1)]
    if m2 != m1:
        entries += [(m2, m2 + k) for k in range(M - m2)]
    return entries + [(-1, -1)] * (M + 1 - len(entries)), c1


# The fields of layout(), in the order of struct Layout in the source.
LAYOUT_FIELDS = ("slab", "nlp", "tab", "twm", "wts", "st", "rowc", "frow",
                 "xs", "work", "bytes")


def layout(form: str, M: int, J: int, L: int) -> dict:
    """Offsets (floats) of the kernel's shared-memory regions, the row of
    its twiddle matrix (``nlp``) and its total bytes. This is the layout's
    only definition: the kernel takes it as it is (:func:`_layout_arg`) and
    its entry points check only what the indexing needs of it."""
    K1, nl, nf, npp = M + 1, L // 2 + 1, NF[form], NP[form]
    ns, nx = len(SYN_TABLES[form]), 4 if form == "psi" else 2
    nt = ns + len(ANA_TABLES[form])
    nq = 2 if form == "psi" else 4
    slab, nlp = _round4(K1 * J), nl | 1
    sizes = [("tab", nt * slab), ("twm", _round4(2 * M * nlp)),
             ("wts", _round4(2 * M)), ("st", 8 * M), ("rowc", _round4(6 * M)),
             ("frow", _round4(J)), ("xs", 4 * K1)]
    work_a = SPLIT * J * 2 * ns * nx
    work_b = (_round4(2 * nf * M) + _round4(SPLIT * nl * 2 * nf)
              + _round4(npp * nl * 2) + SPLIT * M * 2 * npp)
    work_c = _round4(2 * J * 2 * npp) + SPLIT * K1 * nq
    sizes.append(("work", max(work_a, work_b, work_c)))
    out, o = {"slab": slab, "nlp": nlp}, 0
    for name, n in sizes:
        out[name] = o
        o += n
    out["bytes"] = 4 * o
    return out


def pack_tables(form: str, tables) -> dict:
    """The kernel's packed tables (module docstring) from the natural ones,
    on their device and in their dtype: ``tab``, ``tw``, ``wts``. Raises if
    a Legendre table has a nonzero at n < m, which the kernel skips."""
    syn, ana = SYN_TABLES[form], ANA_TABLES[form]
    first = tables[syn[0]]
    M, J = first.shape[0], first.shape[1]
    L = tables["dinv"].shape[0]
    dev = first.device
    below = torch.tril(torch.ones(M, M, dtype=torch.bool, device=dev), -1)
    for name in syn + ana:
        t = tables[name]
        zero = below[:, None, :] if name in syn else below[:, :, None]
        if torch.any((t != 0) & zero):
            raise ValueError(f"barotropic_step {form}: table {name} is not "
                             f"zero for n < m; the kernel skips those")
    P = (M + 1) // 2
    pairs = [pair_entries(M, b)[0] for b in range(P)]
    mk = torch.tensor([[max(m, 0) for m, _ in e] for e in pairs], device=dev)
    nk = torch.tensor([[max(n, 0) for _, n in e] for e in pairs], device=dev)
    valid = torch.tensor([[m >= 0 for m, _ in e] for e in pairs],
                         device=dev)[:, :, None]
    slabs = [torch.where(valid, tables[n][mk, :, nk], 0.0).flatten(1)
             for n in syn]  # (P, (M+1)*J), j fastest
    slabs += [torch.where(valid, tables[n][mk, nk, :], 0.0)
              .transpose(1, 2).flatten(1) for n in ana]  # k fastest
    slab = _round4((M + 1) * J)
    tab = torch.zeros(P, len(slabs), slab, dtype=first.dtype, device=dev)
    for i, v in enumerate(slabs):
        tab[:, i, :v.shape[1]] = v
    k = np.arange(L, dtype=np.float64)
    ang = 2.0 * np.pi * k / L
    tw = np.stack([np.cos(ang), np.sin(ang), np.cos(ang) / L,
                   -np.sin(ang) / L], axis=1)
    wts = np.stack(dft_weights(L, M))
    return {"tab": tab,
            "tw": torch.tensor(tw, dtype=first.dtype, device=dev),
            "wts": torch.tensor(wts, dtype=first.dtype, device=dev)}


class StepTables(dict):
    """The fused step's tables, a dict as :func:`barotropic_step_plain`
    takes them, with ``packed``: their :func:`pack_tables`, made once when
    the tables are built. Treat it as read-only: ``packed`` is not
    remade."""

    def __init__(self, form: str, tables: dict):
        super().__init__(tables)
        self.packed = pack_tables(form, self)


def table_shapes(form: str, M: int, J: int, L: int) -> dict:
    shapes = {"dinv": (L, 2 * M), "dfwd_re": (M, L), "dfwd_im": (M, L),
              "damp": (M, M), "dden": (M, M)}
    syn, ana = (M, J, M), (M, M, J)
    if form == "psi":
        shapes.update(Gm=syn, Ha=syn, A=ana, invF=(M, M))
    else:
        shapes.update(P=syn, Hv=syn, Gv=syn, Au=ana, Av=ana, f_row=(1, J))
    return shapes


def _check(form, tables, state, dtypes=(torch.float32,)):
    if form not in FORMS:
        raise ValueError(f"form must be one of {sorted(FORMS)}, got {form!r}")
    M = state[0].shape[-1]
    for name, t in zip(("vr", "vi", "pr", "pi"), state):
        if (t.shape != (M, M) or t.dtype not in dtypes
                or t.dtype != state[0].dtype):
            raise ValueError(f"barotropic_step: {name} must be ({M}, {M}) "
                             f"{' or '.join(map(str, dtypes))} like vr, got "
                             f"{tuple(t.shape)} {t.dtype}")
    L = tables["dinv"].shape[0]
    J = (tables["Gm"] if form == "psi" else tables["P"]).shape[1]
    want = table_shapes(form, M, J, L)
    missing = sorted(set(want) - set(tables))
    if missing:
        raise KeyError(f"barotropic_step {form}: missing tables {missing}")
    for name, shape in want.items():
        if tuple(tables[name].shape) != shape:
            raise ValueError(f"barotropic_step {form}: table {name} has shape "
                             f"{tuple(tables[name].shape)}, expected {shape}")
    return M, J, L


def barotropic_step_plain(form, tables, vr, vi, pr, pi, step0: int,
                          n_steps: int, dt: float, r: float):
    """The fused step's arithmetic in PyTorch ops: the kernel's real-pair,
    table-composed tendency, implicit damping and leapfrog/Robert update
    (Euler where ``step0 + i == 0``). Returns ``(vr, vi, pr, pi)``. The
    state may also be float64 (with tables of its dtype), to check the
    kernel's indexing without float32 rounding."""
    _check(form, tables, (vr, vi, pr, pi), (torch.float32, torch.float64))
    t = tables

    def con(tab, x):
        # (M, J, N) x (M, N) -> (M, J) modes, or (M, N, J) x (M, J) ->
        # (M, N) spec, depending on the table's layout.
        return torch.einsum("mab,mb->ma", tab, x)

    def igrid(f_re, f_im):
        # (M, J) mode rows -> transposed grid (L, J).
        return t["dinv"] @ torch.cat([f_re, f_im], dim=0)

    if form == "psi":
        def tendency(vr, vi):
            psr, psi = vr * t["invF"], vi * t["invF"]
            Gm, Ha = t["Gm"], t["Ha"]
            dpdx = igrid(-con(Gm, psi), con(Gm, psr))
            dvdx = igrid(-con(Gm, vi), con(Gm, vr))
            dpdy = igrid(con(Ha, psr), con(Ha, psi))
            dvdy = igrid(con(Ha, vr), con(Ha, vi))
            jac = dpdx * dvdy - dpdy * dvdx  # (L, J)
            # The minus and the sign correction are composed into A.
            return (con(t["A"], t["dfwd_re"] @ jac),
                    con(t["A"], t["dfwd_im"] @ jac))
    else:
        def tendency(vr, vi):
            vrt = igrid(con(t["P"], vr), con(t["P"], vi))
            u = igrid(-con(t["Hv"], vr), -con(t["Hv"], vi))
            v = igrid(-con(t["Gv"], vi), con(t["Gv"], vr))  # i * Gv-syn
            abs_vrt = t["f_row"] + vrt  # (L, J)
            dudt = -abs_vrt * v
            dvdt = abs_vrt * u
            fur, fui = t["dfwd_re"] @ dudt, t["dfwd_im"] @ dudt
            fvr, fvi = t["dfwd_re"] @ dvdt, t["dfwd_im"] @ dvdt
            # lap * (AuPsi . u_m + i AvPsi . v_m); lap is composed in.
            return (con(t["Au"], fur) - con(t["Av"], fvi),
                    con(t["Au"], fui) + con(t["Av"], fvr))

    damp, dden = t["damp"], t["dden"]
    for i in range(n_steps):
        tr, ti = tendency(vr, vi)
        # Implicit hyperdiffusion against the lagged state.
        dzr = (tr - damp * pr) * dden
        dzi = (ti - damp * pi) * dden
        if step0 + i == 0:  # forward Euler on the global first step
            new_r, new_i = vr + dt * dzr, vi + dt * dzi
            vr, vi, pr, pi = (new_r, new_i, vr + r * (new_r - vr),
                              vi + r * (new_i - vi))
        else:  # leapfrog + Robert filter in the reference's interleave
            new_r, new_i = pr + (2.0 * dt) * dzr, pi + (2.0 * dt) * dzi
            vr, vi, pr, pi = (new_r, new_i,
                              vr + r * (pr - 2.0 * vr) + r * new_r,
                              vi + r * (pi - 2.0 * vi) + r * new_i)
    return vr, vi, pr, pi


def _lib():
    lib = _build.load("barotropic_step")
    fn = lib.dlwp_barotropic_step
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    probe = lib.dlwp_barotropic_sync_probe
    probe.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    probe.restype = ctypes.c_int
    return lib


@functools.cache  # a pure function of four ints; only passes are cached
def _layout_arg(form, M, J, L):
    """:func:`layout` as the kernel's ``lay`` array, after checking that
    it fits a block's shared memory."""
    lay = layout(form, M, J, L)
    if lay["bytes"] > MAX_SMEM:
        raise ValueError(
            f"barotropic_step {form}: T{M - 1} on {J} latitudes needs "
            f"{lay['bytes']} B of shared memory a block, more than Hopper's "
            f"{MAX_SMEM}; run step_impl='plain'")
    return (ctypes.c_int * len(LAYOUT_FIELDS))(
        *(lay[k] for k in LAYOUT_FIELDS))


def sync_probe(form, M: int, J: int, L: int, n_steps: int, blocks: int = 0,
               device="cuda"):
    """Launch the kernel's sync probe: ``n_steps`` x the two grid-wide
    barriers of a step and nothing else, on the kernel's grid for these
    sizes (or on ``blocks`` blocks) with its shared-memory request; the
    kernel's time less the probe's is the time of its phases. Returns the
    grid size. Not a launch of the kernel: ``launches`` does not count it."""
    smem = _layout_arg(form, M, J, L)[LAYOUT_FIELDS.index("bytes")]
    blocks_out = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlwp_barotropic_sync_probe(M, J, smem, n_steps, blocks,
                                             ctypes.byref(blocks_out),
                                             stream)
    if err:
        raise RuntimeError(f"barotropic sync probe failed: CUDA error {err}")
    return blocks_out.value


@span("kernel.barotropic_step")
def barotropic_step(form, tables, vr, vi, pr, pi, step0: int, n_steps: int,
                    dt: float, r: float):
    """``n_steps`` fused steps from global step ``step0``; returns the new
    ``(vr, vi, pr, pi)``. One cooperative kernel launch on CUDA tensors,
    which reads ``tables.packed``: there ``tables`` must be a
    :class:`StepTables`, packed once when it is made."""
    if vr.device.type == "cpu":
        return barotropic_step_plain(form, tables, vr, vi, pr, pi, step0,
                                     n_steps, dt, r)
    if vr.device.type != "cuda":
        raise ValueError(f"barotropic_step: unsupported device {vr.device}")
    return _launch(form, tables, (vr, vi, pr, pi), step0, n_steps, dt, r)


def _launch(form, tables, state, step0, n_steps, dt, r, clocks=None):
    """One launch on checked CUDA operands, on max(row pairs, latitudes)
    blocks. ``clocks``, an int64 (n_steps, STAMPS) tensor on the card, runs
    the timing build, which also stamps block 0's ``clock64()`` at the end
    of each stage of each step into it."""
    M, J, L = _check(form, tables, state)
    step0, n_steps = int(step0), int(n_steps)
    if step0 < 0 or n_steps < 0 or step0 + n_steps >= 2**31:
        raise ValueError(f"barotropic_step: bad step0={step0}, "
                         f"n_steps={n_steps}")
    lay = _layout_arg(form, M, J, L)
    packed = getattr(tables, "packed", None)
    if packed is None:
        raise ValueError(
            "barotropic_step: the kernel reads packed tables; pass "
            "StepTables(form, tables), made once, not a plain dict")
    extra = tables["invF" if form == "psi" else "f_row"]
    dev = state[0].device
    inputs = list(state) + [packed["tab"], packed["tw"], packed["wts"],
                            tables["damp"], tables["dden"], extra]
    for t in inputs:
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("barotropic_step: every operand must be a "
                             f"contiguous float32 tensor on {dev}")
    outs = [torch.empty_like(state[0]) for _ in range(4)]
    # Exchange buffers: synthesised mode rows (J, M, 2 NF) and forward-DFT
    # outputs (M, J, 2 NP).
    syn = torch.empty(J * M * 2 * NF[form], dtype=torch.float32, device=dev)
    fwd = torch.empty(M * J * 2 * NP[form], dtype=torch.float32, device=dev)
    # Pointer block in the order of struct Params in the source.
    ptrs = [t.data_ptr() for t in inputs[:4] + outs + [syn, fwd]
            + inputs[4:]]
    block = (ctypes.c_void_p * len(ptrs))(*ptrs)
    grid = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlwp_barotropic_step(
            FORMS[form], block, M, J, L, step0, n_steps, dt, r, lay,
            None if clocks is None else clocks.data_ptr(),
            ctypes.byref(grid), stream,
        )
    if err:
        raise RuntimeError(f"barotropic_step launch failed: CUDA error {err}")
    barotropic_step.launches += 1
    barotropic_step.grid_blocks = grid.value
    return tuple(outs)


barotropic_step.launches = 0
barotropic_step.grid_blocks = 0

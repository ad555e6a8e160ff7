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
"""

from __future__ import annotations

import ctypes

import torch

from dlwp_torch.kernels import _build

FORMS = {"psi": 0, "vrt": 1}
COMMON_TABLES = ("dinv", "dfwd_re", "dfwd_im", "damp", "dden")
# Per-form tables, in the order the kernel's parameter block takes them.
FORM_TABLES = {
    "psi": ("Gm", "Ha", "A", "invF"),
    "vrt": ("P", "Hv", "Gv", "Au", "Av", "f_row"),
}
# Scratch rows of the kernel: synthesized fields (each 2M mode rows of J)
# and forward-DFT outputs (each M rows of J).
SYN_FIELDS = {"psi": 4, "vrt": 3}
FWD_FIELDS = {"psi": 2, "vrt": 4}


def table_shapes(form: str, M: int, J: int, L: int) -> dict:
    shapes = {"dinv": (L, 2 * M), "dfwd_re": (M, L), "dfwd_im": (M, L),
              "damp": (M, M), "dden": (M, M)}
    syn, ana = (M, J, M), (M, M, J)
    if form == "psi":
        shapes.update(Gm=syn, Ha=syn, A=ana, invF=(M, M))
    else:
        shapes.update(P=syn, Hv=syn, Gv=syn, Au=ana, Av=ana, f_row=(1, J))
    return shapes


def _check(form, tables, state):
    if form not in FORMS:
        raise ValueError(f"form must be one of {sorted(FORMS)}, got {form!r}")
    M = state[0].shape[-1]
    for name, t in zip(("vr", "vi", "pr", "pi"), state):
        if t.shape != (M, M) or t.dtype != torch.float32:
            raise ValueError(f"barotropic_step: {name} must be ({M}, {M}) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
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
    (Euler where ``step0 + i == 0``). Returns ``(vr, vi, pr, pi)``."""
    _check(form, tables, (vr, vi, pr, pi))
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
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return lib


def barotropic_step(form, tables, vr, vi, pr, pi, step0: int, n_steps: int,
                    dt: float, r: float):
    """``n_steps`` fused steps from global step ``step0``; returns the new
    ``(vr, vi, pr, pi)``. One cooperative kernel launch on CUDA tensors."""
    if vr.device.type == "cpu":
        return barotropic_step_plain(form, tables, vr, vi, pr, pi, step0,
                                     n_steps, dt, r)
    if vr.device.type != "cuda":
        raise ValueError(f"barotropic_step: unsupported device {vr.device}")
    M, J, L = _check(form, tables, (vr, vi, pr, pi))
    step0, n_steps = int(step0), int(n_steps)
    if step0 < 0 or n_steps < 0 or step0 + n_steps >= 2**31:
        raise ValueError(f"barotropic_step: bad step0={step0}, "
                         f"n_steps={n_steps}")
    names = COMMON_TABLES + FORM_TABLES[form]
    inputs = [vr, vi, pr, pi] + [tables[k] for k in names]
    for t in inputs:
        if (t.device != vr.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("barotropic_step: every operand must be a "
                             f"contiguous float32 tensor on {vr.device}")
    outs = [torch.empty_like(vr) for _ in range(4)]
    syn = torch.empty(SYN_FIELDS[form] * 2 * M * J, dtype=torch.float32,
                      device=vr.device)
    fwd = torch.empty(FWD_FIELDS[form] * M * J, dtype=torch.float32,
                      device=vr.device)
    # Pointer block in the order of struct Params in the source.
    ptrs = [t.data_ptr() for t in inputs[:4] + outs + [syn, fwd]
            + inputs[4:]]
    block = (ctypes.c_void_p * len(ptrs))(*ptrs)
    blocks = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(vr.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlwp_barotropic_step(
            FORMS[form], block, M, J, L, step0, n_steps, dt, r,
            ctypes.byref(blocks), stream,
        )
    if err:
        raise RuntimeError(f"barotropic_step launch failed: CUDA error {err}")
    barotropic_step.launches += 1
    barotropic_step.grid_blocks = blocks.value
    return tuple(outs)


barotropic_step.launches = 0
barotropic_step.grid_blocks = 0

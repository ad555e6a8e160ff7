"""Whole-trajectory fused step of the barotropic cores (port of
``dlwp_tpu.barotropic.pallas_step``).

``run(state, n)`` of a single-member float32 model with
``step_impl='kernel'`` is one call of :func:`run_fused`: one launch of the
cooperative CUDA kernel ``csrc/barotropic_step.cu`` on the card (its plain
PyTorch version for CPU tensors), which runs ``n`` steps of the
Robert-filtered leapfrog with every table composed on the host:

- state is the real-pair spectral vorticity ``(M, M)`` x4 (re/im x
  cur/prev);
- per-(m, n) linear factors (i*m/a, the inverse Laplacian, the hemisphere
  sign correction, the tendency's leading minus, the Laplacian of the curl
  analysis) are composed into the tables in float64 from the model's own
  (dtype-rounded) tables, exactly as the JAX package composes them, then
  cast to float32 on the model's device;
- longitude transforms are real DFT products; the forward-Euler first step
  fires only at global step 0 (``step0`` threads the state's counter);
- the builders return a
  :class:`~dlwp_torch.kernels.barotropic_step.StepTables`: the tables with
  the kernel's packing of them (row pairs, n >= m, twiddles), made here
  once.
"""

from __future__ import annotations

import numpy as np
import torch

from dlwp_torch.barotropic.model import BarotropicState, advance_time
from dlwp_torch.kernels.barotropic_step import StepTables, barotropic_step
from dlwp_torch.spectral.transforms import dft_tables, to_numpy


def _f64(t: torch.Tensor) -> np.ndarray:
    return to_numpy(t).astype(np.float64)


def _on_device(model, tabs: dict) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                               device=model.device) for k, v in tabs.items()}


def _common_tables(model) -> dict:
    M = model.sh.truncation + 1
    dft_fwd, dft_inv = dft_tables(model.grid.nlon, M)
    damp = _f64(model.damping)  # (M, N)
    return {
        "dinv": dft_inv.T,  # (L, 2M): [re | im] columns
        "dfwd_re": dft_fwd[:, :M].T,  # (M, L)
        "dfwd_im": dft_fwd[:, M:].T,  # (M, L)
        "damp": damp,
        "dden": 1.0 / (1.0 + damp * model.dt),
    }


def build_psi_step_tables(model) -> dict:
    """Float64 host composition of the psi-form tables, as float32 tensors
    on the model's device, with their kernel packing."""
    sh = model.sh
    a = float(model.grid.radius)
    M = sh.truncation + 1
    # G feeds only d/dx, whose i*m/a factor is a per-m scale: fold it in.
    m_over_a = np.arange(M, dtype=np.float64)[:, None, None] / a
    tabs = _common_tables(model)
    tabs["Gm"] = _f64(sh.G) * m_over_a  # (M, J, N)
    tabs["Ha"] = _f64(sh.H) / a
    # Analysis composed with (-1) x optional hemisphere sign operator:
    # dzdt = sign_op(-analyze(jac)).
    A = -_f64(sh.A)  # (M, N, J)
    if getattr(model, "correct_sh", False):
        A = np.einsum("mnk,mkj->mnj", _f64(model._sign_op), A)
    tabs["A"] = A
    tabs["invF"] = _f64(model.inv_z_vrt_factor)
    return StepTables("psi", _on_device(model, tabs))


def build_vrt_step_tables(model) -> dict:
    """Float64 host composition of the vorticity-form tables, as float32
    tensors on the model's device, with their kernel packing.

    The plain tendency's psi round trip is folded away: vorticity
    synthesizes directly through P (lap * inv_lap = 1 on n > 0 and the
    n = 0 mode is restored explicitly there -- together exactly P), winds
    through H/a and G*m/a with the inverse Laplacian folded, and the curl
    analysis through lap * AuPsi / lap * AvPsi.
    """
    sh = model.sh
    a = float(model.grid.radius)
    M = sh.truncation + 1
    m_over_a = np.arange(M, dtype=np.float64)[:, None, None] / a
    inv_lap = _f64(sh.inv_laplacian_eig)[:, None, :]
    lap = _f64(sh.laplacian_eig)
    tabs = _common_tables(model)
    tabs["P"] = _f64(sh.P)  # (M, J, N)
    tabs["Hv"] = _f64(sh.H) / a * inv_lap
    tabs["Gv"] = _f64(sh.G) * m_over_a * inv_lap
    tabs["Au"] = lap[:, :, None] * _f64(sh.AuPsi)
    tabs["Av"] = lap[:, :, None] * _f64(sh.AvPsi)
    tabs["f_row"] = np.asarray(model.grid.coriolis, np.float64)[None, :]
    return StepTables("vrt", _on_device(model, tabs))


def run_fused(model, state, n_steps: int):
    """Integrate ``n_steps`` with the fused step; returns the new state."""
    parts = [x.to(torch.float32).contiguous() for x in (
        state.vrt_spec.real, state.vrt_spec.imag,
        state.vrt_spec_prev.real, state.vrt_spec_prev.imag)]
    vr, vi, pr, pi = barotropic_step(
        model._kernel_form, model._kernel_tables, *parts, state.step,
        n_steps, model.dt, model.robert_coefficient,
    )
    return BarotropicState(
        vrt_spec=torch.complex(vr, vi),
        vrt_spec_prev=torch.complex(pr, pi),
        step=state.step + n_steps,
        # n sequential additions, as the plain engine's steps make them.
        t=advance_time(state.t, model.dt, n_steps),
    )

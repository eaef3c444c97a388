"""Structured per-axis stencils (PyTorch port of the slice-1 part of
``pyapes_tpu/ops/stencil.py``).

Every implicit operator with domain-face BCs has coefficients that are
separable per axis and vary only along that axis, so the stencil is stored
as per-axis 1-D vectors ``(ap, ac, am)`` of length ``nx[axis]`` (built on
the host in float64, then cast) and applied as a sum over axes.

``apply_axis_stencil`` / ``apply_axis_stencil_dot`` and the Jacobi family
``apply_jacobi3d`` / ``apply_jacobi3d_dot`` / ``apply_jacobi3d_x2`` here
are the PLAIN PyTorch versions of the Hopper kernels in
``ops/axis_stencil.py`` and ``ops/jacobi.py``: the CPU path, and the
oracles the kernels are held against on the card. Like the JAX kernels
they compute in ``promote(dtype, float32)`` and round only the output to
the storage dtype (bf16 storage: f32 arithmetic).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pyapes_tpu_torch.backend import np_dtype


def _bshape(ndim: int, axis: int) -> list[int]:
    """Broadcast shape placing a 1-D axis vector along mesh-axis ``axis`` of
    a ``(vdim, *nx)`` array."""
    shape = [1] * ndim
    shape[1 + axis] = -1
    return shape


def apply_axis_stencil(coeffs: Sequence[tuple], x: torch.Tensor) -> torch.Tensor:
    """Apply a per-axis coefficient-vector stencil, summed over axes.

    Equivalent to the reference roll-sum ``_A_coeff_var_sum``
    (``fdc.py:171-200``). Each axis entry is either a 3-tuple
    ``(ap, ac, am)`` (offsets +1, 0, -1) or a 5-tuple
    ``(app, ap, ac, am, amm)`` (offsets +2..-2). The wrap at the ends of
    each axis is a torus (``torch.roll``).

    Args:
        coeffs: per mesh axis, 1-D coefficient tensors (len ``nx[axis]``).
        x: field values, shape ``(vdim, *nx)``.
    """
    return _axis_stencil_c(coeffs, x).to(x.dtype)


def _cdt(dtype: torch.dtype) -> torch.dtype:
    """Compute dtype of the kernels: ``promote(dtype, float32)``."""
    return torch.promote_types(dtype, torch.float32)


def _axis_stencil_c(coeffs, x: torch.Tensor) -> torch.Tensor:
    """The axis stencil in the compute dtype (unrounded)."""
    cdt = _cdt(x.dtype)
    xc = x.to(cdt)
    out = torch.zeros_like(xc)
    for j, cs in enumerate(coeffs):
        shape = _bshape(x.ndim, j)
        offsets = (-1, 0, 1) if len(cs) == 3 else (-2, -1, 0, 1, 2)
        for c, off in zip(cs, offsets):
            shifted = torch.roll(xc, off, 1 + j) if off else xc
            out = out + c.to(cdt).reshape(shape) * shifted
    return out


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-component ``sum(a * b)`` shaped ``(vdim, 1, ..., 1)``."""
    return torch.sum(a * b, dim=tuple(range(1, a.ndim)), keepdim=True)


def apply_axis_stencil_dot(coeffs, x: torch.Tensor):
    """``(A x, sum(x * A x))`` per component, for the CG alpha-dot
    (plain version of ``pallas_stencil_db.py::pallas_axis_stencil_dot``).
    The dot is taken in the compute dtype from the UNROUNDED ``A x``;
    dots come back shaped ``(vdim, 1, ..., 1)``."""
    out = _axis_stencil_c(coeffs, x)
    return out.to(x.dtype), _vdot(x.to(out.dtype), out)


def _lap3d(x: torch.Tensor, inv_dx2) -> torch.Tensor:
    """Central Laplacian ``sum_j inv_dx2[j] (x[+1] + x[-1] - 2 x)`` with
    torus wrap on every mesh axis, in ``x``'s dtype."""
    out = None
    for j, inv in enumerate(inv_dx2):
        ax = 1 + j
        t = float(inv) * (torch.roll(x, -1, ax) + torch.roll(x, 1, ax) - 2.0 * x)
        out = t if out is None else out + t
    return out


def _boundary_row_mask(shape, mask_axes, dtype, device) -> torch.Tensor:
    """``(1, *shape)`` 0/1 field that zeroes the global first and last rows
    of each axis in ``mask_axes`` (the kernels' in-register mask)."""
    m = torch.ones((1, *shape), dtype=dtype, device=device)
    for j in mask_axes:
        idx = [slice(None)] * (1 + len(shape))
        idx[1 + j] = [0, shape[j] - 1]
        m[tuple(idx)] = 0.0
    return m


def _jacobi_c(x, b, inv_dx2, alpha, beta, mask_axes):
    """``alpha x + beta mask (b - A x)`` in the compute dtype."""
    cdt = _cdt(b.dtype)
    xc, bc = x.to(cdt), b.to(cdt)
    m = _boundary_row_mask(b.shape[1:], mask_axes, cdt, b.device)
    return float(alpha) * xc + float(beta) * (m * (bc - _lap3d(xc, inv_dx2))), bc


def apply_jacobi3d(x, b, inv_dx2, alpha, beta, mask_axes) -> torch.Tensor:
    """Fused damped-Jacobi step / masked residual for the 3-D central
    Laplacian (plain version of ``pallas_stencil.py::pallas_jacobi3d``):
    ``alpha x + beta mask (b - A x)``. ``alpha=1, beta=omega/diag`` is a
    smooth, ``alpha=0, beta=1`` the masked residual. ``x``, ``b``:
    ``(vdim, nx, ny, nz)``."""
    out, _ = _jacobi_c(x, b, inv_dx2, alpha, beta, mask_axes)
    return out.to(b.dtype)


def apply_jacobi3d_dot(x, b, inv_dx2, alpha, beta, mask_axes):
    """``apply_jacobi3d`` plus ``sum(b * out)`` per component from the
    unrounded ``out`` (plain version of
    ``pallas_stencil_db.py::pallas_jacobi3d_dot_db``)."""
    out, bc = _jacobi_c(x, b, inv_dx2, alpha, beta, mask_axes)
    return out.to(b.dtype), _vdot(bc, out)


def apply_jacobi3d_x2(x, b, inv_dx2, beta, mask_axes, from_zero=False, emit_dot=False):
    """Two damped-Jacobi sweeps (plain version of
    ``pallas_stencil_v3.py::pallas_jacobi3d_x2``):

        y = x + beta mask (b - A x)      (from_zero: y = beta mask b)
        z = y + beta mask (b - A y)

    ``y`` stays in the compute dtype between the sweeps; only ``z`` is
    rounded. ``x`` is not read (may be None) when ``from_zero``. Returns
    ``z``, or ``(z, sum(b * z))`` with ``emit_dot``."""
    cdt = _cdt(b.dtype)
    bc = b.to(cdt)
    m = _boundary_row_mask(b.shape[1:], mask_axes, cdt, b.device)
    if from_zero:
        y = float(beta) * (m * bc)
    else:
        xc = x.to(cdt)
        y = xc + float(beta) * (m * (bc - _lap3d(xc, inv_dx2)))
    z = y + float(beta) * (m * (bc - _lap3d(y, inv_dx2)))
    if emit_dot:
        return z.to(b.dtype), _vdot(bc, z)
    return z.to(b.dtype)


def _aligned_bcs(bcs, axis: int):
    return [bc for bc in (bcs or []) if bc.bc_face_dim == axis]


def _eliminate_boundary_node(ap, ac, am, lower: bool) -> None:
    """Neumann/Symmetry coefficient surgery via boundary-node elimination.

    The boundary value obeys ``v_b = 4/3 p - 1/3 pp + 2/3 V dx`` (the BC
    application, ``variables/bcs.py``); substituting it into the row
    adjacent to the face moves its coefficient ``c0`` onto the neighbors:
    ``+4/3 c0`` to the center, ``-1/3 c0`` to the far neighbor (the constant
    part goes to the RHS via ``adjust_rhs``). Mutates the numpy vectors in
    place.
    """
    if lower:
        c0 = am[1]
        ac[1] += (4.0 / 3.0) * c0
        ap[1] += -(1.0 / 3.0) * c0
        am[1] = 0.0
    else:
        c0 = ap[-2]
        ac[-2] += (4.0 / 3.0) * c0
        am[-2] += -(1.0 / 3.0) * c0
        ap[-2] = 0.0


def laplacian_axis_coeffs(mesh, bcs, dtype=None) -> tuple:
    """Per-axis Laplacian coefficients with BC surgery, as host numpy.

    Built in float64 with the JAX package's code (``laplacian_axis_coeffs``
    there), then cast to ``dtype`` (default: the mesh dtype), so both
    packages hold bit-equal vectors.
    """
    dtype = np_dtype(dtype or mesh.dtype.float)
    out = []
    rz = mesh.coord_sys == "rz"
    for j in range(mesh.dim):
        n = mesh.nx[j]
        dxj = float(mesh.dx_np[j])
        ap = np.ones(n)
        ac = -2.0 * np.ones(n)
        am = np.ones(n)
        if rz and j == 0:
            r = np.asarray(mesh._x_np[0])
            with np.errstate(divide="ignore", invalid="ignore"):
                scale = np.nan_to_num(dxj / (2.0 * r), nan=0.0, posinf=0.0, neginf=0.0)
            ap = 1.0 + scale
            am = 1.0 - scale
        for bc in _aligned_bcs(bcs, j):
            if bc.bc_type in ("neumann", "symmetry"):
                _eliminate_boundary_node(ap, ac, am, bc.bc_n_dir < 0)
        scale2 = dxj * dxj
        out.append(
            (
                np.asarray(ap / scale2, dtype=dtype),
                np.asarray(ac / scale2, dtype=dtype),
                np.asarray(am / scale2, dtype=dtype),
            )
        )
    return tuple(out)


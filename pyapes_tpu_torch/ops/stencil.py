"""Structured stencils (PyTorch port of the per-axis coefficient stencils
and the variable-Γ operator of ``pyapes_tpu/ops/stencil.py``).

Every implicit operator with domain-face BCs has coefficients that are
separable per axis and vary only along that axis, so the stencil is stored
as per-axis 1-D vectors ``(ap, ac, am)`` of length ``nx[axis]`` (built on
the host in float64, then cast) and applied as a sum over axes.

``apply_axis_stencil`` (3- and 5-point axes) / ``apply_axis_stencil_dot``,
the Jacobi family ``apply_jacobi3d`` / ``apply_jacobi3d_dot`` /
``apply_jacobi3d_x2``, the variable-Γ pair ``apply_diff_field`` /
``apply_diff_jacobi`` and the per-point advection pair
``apply_div_field`` / ``apply_conv_field`` here are the PLAIN PyTorch
versions of the Hopper kernels in ``ops/axis_stencil.py``,
``ops/jacobi.py``, ``ops/diff_field.py`` and ``ops/advect.py``: the CPU
path, and the oracles the kernels are held against on the card. Like
the JAX kernels they compute in ``promote(dtype, float32)`` and round only
the output to the storage dtype (bf16 storage: f32 arithmetic).
"""
from __future__ import annotations

import math
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


def apply_axis_stencil_ext(coeffs, x_ext: torch.Tensor, ext) -> torch.Tensor:
    """The 3-point axis stencil of a block extended by one ghost row on
    each side of every axis with ``ext[a] == 1`` (plain version of
    ``pallas_stencil_v3.py::pallas_axis_stencil_ext``).

    Args:
        coeffs: per mesh axis ``(ap, ac, am)``, sized to the UNEXTENDED
            extents.
        x_ext: ``(vdim, n_0 + 2 ext_0, ...)``.
        ext: per-axis 0/1 extension flags.

    On an extended axis the neighbours are static slices of the extended
    extent (no wrap); on an unextended axis the torus roll. The output has
    the unextended shape; the ghost corners are never read. Computes in
    ``promote(dtype, f32)`` and rounds once, summing in
    ``apply_axis_stencil``'s order."""
    cdt = _cdt(x_ext.dtype)
    xe = x_ext.to(cdt)
    n = [s - 2 * e for s, e in zip(x_ext.shape[1:], ext)]
    inner = [slice(None)] + [slice(e, e + m) for e, m in zip(ext, n)]
    xc = xe[tuple(inner)]
    out = torch.zeros_like(xc)
    for j, (ap, ac, am) in enumerate(coeffs):
        shape = _bshape(x_ext.ndim, j)
        if ext[j]:
            xp = xe[tuple(inner[:1 + j] + [slice(2, n[j] + 2)] + inner[2 + j:])]
            xm = xe[tuple(inner[:1 + j] + [slice(0, n[j])] + inner[2 + j:])]
        else:
            xp, xm = torch.roll(xc, -1, 1 + j), torch.roll(xc, 1, 1 + j)
        out = out + ap.to(cdt).reshape(shape) * xp
        out = out + ac.to(cdt).reshape(shape) * xc
        out = out + am.to(cdt).reshape(shape) * xm
    return out.to(x_ext.dtype)


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


def div_surgery_info(bcs, mesh_dim: int) -> tuple:
    """Per-axis ``(lower_kind, upper_kind)`` BC descriptors of the
    variable-Γ operator: "neumann" for Neumann/Symmetry faces, "periodic",
    else "none" (the JAX package's ``div_surgery_info``)."""
    info = [["none", "none"] for _ in range(mesh_dim)]
    for bc in bcs or []:
        side = 0 if bc.bc_n_dir < 0 else 1
        if bc.bc_type in ("neumann", "symmetry"):
            info[bc.bc_face_dim][side] = "neumann"
        elif bc.bc_type == "periodic":
            info[bc.bc_face_dim][side] = "periodic"
    return tuple(tuple(p) for p in info)


def estimate_stencil_bytes(nx: tuple[int, ...], dtype_bytes: int = 4) -> int:
    """Bytes moved by one fused stencil apply (read x + write out)."""
    n = math.prod(nx)
    return 2 * n * dtype_bytes


def _face(a: torch.Tensor, b: torch.Tensor, avg: str) -> torch.Tensor:
    """Face value of Γ between two nodes: arithmetic ``(a + b) / 2`` or
    harmonic ``2 a b / (a + b)`` (the flux-continuous rule)."""
    if avg == "harmonic":
        return (2.0 * a) * b / (a + b)
    return 0.5 * (a + b)


def _gamma_faces(gamma: torch.Tensor, nd: int, avg: str):
    """Per mesh axis ``(gp, gm)``: the face values of Γ toward the +1 and
    -1 neighbours (torus wrap), shaped ``(1, *nx)``. ``gamma``: isotropic
    ``(*nx)``, or stacked ``(nd, *nx)`` with axis j diffusing with
    ``gamma[j]``."""
    aniso = gamma.ndim == nd + 1 and gamma.shape[0] == nd
    for j in range(nd):
        gj = gamma[j] if aniso else gamma
        g = gj[None] if gj.ndim == nd else gj
        yield (_face(g, torch.roll(g, -1, 1 + j), avg),
               _face(g, torch.roll(g, 1, 1 + j), avg))


def _row(ax: int, i: int) -> tuple:
    return (slice(None),) * ax + (i,)


def _diff_field_c(x, gamma, inv_dx2, surgery, avg) -> torch.Tensor:
    """``∂_j (Γ ∂_j x)`` in the compute dtype (unrounded), flux form."""
    cdt = _cdt(x.dtype)
    xc = x.to(cdt)
    out = torch.zeros_like(xc)
    for j, (gp, gm) in enumerate(_gamma_faces(gamma.to(cdt), x.ndim - 1, avg)):
        ax = 1 + j
        inv = float(inv_dx2[j])
        term = gp * (torch.roll(xc, -1, ax) - xc) - gm * (xc - torch.roll(xc, 1, ax))
        out = out + term * inv
        lo, up = surgery[j]
        if lo == "neumann":
            c0 = gm[_row(ax, 1)] * inv
            out[_row(ax, 1)] += c0 * (
                (4.0 / 3.0) * xc[_row(ax, 1)] - (1.0 / 3.0) * xc[_row(ax, 2)] - xc[_row(ax, 0)]
            )
        if up == "neumann":
            c0 = gp[_row(ax, -2)] * inv
            out[_row(ax, -2)] += c0 * (
                (4.0 / 3.0) * xc[_row(ax, -2)] - (1.0 / 3.0) * xc[_row(ax, -3)] - xc[_row(ax, -1)]
            )
    return out


def apply_diff_field(x, gamma, inv_dx2, surgery, avg: str = "arithmetic") -> torch.Tensor:
    """Conservative variable-coefficient Laplacian ``∂_j (Γ_j ∂_j x)``
    (port of the JAX package's ``apply_diff_field``; plain version of
    ``pallas_advect.py::pallas_diff_field``):

        out_i = Σ_j [ Γ_{i+½} (x_{i+1} - x_i) - Γ_{i-½} (x_i - x_{i-1}) ] / dx_j²

    ``x``: ``(vdim, *nx)``; ``gamma``: isotropic ``(*nx)`` or stacked
    ``(dim, *nx)`` (diagonal-tensor diffusivity); ``avg``: "arithmetic" or
    "harmonic" face values. ``surgery``: per-axis ``(lower, upper)`` kinds;
    "neumann" eliminates the boundary node from the adjacent row through
    ``x_b = 4/3 x_1 - 1/3 x_2``, ADDITIVELY with the pre-surgery face
    coefficient (``c0 = Γ_{1-½}/dx²``, resp. ``Γ_{n-2+½}/dx²``). Neighbours
    wrap (torus). Computes in ``promote(dtype, f32)``, rounds once."""
    return _diff_field_c(x, gamma, inv_dx2, surgery, avg).to(x.dtype)


def diff_diag(gamma, inv_dx2, surgery, avg: str = "arithmetic") -> torch.Tensor:
    """True per-point diagonal ``(1, *nx)`` of the variable-Γ operator, in
    the compute dtype, built as the kernels build it in registers: per axis
    ``cc = -(cp + cm)`` from the face coefficients, plus ``4/3 c0`` on a
    Neumann-surgered row."""
    nd = len(inv_dx2)
    cdt = _cdt(gamma.dtype)
    acc = None
    for j, (gp, gm) in enumerate(_gamma_faces(gamma.to(cdt), nd, avg)):
        ax = 1 + j
        inv = float(inv_dx2[j])
        cp, cm = gp * inv, gm * inv
        d = -(cp + cm)
        lo, up = surgery[j]
        if lo == "neumann":
            d[_row(ax, 1)] += (4.0 / 3.0) * cm[_row(ax, 1)]
        if up == "neumann":
            d[_row(ax, -2)] += (4.0 / 3.0) * cp[_row(ax, -2)]
        acc = d if acc is None else acc + d
    return acc


def apply_diff_jacobi(x, b, g, inv_dx2, surgery, avg="arithmetic", omega=2.0 / 3.0,
                      mask_axes=(0, 1, 2), mode="smooth") -> torch.Tensor:
    """One variable-Γ V-cycle pass (plain version of
    ``pallas_advect.py::pallas_diff_jacobi``), ``A = A(Γ)`` of
    ``apply_diff_field`` and ``diag`` of ``diff_diag``:

        smooth:  x + omega mask (b - A x) / diag
        smooth0: omega mask b / diag          (x not read; may be None)
        resid:   mask (b - A x)

    ``mask`` zeroes the global first and last rows of each axis in
    ``mask_axes``. ``x``, ``b``: ``(vdim, *nx)``; ``g`` as ``gamma`` of
    ``apply_diff_field``. Computes in ``promote(dtype, f32)``, rounds once."""
    cdt = _cdt(b.dtype)
    r = b.to(cdt)
    if mode != "smooth0":
        r = r - _diff_field_c(x, g, inv_dx2, surgery, avg)
    keep = _boundary_row_mask(b.shape[1:], mask_axes, cdt, b.device) != 0
    r = torch.where(keep, r, 0.0)
    if mode == "resid":
        return r.to(b.dtype)
    step = float(omega) * r / diff_diag(g, inv_dx2, surgery, avg)
    if mode == "smooth":
        step = x.to(cdt) + step
    return step.to(b.dtype)


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


def grad_axis_coeffs(mesh, bcs, gamma: float = 1.0, dtype=None) -> tuple:
    """Per-axis central-gradient coefficients ``(gamma, 0, -gamma) / (2
    dx)`` for a spatially constant ``gamma``, with the boundary-node
    elimination on Neumann/Symmetry faces, as host numpy (the JAX
    package's ``grad_axis_coeffs``, built in float64 by the same code, then
    cast). Periodic faces take no surgery: the explicit apply runs the
    exact stencil on the reduced torus, the implicit solve rebuilds the
    vectors there."""
    dtype = np_dtype(dtype or mesh.dtype.float)
    out = []
    for j in range(mesh.dim):
        n = mesh.nx[j]
        dxj = float(mesh.dx_np[j])
        ap = gamma * np.ones(n)
        ac = np.zeros(n)
        am = -gamma * np.ones(n)
        for bc in _aligned_bcs(bcs, j):
            if bc.bc_type in ("neumann", "symmetry"):
                _eliminate_boundary_node(ap, ac, am, bc.bc_n_dir < 0)
        scale = 2.0 * dxj
        out.append(tuple(np.asarray(c / scale, dtype=dtype) for c in (ap, ac, am)))
    return tuple(out)


def div_axis_coeffs(mesh, bcs, gamma: float, limiter: str = "none", dtype=None) -> tuple:
    """Per-axis divergence coefficients for a spatially constant advection
    ``gamma``, with BC surgery, as host numpy (the JAX package's
    ``div_axis_coeffs``, built in float64 by the same code, then cast).

    * ``"none"`` (central): ``(gamma, 0, -gamma) / (2 dx)``;
    * ``"upwind"``: ``gamma_max (phi_i - phi_{i-1}) / dx + gamma_min
      (phi_{i+1} - phi_i) / dx``;
    * ``"quick"``: the 3rd-order upwind-biased QUICK 5-vectors ``(app, ap,
      ac, am, amm)``, first-order upwind on the boundary-adjacent rows.

    ``div_axis_coeffs(mesh, None, 1.0, "none")`` are the geometry-only base
    vectors of the per-point advection operators (``apply_div_field``)."""
    dtype = np_dtype(dtype or mesh.dtype.float)
    rz = mesh.coord_sys == "rz"
    out = []
    g_min = min(gamma, 0.0)
    g_max = max(gamma, 0.0)
    for j in range(mesh.dim):
        n = mesh.nx[j]
        dxj = float(mesh.dx_np[j])
        if limiter == "none":
            ap = gamma * np.ones(n)
            ac = np.zeros(n)
            am = -gamma * np.ones(n)
            if rz and j == 0:
                r = np.asarray(mesh._x_np[0])
                with np.errstate(divide="ignore", invalid="ignore"):
                    ac = gamma * np.nan_to_num(2.0 * dxj / r, nan=0.0, posinf=0.0, neginf=0.0)
        elif limiter in ("upwind", "quick"):
            up_ap = 2.0 * g_min * np.ones(n)
            up_ac = 2.0 * (g_max - g_min) * np.ones(n)
            up_am = -2.0 * g_max * np.ones(n)
            rz_term = np.zeros(n)
            if rz and j == 0:
                r = np.asarray(mesh._x_np[0])
                with np.errstate(divide="ignore", invalid="ignore"):
                    rz_term = 2.0 * gamma * np.nan_to_num(
                        dxj / r, nan=0.0, posinf=0.0, neginf=0.0
                    )
            if limiter == "upwind":
                ap, ac, am = up_ap, up_ac + rz_term, up_am
                app = amm = None
            else:
                # QUICK face interpolation, advective form (pre 1/(2 dx))
                app = (-g_min / 4.0) * np.ones(n)
                ap = ((3 * g_max + 7 * g_min) / 4.0) * np.ones(n)
                ac = (3 * (g_max - g_min) / 4.0) * np.ones(n) + rz_term
                am = (-(7 * g_max + 3 * g_min) / 4.0) * np.ones(n)
                amm = (g_max / 4.0) * np.ones(n)
                for idx in (1, -2):  # the +-2 reach would cross the face
                    ap[idx] = up_ap[idx]
                    ac[idx] = up_ac[idx] + rz_term[idx]
                    am[idx] = up_am[idx]
                    app[idx] = 0.0
                    amm[idx] = 0.0
        else:
            raise NotImplementedError(f"div: limiter {limiter} not supported")
        for bc in _aligned_bcs(bcs, j):
            if bc.bc_type in ("neumann", "symmetry"):
                _eliminate_boundary_node(ap, ac, am, bc.bc_n_dir < 0)
        scale = 2.0 * dxj
        vecs = (app, ap, ac, am, amm) if limiter == "quick" else (ap, ac, am)
        out.append(tuple(np.asarray(c / scale, dtype=dtype) for c in vecs))
    return tuple(out)


def _adv_axis_coeffs(a, base, j: int, limiter: str, form: str, kinds):
    """Per-point coefficients ``(cpp, cp, cc, cm, cmm)`` (``cpp``/``cmm``
    None unless QUICK) of mesh axis ``j`` for the advecting component ``a``
    (``(*nx)``, compute dtype) and the axis' geometry-only base vectors
    ``(ap0, ac0, am0)``, with the boundary-row surgery of ``kinds`` =
    ``(lower, upper)`` applied IN SEQUENCE (the upper edit reads what the
    lower one left: on a 3-node axis both edit row 1), as the JAX
    package's ``apply_div_field``/``apply_conv_field``."""
    shape = [1] * a.ndim
    shape[j] = -1
    apb, acb, amb = (c.to(a.dtype).reshape(shape) for c in base)
    inv_2dx = apb.abs()  # |ap0| == 1/(2 dx_j)
    cpp = cmm = None
    if limiter == "none":
        if form == "conservative":  # flux form: neighbour advection
            cp = apb * torch.roll(a, -1, j)
            cm = amb * torch.roll(a, 1, j)
        else:  # advective form a d(phi)/dx
            cp = apb * a
            cm = amb * a
        cc = acb * a
    elif limiter in ("upwind", "quick"):
        g_min = torch.clamp(a, max=0.0)
        g_max = torch.clamp(a, min=0.0)
        up_cp = 2.0 * inv_2dx * g_min
        up_cc = 2.0 * inv_2dx * (g_max - g_min) + acb * a
        up_cm = -2.0 * inv_2dx * g_max
        if limiter == "upwind":
            cp, cc, cm = up_cp, up_cc, up_cm
        else:
            s = 2.0 * inv_2dx  # == 1/dx
            cpp = -s * g_min / 8.0
            cp = s * (3 * g_max + 7 * g_min) / 8.0
            cc = s * 3 * (g_max - g_min) / 8.0 + acb * a
            cm = -s * (7 * g_max + 3 * g_min) / 8.0
            cmm = s * g_max / 8.0
            for idx in (1, -2):  # first-order upwind next to the faces
                sel = _row(j, idx)
                cp[sel] = up_cp[sel]
                cc[sel] = up_cc[sel]
                cm[sel] = up_cm[sel]
                cpp[sel] = 0.0
                cmm[sel] = 0.0
    else:
        raise NotImplementedError(f"advection: limiter {limiter} not supported")
    lo, up = kinds  # cp, cc, cm are fresh full-grid tensors: edited in place
    if lo == "neumann":  # boundary-node elimination (_eliminate_boundary_node)
        sel = _row(j, 1)
        c0 = cm[sel].clone()
        cc[sel] += (4.0 / 3.0) * c0
        cp[sel] += -(1.0 / 3.0) * c0
        cm[sel] = 0.0
    elif lo == "periodic":
        cm[_row(j, 1)] = 0.0
    if up == "neumann":
        sel = _row(j, -2)
        c0 = cp[sel].clone()
        cc[sel] += (4.0 / 3.0) * c0
        cm[sel] += -(1.0 / 3.0) * c0
        cp[sel] = 0.0
    elif up == "periodic":
        cp[_row(j, -2)] = 0.0
    return cpp, cp, cc, cm, cmm


def _adv_term(x, coeffs, ax: int):
    """``sum_o c_o x[+o]`` along array axis ``ax`` (torus wrap)."""
    cpp, cp, cc, cm, cmm = coeffs
    term = cp * torch.roll(x, -1, ax) + cc * x + cm * torch.roll(x, 1, ax)
    if cpp is not None:
        term = term + cpp * torch.roll(x, -2, ax) + cmm * torch.roll(x, 2, ax)
    return term


def apply_div_field(x, adv, base_coeffs, limiter: str, surgery, form: str = "conservative"):
    """Divergence with a spatially varying advecting field (plain version
    of ``pallas_advect.py::pallas_advect_pair``; the JAX package's
    ``apply_div_field``): a scalar field summed over ``(axis, component)``
    diagonal pairs, shape ``(1, *nx)``.

    Axis j advects component ``j`` of ``x`` with ``adv[j]`` (a scalar
    target: ``x[0]`` with ``adv[0]`` on every axis; a one-component
    ``adv`` drives every axis).

    Args:
        x: target ``(vdim, *nx)``.
        adv: advecting values ``(vdim | 1, *nx)``.
        base_coeffs: per axis the geometry-only ``(ap0, ac0, am0)`` 1-D
            tensors (``div_axis_coeffs(mesh, None, 1.0, "none")``).
        limiter: "none" (central), "upwind" or "quick".
        surgery: per-axis ``(lower, upper)`` kinds "none" / "neumann" /
            "periodic" (``div_surgery_info``).
        form: "conservative" (flux form, neighbour advection) or
            "advective" (central only).

    Computes in ``promote(dtype, f32)`` and rounds once."""
    cdt = _cdt(x.dtype)
    xc, ac = x.to(cdt), adv.to(cdt)
    vdim = x.shape[0]
    out = torch.zeros_like(xc[:1])
    for j in range(x.ndim - 1):
        i = j if vdim > 1 else 0
        a = ac[i] if ac.shape[0] > 1 else ac[0]
        coeffs = _adv_axis_coeffs(a, base_coeffs[j], j, limiter, form, surgery[j])
        out = out + _adv_term(xc[i], coeffs, j)[None]
    return out.to(x.dtype)


def apply_conv_field(x, adv, base_coeffs, limiter: str, surgery):
    """Convection ``u_j d(phi_i)/dx_j`` per component (plain version of
    ``pallas_advect.py::pallas_conv_component``; the JAX package's
    ``apply_conv_field``): advective form, axis j advected by ``adv[j]``.

    ``x``: ``(vdim, *nx)``; ``adv``: ``(dim, *nx)``; other arguments as
    ``apply_div_field``. Computes in ``promote(dtype, f32)``, rounds once."""
    nd = x.ndim - 1
    if adv.shape[0] != nd:
        raise ValueError("conv: adv needs one component per mesh axis")
    cdt = _cdt(x.dtype)
    xc, ac = x.to(cdt), adv.to(cdt)
    out = torch.zeros_like(xc)
    for j in range(nd):
        coeffs = _adv_axis_coeffs(ac[j], base_coeffs[j], j, limiter, "advective", surgery[j])
        out = out + _adv_term(xc, tuple(None if c is None else c[None] for c in coeffs), 1 + j)
    return out.to(x.dtype)


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


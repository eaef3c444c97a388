"""Solver assembly (port of ``pyapes_tpu/solver/linalg.py::_build_solver``
and ``_make_mg_spec``): the active-set mask, the operator over the stencil
kernels, the eigen-factors and refinement loop of fastdiag, and the
CG/BiCGSTAB loops with the multigrid preconditioner, the symmetrizing row
scale of Neumann faces and the fused operator/preconditioner dots."""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from pyapes_tpu_torch.backend import np_dtype
from pyapes_tpu_torch.mesh.tools import interior_mask_device
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, axis_stencil_dot
from pyapes_tpu_torch.solver.fastdiag import FastDiag, axis_matrix_np
from pyapes_tpu_torch.solver.linalg.bicgstab_loop import build_bicgstab
from pyapes_tpu_torch.solver.linalg.cg_loop import build_cg
from pyapes_tpu_torch.solver.linalg.fastdiag_loop import build_fastdiag
from pyapes_tpu_torch.solver.multigrid import MGSpec
from pyapes_tpu_torch.variables.bcs import apply_bcs_fn

# Multigrid hierarchies by their key (shape, knobs, dtypes, device): their
# device constants (masks, transfer matrices) are built once and reused by
# every solve of the same structure. Bounded LRU.
_MG_CACHE: OrderedDict = OrderedDict()
_MG_CACHE_MAX = 8


class _MaskSpec:
    """Recipe for the 0/1 active-set mask, materialized on the device per
    solve call."""

    def __init__(self, nx, slicer, dtype, device):
        self.nx, self.slicer, self.dtype, self.device = nx, slicer, dtype, device

    def build(self) -> torch.Tensor:
        return interior_mask_device(self.nx, self.slicer, self.dtype, self.device)


def _make_Aop(term_descs, stencil_fn=axis_stencil) -> Callable:
    """``Aop(x, tparams) = sum_terms sign * param * stencil(x)``. Every
    3-point axis term goes through ``stencil_fn`` — the Hopper kernel on a
    CUDA tensor (for every grid shape; the JAX package's "auto" gate used
    its kernel only for TPU-aligned shapes)."""

    def Aop(x, tparams):
        out = None
        for (kind, _, sign, has_param), tp in zip(term_descs, tparams):
            r = stencil_fn(tp["axis"], x)
            scale = sign * (tp["param"] if has_param else 1.0)
            if scale != 1.0:
                r = r * scale
            out = r if out is None else out + r
        return out

    return Aop


def _neumann_row_scale_vecs(mesh, bcs) -> tuple[list[np.ndarray], bool]:
    """Per-axis row-scale vectors for the Neumann/Symmetry elimination
    asymmetry (``A[1,2]=2/3`` vs ``A[2,1]=1``; 3/2 on the surgered rows).
    Returns ``(dvs, any_scale)``."""
    dvs = []
    any_scale = False
    for j in range(mesh.dim):
        n = mesh.nx[j]
        dv = np.ones(n)
        for bc in bcs:
            if bc.bc_type in ("neumann", "symmetry") and bc.bc_face_dim == j:
                dv[1 if bc.bc_n_dir < 0 else n - 2] = 1.5
                any_scale = True
        dvs.append(dv)
    return dvs, any_scale


def _null_shift_field(vecs, device):
    """Deferred ``(1, *nx)`` row-scale field, composed per call from the
    per-axis vectors."""
    vecs = tuple(torch.as_tensor(v, device=device) for v in vecs)

    def build():
        ns = None
        for v in vecs:
            ns = v[None] if ns is None else ns * v[None]
        return ns

    return build


def fd_separable(term_descs, tparams) -> bool:
    """Whether the equation is exactly one constant-coefficient 3-point
    axis term — the Kronecker sum the direct solve inverts."""
    return (
        len(term_descs) == 1
        and term_descs[0][0] == "axis"
        and all(len(cs) == 3 for cs in tparams[0]["axis_np"])
    )


def fastdiag_factors(tparams, slicer, dtype, device) -> FastDiag:
    """Eigen-factors of the (separable) active-set operator: host ``eigh``
    of one n x n matrix per axis, uploaded to ``device``."""
    mats = [
        axis_matrix_np(*cs, active=sl, periodic=False)
        for cs, sl in zip(tparams[0]["axis_np"], slicer)
    ]
    return FastDiag(mats, dtype=dtype, device=device)


def _axis_fields(vecs, dim: int, dtype):
    """Per-axis vectors as host arrays broadcastable along their axis."""
    ndt = np_dtype(dtype)
    return tuple(
        np.asarray(dv, dtype=ndt).reshape(tuple(-1 if k == j else 1 for k in range(dim)))
        for j, dv in enumerate(vecs)
    )


def make_mg_spec(config, x0, bcs, mesh) -> MGSpec:
    """The multigrid spec of ``precond: "mg"`` (``_make_mg_spec`` of the JAX
    package): per-axis face kinds for the level surgery, the cycle dtype and
    the ``mg_opts`` knobs; cached by its key."""
    mg_opts = dict(config.get("mg_opts") or {})
    cycle_dtype = mg_opts.pop("dtype", None)
    fk = [["dirichlet", "dirichlet"] for _ in range(mesh.dim)]
    for bc in bcs or []:
        if bc.bc_type in ("neumann", "symmetry"):
            fk[bc.bc_face_dim][0 if bc.bc_n_dir < 0 else 1] = "neumann"
    spec = MGSpec(
        x0.shape[1:],
        [float(l) for l in np.asarray(mesh._lx_np)],
        dtype=x0.dtype,
        cycle_dtype=cycle_dtype,
        face_kinds=tuple(tuple(p) for p in fk),
        device=x0.device,
        **mg_opts,
    )
    if spec.key not in _MG_CACHE:
        _MG_CACHE[spec.key] = spec
        while len(_MG_CACHE) > _MG_CACHE_MAX:
            _MG_CACHE.popitem(last=False)
    _MG_CACHE.move_to_end(spec.key)
    return _MG_CACHE[spec.key]


def _make_Aop_dot(term_descs, tparams, dim: int):
    """The CG operator fused with its alpha-dot, when the equation is one
    3-point axis term with a scalar coefficient on a 3-D grid (the JAX
    conditions without its TPU shape gate): ``tparams -> (d -> (A d,
    sum(d * A d)))`` with the term's ``sign * param`` folded into the
    coefficient vectors once per solve. None otherwise."""
    if not (dim == 3 and fd_separable(term_descs, tparams)):
        return None
    _, _, sign0, has_p0 = term_descs[0]

    def Aop_dot(tp):
        scale = sign0 * (tp[0]["param"] if has_p0 else 1.0)
        coeffs = tuple(tuple((c * scale).contiguous() for c in cs) for cs in tp[0]["axis"])
        return lambda d: axis_stencil_dot(coeffs, d)

    return Aop_dot


def build_solver(config, mesh, x0, grid, term_descs, tparams, bcs, method, criterion,
                 tol, max_it, slicer, fd=None):
    """Assemble the solve of ``method`` (``fd``: the fastdiag factors);
    returns ``fn(x0, rhs, tparams, bc_vals) -> (x, itr, tol, hist)`` and
    the row-scale fields ``sym_vecs`` the RHS must be multiplied by (None:
    no scaling). Everything here is host work, redone per call, so nothing
    cached can hold a stale BC or mask (the MG hierarchy is keyed by its
    structure)."""
    M = _MaskSpec(tuple(mesh.nx), slicer, x0.dtype, x0.device)
    apply_bcs = apply_bcs_fn(bcs, grid)
    Aop = _make_Aop(term_descs)
    project_mean = config.get("nullspace") == "mean"
    dvs, any_scale = _neumann_row_scale_vecs(mesh, bcs)

    if method == "fastdiag":
        _, _, sign0, has_p0 = term_descs[0]

        def scalars(tp):
            # (c_ax, c_dt) of the eigen-symbol from this call's term params
            return sign0 * (tp[0]["param"] if has_p0 else 1.0), 0.0

        null_shift = None
        if project_mean and any_scale:
            null_shift = _null_shift_field(_axis_fields(dvs, mesh.dim, x0.dtype), x0.device)
        fn = build_fastdiag(
            Aop, apply_bcs, M, tol, max_it, fd,
            act_sel=(slice(None),) + slicer,
            scalars=scalars,
            project_mean=project_mean,
            null_shift=null_shift,
        )
        return fn, None

    mg = make_mg_spec(config, x0, bcs, mesh) if config.get("precond") == "mg" else None
    fmg_init = mg.fmg_initializer() if mg is not None and mg.fmg_init else None
    precond = mg.preconditioner() if mg is not None else None
    if method == "bicgstab":
        fn = build_bicgstab(Aop, apply_bcs, M, tol, max_it, criterion, precond, fmg_init=fmg_init)
        return fn, None

    # Symmetrization row scaling (CG + Neumann/Symmetry faces): the
    # boundary-node elimination makes the surgered rows nonsymmetric
    # (A[1,2] = 2/3 vs A[2,1] = 1); scaling them by 3/2 per axis (D =
    # kron_j D_j) restores exact symmetry, so CG on D A x = D b is rigorous
    # and matches the symmetrized V-cycle.
    sym_vecs = None
    Aop_dot = None
    if any_scale:
        sym_vecs = tuple(
            torch.as_tensor(v, device=x0.device)[None]
            for v in _axis_fields(dvs, mesh.dim, x0.dtype)
        )
        raw_Aop = Aop

        def Aop(v, tp):
            out = raw_Aop(v, tp)
            for d in sym_vecs:
                out = out * d
            return out
    else:
        Aop_dot = _make_Aop_dot(term_descs, tparams, mesh.dim)
    # fused dot(r, z): the interior mask is exactly the MG mask here
    precond_dot = mg.preconditioner_dot() if mg is not None and mg.can_fuse_rz() else None
    null_shift = None
    if sym_vecs is not None:
        null_shift = _null_shift_field(_axis_fields(dvs, mesh.dim, x0.dtype), x0.device)
    fn = build_cg(
        Aop, apply_bcs, M, tol, max_it, criterion, precond,
        project_mean=project_mean, Aop_dot=Aop_dot, fmg_init=fmg_init,
        precond_dot=precond_dot, null_shift=null_shift,
    )
    return fn, sym_vecs
